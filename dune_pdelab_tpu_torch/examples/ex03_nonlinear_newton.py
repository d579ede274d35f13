"""A nonlinear reaction-diffusion problem solved with inexact Newton
(examples/03_nonlinear_newton.py; dune-pdelab-tutorials tutorial01,
dune/pdelab/solver/newton.hh).

    -lap u + u^3 = f,  u = g on the boundary.

The Jacobian never appears in user code: jacobian_apply is torch.func.jvp
of the residual kernel. fp64: a 1e-10 defect reduction lies below fp32's
floor on this problem.

Run: python -m dune_pdelab_tpu_torch.examples.ex03_nonlinear_newton [--device cpu]
"""
from __future__ import annotations

import math

import torch

import dune_pdelab_tpu_torch as pt
from dune_pdelab_tpu_torch.examples._common import finish, on_device, parser
from dune_pdelab_tpu_torch.ops.base import LocalOperator
from dune_pdelab_tpu_torch.space.functions import l2_difference

PI = math.pi


def u_exact(p):
    return torch.sin(PI * p[:, 0]) * torch.sin(PI * p[:, 1]) + 0.5


class NonlinearPoisson(LocalOperator):
    def alpha_volume(self, ctx, u):
        tab = ctx.tab
        gu = self.gradient_at_qp(tab, u)
        uq = self.value_at_qp(tab, u)
        return (self.accumulate_gradient(tab, ctx.factor, gu)
                + self.accumulate_value(tab, ctx.factor, uq ** 3))

    def lambda_volume(self, ctx):
        s = torch.sin(PI * ctx.x[..., 0]) * torch.sin(PI * ctx.x[..., 1])
        ue = s + 0.5
        f = 2 * PI ** 2 * s + ue ** 3
        return self.accumulate_value(ctx.tab, ctx.factor, -f)


def run(cells=32, reduction=1e-10, device=None, dtype=torch.float64, out_dir=None):
    """Newton from the Dirichlet-interpolated zero; returns the Newton
    iterations, convergence and the L2 error."""
    with on_device(device, dtype) as dev:
        mesh = pt.StructuredMesh([0, 0], [1, 1], (cells, cells))
        V = pt.FunctionSpace(mesh, pt.QkFEM(1, 2))
        cg = pt.constraints(True, V, device=dev)
        go = pt.GridOperator(V, NonlinearPoisson(), constraints=cg)
        x0 = pt.interpolate_dirichlet(u_exact, V, cg, V.zero(dtype, dev))
        ls = pt.SEQ_CG_Jacobi()
        newton = pt.NewtonMethod(go, ls, reduction=reduction, verbose=0,
                                 reassemble_threshold=0.0)
        x = newton.apply(x0)
        err = float(l2_difference(V, x, u_exact))
        print(f"Newton: {newton.result.iterations} iterations, "
              f"converged={newton.result.converged}")
        print(f"L2 error: {err:.3e}")
    if not newton.result.converged:
        raise AssertionError("ex03: Newton did not converge")
    return {"ndofs": V.ndofs, "newton_iterations": newton.result.iterations,
            "converged": bool(newton.result.converged), "l2_error": err,
            "solve_report": ls.report()}


def main(argv=None):
    ap = parser(__doc__, "ex03_nonlinear_newton")
    ap.add_argument("--cells", type=int, default=32)
    a = ap.parse_args(argv)
    return finish(run(a.cells, device=a.device, out_dir=a.out))


if __name__ == "__main__":
    main()
