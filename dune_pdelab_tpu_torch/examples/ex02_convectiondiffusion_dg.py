"""Convection-diffusion with SIPG DG + BiCGStab and block Jacobi, and the
convergence order over two meshes (examples/02_convectiondiffusion_dg.py;
dune-pdelab-tutorials tutorial02, testconvectiondiffusiondg.cc).

The DG Jacobian applies go through the compiled block stencil (the
element-major kernel on the card in 2D); `run` reports the solve path and
the kernel launches of each solve.

Run: python -m dune_pdelab_tpu_torch.examples.ex02_convectiondiffusion_dg [--device cpu]
"""
from __future__ import annotations

import math

import numpy as np
import torch

import dune_pdelab_tpu_torch as pt
from dune_pdelab_tpu_torch.examples import _kernels
from dune_pdelab_tpu_torch.examples._common import finish, on_device, parser
from dune_pdelab_tpu_torch.ops import ConvectionDiffusionProblem
from dune_pdelab_tpu_torch.ops.convectiondiffusiondg import ConvectionDiffusionDG
from dune_pdelab_tpu_torch.space.functions import l2_difference

PI = math.pi


class Problem(ConvectionDiffusionProblem):
    """Convection-diffusion with constant wind, manufactured solution."""

    def exact(self, p):
        return torch.sin(PI * p[:, 0]) * torch.sin(PI * p[:, 1])

    def b(self, x):
        return torch.broadcast_to(torch.tensor([1.0, 0.5], dtype=x.dtype, device=x.device),
                                  x.shape)

    def f(self, x):
        s = torch.sin(PI * x[..., 0]) * torch.sin(PI * x[..., 1])
        dx = PI * torch.cos(PI * x[..., 0]) * torch.sin(PI * x[..., 1])
        dy = PI * torch.sin(PI * x[..., 0]) * torch.cos(PI * x[..., 1])
        return 2 * PI**2 * s + 1.0 * dx + 0.5 * dy

    def g(self, x):
        return torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)


def run(sizes=(16, 32), reduction=1e-10, device=None, dtype=torch.float32, out_dir=None):
    """SIPG Q1 solves at each size; returns ndofs, iterations and L2 errors
    per size, the order between the last two, the solve path and the
    kernel launches per solve."""
    prob = Problem()
    out = {"sizes": list(sizes), "ndofs": [], "iterations": [], "l2_errors": [],
           "launches": [], "solve_path": None}
    with on_device(device, dtype) as dev:
        for n in sizes:
            mesh = pt.StructuredMesh([0, 0], [1, 1], (n, n))
            V = pt.FunctionSpace(mesh, pt.QkDGFEM(1, 2))
            go = pt.GridOperator(V, ConvectionDiffusionDG(prob, penalty=2.0))
            ls = pt.LinearSolverBackend(solver="bicgstab", precond="block_jacobi",
                                        maxiter=2000)
            slp = pt.StationaryLinearProblemSolver(go, ls, reduction=reduction, verbose=0)
            before = _kernels.snapshot()
            x = slp.apply(V.zero(dtype, dev))
            out["launches"].append(_kernels.since(before))
            out["solve_path"] = ls.report(go).splitlines()[0]
            err = float(l2_difference(V, x, prob.exact))
            out["ndofs"].append(V.ndofs)
            out["iterations"].append(slp.result.linear_solver_iterations)
            out["l2_errors"].append(err)
            print(f"n={n}: ndofs={V.ndofs}, L2 error={err:.3e} "
                  f"({slp.result.linear_solver_iterations} BiCGStab iterations)")
    e = out["l2_errors"]
    out["order"] = float(np.log2(e[-2] / e[-1])) if len(e) > 1 else None
    if out["order"] is not None:
        print(f"convergence order: {out['order']:.2f} (expect ~2)")
    print(f"{out['solve_path']}; kernel launches per solve {out['launches']}")
    return out


def main(argv=None):
    ap = parser(__doc__, "ex02_convectiondiffusion_dg")
    ap.add_argument("--sizes", type=int, nargs="+", default=[16, 32])
    a = ap.parse_args(argv)
    return finish(run(tuple(a.sizes), device=a.device, out_dir=a.out))


if __name__ == "__main__":
    main()
