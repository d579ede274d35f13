"""PDE-constrained optimization: recover a diffusion coefficient field from
observations of the solution by L-BFGS with adjoint gradients through the
PDE solve (examples/11_pde_constrained_optimization.py;
solvers/differentiable.py).

Beyond the C++ reference: PDELab has no sensitivity machinery. Here
autograd differentiates through assembly and the Krylov solve by the
implicit function theorem: each gradient costs one extra (adjoint) linear
solve, whatever the number of parameters.

Problem:  -div(a(x; theta) grad u) = 1 on (0,1)^2, u = 0 on the boundary,
with a bilinear coefficient a = theta0 + theta1 x + theta2 y + theta3 x y.
Synthetic observations come from theta_true; L-BFGS (torch.optim.LBFGS
with a strong-Wolfe line search) recovers theta from a cold start.

Run: python -m dune_pdelab_tpu_torch.examples.ex11_pde_constrained_optimization [--device cpu]
"""
from __future__ import annotations

import numpy as np
import torch

import dune_pdelab_tpu_torch as pt
from dune_pdelab_tpu_torch.examples._common import finish, on_device, parser
from dune_pdelab_tpu_torch.ops import ConvectionDiffusionFEM, ConvectionDiffusionProblem
from dune_pdelab_tpu_torch.solvers import differentiable_stationary_solve

THETA_TRUE = (1.0, 0.8, -0.4, 0.5)
THETA_START = (0.5, 0.0, 0.0, 0.0)


def factory(theta):
    class P(ConvectionDiffusionProblem):
        def A(self, x):
            a = (theta[0] + theta[1] * x[..., 0] + theta[2] * x[..., 1]
                 + theta[3] * x[..., 0] * x[..., 1])
            return a[..., None, None] * torch.eye(x.shape[-1], dtype=x.dtype, device=x.device)

        def f(self, x):
            return torch.ones(x.shape[:-1], dtype=x.dtype, device=x.device)
    return ConvectionDiffusionFEM(P())


def run(cells=16, iterations=60, device=None, dtype=torch.float64, out_dir=None):
    """L-BFGS from THETA_START for `iterations` iterations; returns the
    misfit and gradient at the start, the final misfit, its reduction, the
    recovered theta and its largest error."""
    with on_device(device, dtype) as dev:
        mesh = pt.StructuredMesh([0, 0], [1, 1], (cells, cells))
        V = pt.FunctionSpace(mesh, pt.QkFEM(1, 2))
        cons = pt.constraints(True, V, device=dev)
        solve = differentiable_stationary_solve(V, factory, constraints=cons, solver="cg",
                                                tol=1e-13)
        theta_true = torch.tensor(THETA_TRUE, dtype=dtype, device=dev)
        with torch.no_grad():
            x_obs = solve(theta_true)
        print(f"observations: {V.ndofs} DOFs from theta_true {np.asarray(THETA_TRUE)}")

        def misfit(t):
            return torch.sum((solve(t) - x_obs) ** 2)

        theta = torch.tensor(THETA_START, dtype=dtype, device=dev, requires_grad=True)
        v0 = misfit(theta)
        (g0,) = torch.autograd.grad(v0, theta)
        v0 = float(v0.detach())
        opt = torch.optim.LBFGS([theta], lr=1.0, max_iter=iterations, history_size=10,
                                tolerance_grad=0.0, tolerance_change=0.0,
                                line_search_fn="strong_wolfe")
        log = []

        def closure():
            opt.zero_grad()
            v = misfit(theta)
            v.backward()
            log.append(float(v))
            return v

        opt.step(closure)
        state = opt.state[opt._params[0]]
        with torch.no_grad():
            v = float(misfit(theta))
        th = theta.detach().cpu().numpy()
        err = float(np.max(np.abs(th - np.asarray(THETA_TRUE))))
        print(f"start misfit {v0:.3e}, gradient {g0.cpu().numpy()}")
        print(f"final misfit {v:.3e}  (reduction {v0 / max(v, 1e-300):.1e}x) after "
              f"{state['n_iter']} L-BFGS iterations, {state['func_evals']} evaluations")
        print(f"recovered theta {np.round(th, 4)} vs true {np.asarray(THETA_TRUE)}")
        if not v < 1e-6 * v0:
            raise AssertionError(f"ex11: misfit {v} against {v0} at the start")
        print(f"misfit down {v0 / max(v, 1e-300):.1e}x; max parameter error {err:.2e}")
    return {"ndofs": V.ndofs, "misfit0": v0, "grad0": g0.cpu().numpy(), "misfit": v,
            "theta": th, "theta_error": err, "iterations": int(state["n_iter"]),
            "evaluations": int(state["func_evals"])}


def main(argv=None):
    ap = parser(__doc__, "ex11_pde_constrained_optimization")
    ap.add_argument("--cells", type=int, default=16)
    a = ap.parse_args(argv)
    return finish(run(a.cells, device=a.device, out_dir=a.out))


if __name__ == "__main__":
    main()
