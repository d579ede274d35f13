"""Lid-driven-cavity Stokes with Taylor-Hood Q2/Q1 and block-preconditioned
GMRES (examples/05_stokes_taylor_hood.py; dune-pdelab-tutorials tutorial07,
taylorhoodnavierstokes.hh).

Run: python -m dune_pdelab_tpu_torch.examples.ex05_stokes_taylor_hood [--device cpu]
"""
from __future__ import annotations

import torch

import dune_pdelab_tpu_torch as pt
from dune_pdelab_tpu_torch.examples._common import finish, on_device, parser
from dune_pdelab_tpu_torch.ops.stokes import NavierStokesParameters, TaylorHoodNavierStokes
from dune_pdelab_tpu_torch.solvers.stokes import (
    StokesBlockJacobi, stokes_constraints, taylor_hood_space,
)


def lid_u(p):
    """Regularized lid u = (4x(1-x), 0) on y = 1 (smooth corners), no slip
    elsewhere."""
    ux = torch.where(torch.isclose(p[:, 1], torch.ones_like(p[:, 1])),
                     4.0 * p[:, 0] * (1.0 - p[:, 0]), torch.zeros_like(p[:, 0]))
    return torch.stack([ux, torch.zeros_like(ux)], dim=-1)


def run(cells=16, reduction=1e-7, device=None, dtype=torch.float32, out_dir=None):
    """GMRES(100) with StokesBlockJacobi; returns ndofs (u, p), iterations,
    max|u| and mean p."""
    with on_device(device, dtype) as dev:
        mesh = pt.StructuredMesh([0, 0], [1, 1], (cells, cells))
        W = taylor_hood_space(mesh, degree=2)          # Q2 velocity, Q1 pressure
        prm = NavierStokesParameters(mu=1.0, rho=0.0)  # the Stokes limit
        cg = stokes_constraints(W, bctype=True, pin_pressure=True, device=dev)
        go = pt.GridOperator(W, TaylorHoodNavierStokes(prm), constraints=cg)
        x0 = W.interpolate((lid_u, lambda p: torch.zeros(p.shape[0], dtype=p.dtype)),
                           dtype=dtype, device=dev)
        x0 = torch.where(cg.mask, x0, torch.zeros_like(x0))
        ls = pt.LinearSolverBackend(solver="gmres", precond=StokesBlockJacobi(W),
                                    restart=100, maxiter=20000)
        slp = pt.StationaryLinearProblemSolver(go, ls, reduction=reduction, verbose=0)
        x = slp.apply(x0)
        u, p = W.restrict(x, 0), W.restrict(x, 1)
        umax, pmean = float(torch.max(torch.abs(u))), float(torch.mean(p))
        print(f"ndofs={W.ndofs} (u: {u.shape[0]}, p: {p.shape[0]}), "
              f"{slp.result.linear_solver_iterations} GMRES iterations")
        print(f"max |u| = {umax:.4f}, mean p = {pmean:.2e}")
    return {"ndofs": W.ndofs, "ndofs_u": int(u.shape[0]), "ndofs_p": int(p.shape[0]),
            "iterations": slp.result.linear_solver_iterations,
            "converged": bool(slp.result.converged), "max_u": umax, "mean_p": pmean,
            "solve_report": ls.report(go)}


def main(argv=None):
    ap = parser(__doc__, "ex05_stokes_taylor_hood")
    ap.add_argument("--cells", type=int, default=16)
    a = ap.parse_args(argv)
    return finish(run(a.cells, device=a.device, out_dir=a.out))


if __name__ == "__main__":
    main()
