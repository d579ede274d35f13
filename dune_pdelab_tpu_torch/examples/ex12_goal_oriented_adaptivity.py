"""Goal-oriented adaptivity on the L-shaped domain by the DWR method
(examples/12_goal_oriented_adaptivity.py).

Estimates the error in a goal functional, J(u) = a weighted average of u
over a small region away from the re-entrant corner, by solving the
adjoint (dual) problem in the enriched P2 space and weighting per-element
residuals with the dual solution (adaptivity/dwr.py; the dual operator is
torch.func.vjp of the residual, no hand-derived adjoint PDE). Doerfler
marking and newest-vertex bisection then refine where the goal is
sensitive. The exact solution u = r^(2/3) sin(2 theta/3) is known, so the
table prints the true goal error beside the estimate; the effectivity
index tends to 1.

No reference analog: PDELab's adaptivity is energy-norm only
(dune/pdelab/adaptivity/adaptivity.hh).

Run: python -m dune_pdelab_tpu_torch.examples.ex12_goal_oriented_adaptivity [--device cpu]
"""
from __future__ import annotations

import numpy as np
import torch

import dune_pdelab_tpu_torch as pt
from dune_pdelab_tpu_torch.adaptivity import (
    dwr_indicators, error_fraction, mark_elements, space_transfer,
)
from dune_pdelab_tpu_torch.adaptivity.local import adapt_local_simplex
from dune_pdelab_tpu_torch.examples._common import finish, on_device, parser
from dune_pdelab_tpu_torch.examples.ex06_adaptive_lshape import Corner, l_shape, u_exact
from dune_pdelab_tpu_torch.ops import ConvectionDiffusionFEM
from dune_pdelab_tpu_torch.ops.l2 import L2

CENTER, RADIUS = np.array([-0.5, 0.5]), 0.3


def chi(x):
    """The goal's weight: a smooth bump of radius RADIUS at CENTER."""
    c = torch.as_tensor(CENTER, dtype=x.dtype, device=x.device)
    d2 = torch.sum((x - c) ** 2, dim=-1)
    s = torch.clamp(1.0 - d2 / RADIUS**2, min=0.0)
    return s * s


def j_exact():
    """J(u) = int chi u by the midpoint rule on a 600^2 grid of the bump's
    box (float64, host)."""
    n = 600
    h = 2 * RADIUS / n
    gx = CENTER[0] - RADIUS + h * (np.arange(n) + 0.5)
    gy = CENTER[1] - RADIUS + h * (np.arange(n) + 0.5)
    X, Y = np.meshgrid(gx, gy, indexing="ij")
    pts = torch.as_tensor(np.stack([X.ravel(), Y.ravel()], axis=1))
    return float(torch.sum(chi(pts) * u_exact(pts)) * h * h)


def solve(space, dtype, dev):
    cgm = pt.constraints(True, space, device=dev)
    go = pt.GridOperator(space, ConvectionDiffusionFEM(Corner()), constraints=cgm)
    x0 = pt.interpolate_dirichlet(u_exact, space, cgm, space.zero(dtype, dev))
    x = pt.StationaryLinearProblemSolver(go, pt.SEQ_CG_Jacobi(), reduction=1e-12,
                                         verbose=0).apply(x0)
    return go, x


def run(start=8, levels=9, fraction=0.7, check=True, device=None, dtype=torch.float64,
        out_dir=None):
    """`levels` DWR cycles from the `start`^2 L-shape; returns J(u) and, per
    level, N, the true goal error, the estimate and the effectivity. With
    `check` (the reference's depth) the last effectivity lies in [0.9, 1.1]."""
    J = j_exact()
    print(f"goal J(u) = int chi u = {J:.8f} (bump at {CENTER}, r={RADIUS})")
    print(f"{'level':>5} {'ndofs':>7} {'true err':>11} {'DWR est':>11} {'effectivity':>11}")
    out = {"J": J, "ndofs": [], "true_errors": [], "estimates": [], "effectivities": []}
    with on_device(device, dtype) as dev:
        V = pt.FunctionSpace(l_shape(start), pt.PkFEM(1, 2))
        for level in range(levels):
            go, x = solve(V, dtype, dev)
            Vr = pt.FunctionSpace(V.mesh, pt.PkFEM(2, 2))
            gor = pt.GridOperator(Vr, ConvectionDiffusionFEM(Corner()),
                                  constraints=pt.constraints(True, Vr, device=dev))
            q = pt.GridOperator(Vr, L2(scale=chi)).jacobian_apply(
                Vr.zero(dtype, dev), torch.ones(Vr.ndofs, dtype=dtype, device=dev))

            def goal(u):
                return torch.dot(q, u)

            err = J - float(goal(space_transfer(V, Vr)(x)))
            eta, est = dwr_indicators(go, gor, x, goal, tol=1e-12)
            est = float(est)
            print(f"{level:>5} {V.ndofs:>7} {abs(err):>11.3e} {abs(est):>11.3e} "
                  f"{est / err:>11.3f}")
            for k, v in (("ndofs", V.ndofs), ("true_errors", err), ("estimates", est),
                         ("effectivities", est / err)):
                out[k].append(v)
            eta = eta.cpu().numpy() if isinstance(eta, torch.Tensor) else np.asarray(eta)
            marks, _ = mark_elements(eta, error_fraction(eta, fraction))
            V, x = adapt_local_simplex(V, x, marks)
    if check and not 0.9 <= out["effectivities"][-1] <= 1.1:
        raise AssertionError(f"ex12: effectivity {out['effectivities'][-1]} at the last level")
    print("estimate tracks the true goal error; refinement follows the goal's sensitivity")
    return out


def main(argv=None):
    ap = parser(__doc__, "ex12_goal_oriented_adaptivity")
    ap.add_argument("--levels", type=int, default=9)
    a = ap.parse_args(argv)
    return finish(run(levels=a.levels, device=a.device, out_dir=a.out))


if __name__ == "__main__":
    main()
