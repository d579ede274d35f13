"""Mixed-precision iterative refinement: fp64-accurate solves from fp32
inner solves.

PyTorch port of dune_pdelab_tpu/solvers/refinement.py. Classical defect
correction (Wilkinson; Moler 1967) needs high precision only for the
residual and the solution update:

    x_0 = 0
    repeat:  r_k = b - A x_k          (fp64: one matvec + axpy)
             solve A z = r_k          (fp32, modest tolerance)
             x_{k+1} = x_k + z        (fp64 axpy)

Each sweep multiplies the defect by O(eps_32 * kappa(A)). The inner residual
is normalized before the downcast so its exponent range never under- or
overflows fp32. The outer loop runs on the host (a handful of trips). With
a StencilOperator as the outer operator, the fp64 matvec on a CUDA tensor
is the stencil27 kernel's fp64 instantiation.

Reference analog: PDELab/ISTL solve in double
(dune/pdelab/backend/istl/seqistlsolverbackend.hh).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class RefinementStats:
    outer_iterations: int
    inner_iterations: int
    converged: bool
    defect0: float
    defect: float
    history: tuple


def refine_solve(A_hi, inner_solve, b, *, tol=1e-12, atol=0.0, max_outer=20,
                 inner_dtype=torch.float32, x0=None):
    """Solve A x = b to `tol` relative defect in b's (high) precision.

    A_hi : callable(x) -> A @ x in b's dtype (a StencilOperator qualifies).
    inner_solve : callable(r_lo) -> z_lo or (z_lo, stats) in `inner_dtype`
        (e.g. LatticeGMG.make_solver(tol=1e-4), a solve_host closure, or a
        single V-cycle). Must keep the residual convention of A_hi (zero
        constrained rows).
    b : right-hand side in high precision (residual convention).
    tol, atol : relative/absolute 2-norm defect targets (ISTL semantics).

    Returns (x, RefinementStats).
    """
    x = torch.zeros_like(b) if x0 is None else x0.to(b.dtype)
    bnorm = float(torch.linalg.norm(b))
    target = max(tol * bnorm, atol)
    hist = []
    inner_total = 0
    sweeps = 0
    defect = bnorm
    for sweeps in range(max_outer + 1):
        r = b - A_hi(x)
        defect = float(torch.linalg.norm(r))
        hist.append(defect)
        if defect <= target or defect == 0.0 or sweeps == max_outer:
            break
        # normalize -> downcast -> inner solve -> upcast -> rescale
        z = inner_solve((r / defect).to(inner_dtype))
        if isinstance(z, tuple):
            z, istats = z
            inner_total += int(getattr(istats, "iterations", 0))
        x = x + defect * z.to(b.dtype)
    return x, RefinementStats(
        outer_iterations=sweeps,
        inner_iterations=inner_total,
        converged=defect <= target,
        defect0=bnorm, defect=defect, history=tuple(hist))


class MixedPrecisionStationarySolver:
    """StationaryLinearProblemSolver-shaped driver that solves the
    linearized system by fp32-inner / fp64-outer refinement.

    `gmg` is a LatticeGMG on go's space; its fine StencilOperator serves
    both precisions (fp64 numpy taps; the apply follows the input dtype).

    reference: dune/pdelab/stationary/linearproblem.hh:182-278 (assemble
    residual, solve correction, subtract) with the Krylov solve replaced by
    refine_solve.
    """

    def __init__(self, go, gmg, *, reduction=1e-12, inner_tol=1e-5,
                 inner_maxiter=100, max_outer=20, verbose=0):
        self.go = go
        self._st = gmg.stencils[0]
        self._inner = gmg.make_solver(tol=inner_tol, maxiter=inner_maxiter)
        self.reduction = reduction
        self.max_outer = max_outer
        self.verbose = verbose
        self.stats = None

    def apply(self, x0):
        b = -self.go.residual(x0, 0.0)
        z, stats = refine_solve(self._st, self._inner, b,
                                tol=self.reduction, max_outer=self.max_outer)
        self.stats = stats
        if self.verbose:
            print(f"MixedPrecisionStationarySolver: outer {stats.outer_iterations}, "
                  f"inner {stats.inner_iterations}, defect {stats.defect:.4e}, "
                  f"converged={stats.converged}")
        return x0 + z
