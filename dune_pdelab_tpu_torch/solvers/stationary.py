"""One-shot linear PDE driver.

PyTorch port of dune_pdelab_tpu/solvers/stationary.py (reference:
dune/pdelab/stationary/linearproblem.hh:60, apply :182-278): assemble the
residual at the current iterate, solve the correction system in residual
form J z = r, update x -= z. Dirichlet data must already be interpolated
into x.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from dune_pdelab_tpu_torch.utils.common import Timer


@dataclass
class StationaryResult:
    """PDESolverResult analog (reference: dune/pdelab/backend/solver.hh)."""
    assembler_time: float = 0.0
    linear_solver_time: float = 0.0
    linear_solver_iterations: int = 0
    first_defect: float = 0.0
    defect: float = 0.0
    converged: bool = False


class StationaryLinearProblemSolver:
    def __init__(self, gridoperator, linear_solver, reduction=1e-10,
                 min_defect=1e-99, verbose=1):
        self.go = gridoperator
        self.ls = linear_solver
        self.reduction = reduction
        self.min_defect = min_defect
        self.verbose = verbose
        self.result = StationaryResult()

    def apply(self, x, time=0.0):
        """Returns the solved DOF vector (does not mutate x)."""
        t = Timer()
        r = self.go.residual(x, time)
        defect0 = float(torch.linalg.norm(r))
        self.result.assembler_time = t.elapsed()
        self.result.first_defect = defect0
        if defect0 <= self.min_defect:
            self.result.converged = True
            self.result.defect = defect0
            return x
        t.reset()
        z, stats = self.ls.solve(self.go, x, r, self.reduction, time)
        self.result.linear_solver_iterations = int(stats.iterations)
        self.result.defect = float(stats.defect)
        self.result.converged = bool(stats.converged)
        self.result.linear_solver_time = t.elapsed()
        if self.verbose:
            print(f"StationaryLinearProblemSolver: defect {defect0:.4e}, "
                  f"{self.result.linear_solver_iterations} linear iterations, "
                  f"converged={self.result.converged}")
        return x - z
