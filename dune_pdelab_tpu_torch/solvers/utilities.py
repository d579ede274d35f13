"""Solver-infrastructure utilities: statistics, operator preconditioning,
interface checking.

PyTorch port of dune_pdelab_tpu/solvers/utilities.py. Reference analogs:
  * SolverStatistics (dune/pdelab/backend/istl/matrixfree/
    solverstatistics.hh:39): min/max/avg Krylov iteration bookkeeping;
  * GridOperatorPreconditioner (dune/pdelab/backend/istl/matrixfree/
    gridoperatorpreconditioner.hh:19): a (cheaper) grid operator as the
    preconditioner inside an outer Krylov solver;
  * the LOP interface checker (dune/pdelab/backend/istl/matrixfree/
    checklopinterface.hh): a local operator provides well-formed kernels
    before it reaches the assembler.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class SolverStatistics:
    """Accumulates per-solve iteration counts (SolverStatistics analog)."""

    counts: list = field(default_factory=list)

    def append(self, iterations: int):
        self.counts.append(int(iterations))

    def observe(self, backend):
        """Pull everything recorded by a LinearSolverBackend."""
        for s in backend.stats_history:
            self.append(int(s.iterations))
        return self

    @property
    def size(self):
        return len(self.counts)

    def min(self):
        return min(self.counts) if self.counts else 0

    def max(self):
        return max(self.counts) if self.counts else 0

    def avg(self):
        return float(np.mean(self.counts)) if self.counts else 0.0

    def total(self):
        return sum(self.counts)

    def __repr__(self):
        return (f"SolverStatistics(n={self.size}, min={self.min()}, "
                f"max={self.max()}, avg={self.avg():.1f})")


class GridOperatorPreconditioner:
    """A (simplified) grid operator as preconditioner: M r approximates
    J_prec^{-1} r by `sweeps` damped Jacobi iterations on the
    preconditioner operator."""

    def __init__(self, prec_go, sweeps: int = 2, omega: float = 0.67):
        self.prec_go = prec_go
        self.sweeps = sweeps
        self.omega = omega

    def __call__(self, go, x_lin, time):
        pgo = self.prec_go
        d = pgo.jacobian_diagonal(x_lin, time)

        def M(r):
            z = self.omega * r / d
            for _ in range(self.sweeps - 1):
                z = z + self.omega * (r - pgo.jacobian_apply(x_lin, z, time)) / d
            return z

        return M


def check_lop_interface(lop, raise_on_error: bool = True):
    """Static sanity checks of a local operator (checklopinterface analog):
    at least one kernel method, `set_time` keeps the kernels, sane
    quadrature attributes. Returns the list of problems."""
    problems = []
    kernels = [m for m in ("alpha_volume", "lambda_volume", "alpha_boundary",
                           "lambda_boundary", "alpha_skeleton")
               if hasattr(lop, m)]
    if not kernels:
        problems.append("local operator defines no kernel methods")
    try:
        lt = lop.set_time(0.0)
        for m in kernels:
            if not hasattr(lt, m):
                problems.append(f"set_time() result lost kernel {m}")
    except Exception as e:  # noqa: BLE001 - reported, not swallowed
        problems.append(f"set_time failed: {e}")
    qf = getattr(lop, "quadrature_factor", None)
    if not isinstance(qf, (int, float)) or qf < 0:
        problems.append(f"bad quadrature_factor {qf!r}")
    if not isinstance(getattr(lop, "is_linear", False), bool):
        problems.append("is_linear must be a bool")
    if problems and raise_on_error:
        raise TypeError("; ".join(problems))
    return problems


def dense_jacobian(go, x, time=0.0):
    """Assembled dense Jacobian (the 'simple backend' analog, reference:
    dune/pdelab/backend/simple/matrix.hh), for small systems, direct
    solves and debugging."""
    return go.jacobian(x, time).to_dense()
