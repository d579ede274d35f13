"""Krylov solvers as host-driven PyTorch loops.

PyTorch port of the `cg` of dune_pdelab_tpu/linalg/krylov.py (reference:
dune/pdelab/backend/istl/seqistlsolverbackend.hh:112-1060). A solver is a
function

    solve(A, b, x0, M, ...) -> (x, SolverStats)

where A and M are closures (z -> A z, r -> M r). The reference runs the
loop inside one lax.while_loop; here Python drives it and reads the defect
once per iteration for the stop test (one host sync per iteration).

Convergence follows ISTL semantics: 2-norm of the defect, relative
reduction `tol` against the initial defect with absolute floor `atol`.
BiCGStab, MINRES, GMRES and the Richardson loop are not ported yet
(ROADMAP slice 3, remainder).
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch


class SolverStats(NamedTuple):
    """Result bookkeeping (PDELab LinearSolverResult analog, reference:
    dune/pdelab/backend/solver.hh)."""
    iterations: int
    converged: Any      # 0-d bool tensor
    defect0: Any        # 0-d tensor
    defect: Any         # 0-d tensor


def _norm(a):
    return torch.sqrt(torch.dot(a, a))


def _identity(r):
    return r


def cg(A: Callable, b, x0=None, M: Callable = _identity, tol=1e-10, atol=0.0,
       maxiter=5000):
    """Preconditioned conjugate gradients (ISTL CGSolver semantics)."""
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - A(x)
    defect0 = _norm(r)
    z = M(r)
    rho = torch.dot(r, z)
    target = torch.clamp_min(tol * defect0, atol)
    p, it, defect = z, 0, defect0
    while it < maxiter and bool(defect > target):
        q = A(p)
        alpha = rho / torch.dot(p, q)
        x = x + alpha * p
        r = r - alpha * q
        z = M(r)
        rho_new = torch.dot(r, z)
        p = z + (rho_new / rho) * p
        rho = rho_new
        it += 1
        defect = _norm(r)
    return x, SolverStats(it, defect <= target, defect0, defect)
