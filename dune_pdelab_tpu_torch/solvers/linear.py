"""Linear solver backends: Krylov + preconditioner combinations.

PyTorch port of dune_pdelab_tpu/solvers/linear.py (reference:
dune/pdelab/backend/istl/seqistlsolverbackend.hh:112-1060 and the
matrix-free backends, matrixfree/backends.hh:64), limited to CG with no,
Richardson, Jacobi or a callable preconditioner on two operator tiers:

  * compiled stencil: compile_stencil's StencilOperator, whose apply is the
    stencil27 kernel for a k = 1 3D operator on a CUDA tensor (its plain
    version on a CPU tensor, the plain multi-class form for k > 1 or 2D);
    Jacobi takes the stencil's exact diagonal;
  * general-jvp: go.jacobian_apply (torch.func.jvp) per apply; Jacobi takes
    go.jacobian_diagonal.

A callable `precond(go, x_lin, time) -> M` (e.g. a LatticeGMG) runs on the
general-jvp tier, as in the reference (solvers/linear.py:302-312).

Unlike the reference, no exception of the stencil tier is swallowed: a
kernel that fails to build or launch raises. The tier taken shows in
`report()` and in the kernels' launch counters.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

from dune_pdelab_tpu_torch.assembly.stencil import compile_stencil
from dune_pdelab_tpu_torch.linalg import krylov

_PRECONDS = (None, "none", "richardson", "jacobi")


@dataclass
class LinearSolverBackend:
    """Configurable Krylov backend.

    solver:  'cg'
    precond: 'none' | 'richardson' | 'jacobi' | callable(go, x_lin, time) -> M
    use_stencil: try the compiled-stencil tier before the general-jvp one
    Assembled operators (lattice-ELL, BCOO) wait for ROADMAP slice 6.
    """

    solver: str = "cg"
    precond: Any = "jacobi"
    maxiter: int = 5000
    use_stencil: bool = True
    stats_history: list = field(default_factory=list)
    _setup_cache: dict = field(default_factory=dict, repr=False)
    _last_path: dict = field(default_factory=dict, repr=False)

    def __post_init__(self):
        if self.solver != "cg":
            raise NotImplementedError(
                f"solver {self.solver!r} is not ported yet (BiCGStab, MINRES, "
                "GMRES and the Richardson loop: ROADMAP slice 3 remainder)")
        if not callable(self.precond) and self.precond not in _PRECONDS:
            raise NotImplementedError(
                f"preconditioner {self.precond!r} is not ported yet "
                "(block_jacobi, chebyshev, block_gs: ROADMAP slice 7)")

    def _stencil_for(self, go, x_lin, time):
        key = (id(go), "stencil")
        if key not in self._setup_cache:
            reasons = self._setup_cache.setdefault((id(go), "tier_reasons"), {})
            st = compile_stencil(go, x_lin, time)
            if st is None:
                reasons["stencil"] = ("compile_stencil declined (space/mesh/"
                                      "operator not a translation-invariant "
                                      "lattice)")
            self._setup_cache[key] = st
        return self._setup_cache[key]

    def _jacobi_diag(self, go, st, x_lin, b, time):
        key = (id(go), "diag", b.dtype, str(b.device))
        if key not in self._setup_cache:
            if st is None:
                self._setup_cache[key] = go.jacobian_diagonal(
                    x_lin.to(device=b.device, dtype=b.dtype), time)
            else:
                self._setup_cache[key] = st.diagonal(dtype=b.dtype, device=b.device)
        return self._setup_cache[key]

    def report(self, go=None) -> str:
        """Which operator-apply tier the last solve landed on, and why the
        faster tiers declined. One line per tier."""
        items = [(gid, p) for gid, p in self._last_path.items()
                 if go is None or gid == id(go)]
        if not items:
            return ("solver_report: no solve recorded yet "
                    "(call after backend.solve/.apply)")
        lines = []
        for gid, p in items:
            lines.append(f"solve path: {p}")
            reasons = self._setup_cache.get((gid, "tier_reasons"), {})
            for tier, why in reasons.items():
                lines.append(f"  declined {tier}: {why}")
            if "general-jvp" in p and not reasons:
                lines.append("  (stencil tier not attempted: nonlinear "
                             "operator or use_stencil=False)")
        return "\n".join(lines)

    def solve(self, go, x_lin, b, reduction, time=0.0, x0=None):
        """Solve J(x_lin) z = b to relative `reduction`; returns (z, stats)."""
        custom = callable(self.precond)
        st = None
        if self.use_stencil and not custom and getattr(go.lop, "is_linear", False):
            st = self._stencil_for(go, x_lin, time)
        if st is not None:
            A = st
            if not st.uses_stencil27:
                how = "plain torch (k > 1 or 2D: no kernel)"
            elif b.device.type == "cuda":
                how = "stencil27 CUDA kernel"
            else:
                how = "stencil27 plain torch (CPU tensor)"
            path = f"compiled stencil StencilOperator [{how}]"
        else:
            A = lambda z: go.jacobian_apply(x_lin, z, time)
            path = "general-jvp (matrix-free batched assembly per apply)"
        if custom:
            M = self.precond(go, x_lin, time)
            path = ("general-jvp (matrix-free) + custom preconditioner "
                    f"{type(self.precond).__name__}")
        elif self.precond == "jacobi":
            diag = self._jacobi_diag(go, st, x_lin, b, time)
            M = lambda r: r / diag
        else:
            M = krylov._identity
        z, stats = krylov.cg(A, b, x0=x0, M=M, tol=reduction,
                             maxiter=self.maxiter)
        self.stats_history.append(stats)
        self._last_path[id(go)] = path
        return z, stats


def SEQ_CG_Jacobi(**kw):
    """ISTLBackend_SEQ_CG_Jac analog (seqistlsolverbackend.hh)."""
    return LinearSolverBackend(solver="cg", precond="jacobi", **kw)
