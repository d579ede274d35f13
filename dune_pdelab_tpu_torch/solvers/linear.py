"""Linear solver backends: Krylov + preconditioner combinations.

PyTorch port of dune_pdelab_tpu/solvers/linear.py (reference:
dune/pdelab/backend/istl/seqistlsolverbackend.hh:112-1060 and the
matrix-free backends, matrixfree/backends.hh:64). Solvers: cg, bicgstab,
minres, gmres(restart) and the Richardson loop; preconditioners: none,
Richardson, Jacobi, element-block Jacobi, Chebyshev, colored element-block
Gauss-Seidel or a callable. The operator tiers, in the reference's order
of choice:

  * a callable `precond(go, x_lin, time) -> M` (a LatticeGMG, an ILU)
    runs on the general-jvp tier, even with matrix_free=False (reference
    :302-312), unless it sets `krylov_fast_tiers` (AlgebraicMultigrid):
    then the Krylov operator takes the tiers below, as with a built-in
    preconditioner (on a lattice space, the compiled stencil);
  * matrix_free=False: the assembled lattice-ELL matrix (assemble_ell; its
    apply is the ell27 kernel for a k = 1 3D operator on a CUDA tensor);
    where the space does not qualify, or use_ell=False, the sparse COO
    Jacobian (go.jacobian), with the declined tier in `report()`;
  * compiled stencil: compile_stencil's StencilOperator (the stencil27
    kernel for a k = 1 3D operator on a CUDA tensor); for a DG space,
    compile_block_stencil's operator, lowered to the mode-major
    MMBlockStencil in 3D (the blockstencil kernel, block_stencil_mm) and
    kept element-major in 2D (block_stencil_em). With none, Richardson,
    Jacobi or Chebyshev the Krylov loop on an MMBlockStencil runs in the
    mode-major layout (one transpose at entry and exit). Jacobi and
    Chebyshev take the (block) stencil's exact diagonal;
  * general-jvp: go.jacobian_apply (torch.func.jvp) per apply; on the card
    the apply is captured once per solve into a CUDA graph and replayed
    (GraphedApply), bit-equal to the eager apply; on the CPU an operator
    that allows it (`reverse_mode_apply`) has its apply rebuilt once per
    solve by reverse mode applied twice (`transposed_twice`).

Jacobi takes go.jacobian_diagonal on every tier but the stencil one, as in
the reference; block Jacobi and block GS take go.element_diagonal_blocks,
Chebyshev a 25-step power iteration on go.jacobian_apply. Unlike the
reference, no exception of a faster tier is swallowed: a kernel that fails
to build or launch raises. The tier taken shows in `report()` and in the
kernels' launch counters.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Any

import torch

from dune_pdelab_tpu_torch.assembly.blockstencil import compile_block_stencil
from dune_pdelab_tpu_torch.assembly.blockstencil_mm import (
    MMBlockStencil, try_mm_block_stencil,
)
from dune_pdelab_tpu_torch.assembly.ell import EllMatrix, assemble_ell
from dune_pdelab_tpu_torch.assembly.stencil import compile_stencil
from dune_pdelab_tpu_torch.linalg import krylov, preconditioners
from dune_pdelab_tpu_torch.utils.common import device_key

_PRECONDS = (None, "none", "richardson", "jacobi", "block_jacobi", "chebyshev",
             "block_gs")
# preconditioners a Krylov loop may run in the mode-major layout
_MM_PRECONDS = (None, "none", "richardson", "jacobi", "chebyshev")


class GraphedApply:
    """z -> apply(z) on the card, replayed from one CUDA graph.

    The general-jvp tier's apply (`go.jacobian_apply(x_lin, z, time)`)
    issues a few hundred small operations, and in torch's forward mode
    each one whose other operand carries no tangent costs ~0.2-0.4 ms of
    host time (a Python meta kernel behind the zero tangent), so an apply
    of a pointwise-heavy kernel (two-phase flow) is host-bound at ~50 ms
    whatever the mesh. Within one Krylov solve the linearization point,
    time and operator stay fixed, so the first call runs eagerly, the
    second captures the apply once into a CUDA graph (after a warm-up on
    a side stream) and every later call copies z into the captured input
    and replays it: the same kernels on the same data, so the results are
    bit-equal to the eager apply. An apply that cannot be captured (one
    that copies from the host or synchronises) runs eagerly and `reason`
    says why. A GraphedApply lives for one solve."""

    def __init__(self, apply):
        self.apply = apply
        self.calls = 0
        self.graph = None
        self.reason = None

    def _capture(self, z):
        self.z_in = z.clone()
        side = torch.cuda.Stream(device=z.device)
        side.wait_stream(torch.cuda.current_stream(z.device))
        with torch.cuda.stream(side):
            self.apply(self.z_in)
        torch.cuda.current_stream(z.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self.z_out = self.apply(self.z_in)
        self.graph = graph

    def __call__(self, z):
        if self.graph is None:
            self.calls += 1
            if self.calls < 2 or self.reason is not None:
                return self.apply(z)
            try:
                self._capture(z)
            except RuntimeError as exc:      # capture refused: run eagerly, say so
                self.graph, self.reason = None, f"capture failed: {exc}".splitlines()[0]
                torch.cuda.synchronize(z.device)
                return self.apply(z)
        self.z_in.copy_(z)
        self.graph.replay()
        return self.z_out.clone()


def transposed_twice(apply, like):
    """z -> apply(z) for a linear `apply` on vectors shaped as `like`,
    rebuilt for the many calls of one Krylov solve on the host.

    On the CPU, torch's forward mode spends ~0.4 ms of host time on each
    operation whose other operand carries no tangent (see GraphedApply),
    so a general-jvp apply of a pointwise-heavy kernel costs ~10x its
    residual (config11's two-phase operator: 48 ms against 5 ms). Reverse
    mode has no such cost: the vjp of `apply` is w -> J^T w, a linear map
    whose vjp is z -> J z again. Both are built once (one apply and one
    backward pass); each later call is one backward pass through the
    second graph (4.4 ms for that operator), and gives J z up to the order
    of its sums."""
    z0 = torch.zeros_like(like)
    y0, transpose = torch.func.vjp(apply, z0)
    _, twice = torch.func.vjp(lambda w: transpose(w)[0], torch.zeros_like(y0))
    return lambda z: twice(z)[0]


def _general_apply(go, x_lin, b, time):
    """The general-jvp tier's z -> go.jacobian_apply(x_lin, z, time) and a
    note on how it runs: on the CPU transposed twice where the operator
    allows reverse mode through its apply (a real dtype, and no
    communicating autograd Function on the path: `reverse_mode_apply`),
    else one jvp per call."""
    apply = lambda z: go.jacobian_apply(x_lin, z, time)      # noqa: E731
    if (b.device.type == "cpu" and getattr(go, "reverse_mode_apply", False)
            and not b.is_complex()):
        return transposed_twice(apply, b), "; transposed twice"
    return apply, ""


def _kernel_how(uses_kernel, name, device):
    if not uses_kernel:
        return "plain torch (k > 1 or 2D: no kernel)"
    if device.type == "cuda":
        return f"{name} CUDA kernel"
    return f"{name} plain torch (CPU tensor)"


@dataclass
class LinearSolverBackend:
    """Configurable Krylov backend.

    solver:  'cg' | 'bicgstab' | 'minres' | 'gmres' | 'loop'
    precond: 'none' | 'richardson' | 'jacobi' | 'block_jacobi' | 'chebyshev'
             | 'block_gs' | callable(go, x_lin, time) -> M
    matrix_free: True -> stencil / go.jacobian_apply tiers;
             False -> assembled (lattice-ELL, else sparse COO) matvec
    use_stencil: try the compiled-stencil tier before the general-jvp one
    use_ell: on the assembled path, prefer the lattice-ELL layout
    """

    solver: str = "cg"
    precond: Any = "jacobi"
    maxiter: int = 5000
    restart: int = 30
    matrix_free: bool = True
    use_stencil: bool = True
    use_ell: bool = True
    cheby_degree: int = 4
    stats_history: list = field(default_factory=list)
    _setup_cache: dict = field(default_factory=dict, repr=False)
    _last_path: dict = field(default_factory=dict, repr=False)

    def __post_init__(self):
        if self.solver not in krylov.SOLVERS:
            raise ValueError(f"unknown solver {self.solver!r}; one of "
                             f"{sorted(krylov.SOLVERS)}")
        if not callable(self.precond) and self.precond not in _PRECONDS:
            raise ValueError(f"unknown preconditioner {self.precond!r} (the SSOR "
                             "backends pass a callable: SEQ_CG_SSOR, SEQ_BCGS_SSOR)")

    def _reasons(self, go):
        return self._setup_cache.setdefault((id(go), "tier_reasons"), {})

    def _stencil_for(self, go, x_lin, time):
        """The compiled stencil: a StencilOperator, else (DG) the block
        stencil, lowered to an MMBlockStencil in 3D; None when neither
        applies."""
        key = (id(go), "stencil")
        if key not in self._setup_cache:
            st = compile_stencil(go, x_lin, time)
            if st is None:
                self._reasons(go)["stencil"] = (
                    "compile_stencil declined (space/mesh/operator not a "
                    "translation-invariant lattice)")
                st = compile_block_stencil(go, x_lin, time)
                if st is None:
                    self._reasons(go)["block_stencil"] = (
                        "compile_block_stencil declined (not a lattice DG space / "
                        "operator)")
                else:
                    st = try_mm_block_stencil(st) or st
            self._setup_cache[key] = st
        return self._setup_cache[key]

    @staticmethod
    def _keep(go, reuse):
        """Whether data set up at an earlier solve still holds: always for
        a linear operator, for a nonlinear one (a OneStepGridOperator, whose
        stage weights change with dt, among them) only when the caller
        reuses its linearization point (reuse=True)."""
        return reuse or getattr(go.lop, "is_linear", False)

    def _assembled_for(self, go, x_lin, time, reuse=False):
        """The lattice-ELL matrix, else the sparse COO Jacobian; assembled
        once for a linear operator, at each solve for a nonlinear one
        unless reuse=True."""
        key = (id(go), "matval")
        if key not in self._setup_cache or not self._keep(go, reuse):
            mat = assemble_ell(go, x_lin, time) if self.use_ell else None
            if mat is None:
                self._reasons(go)["lattice-ELL"] = (
                    "use_ell=False" if not self.use_ell else
                    "assemble_ell declined (not a single-leaf C0 Qk lattice space)")
                mat = go.jacobian(x_lin, time)
            self._setup_cache[key] = mat
        return self._setup_cache[key]

    def _jacobi_diag(self, go, op, x_lin, b, time, reuse=False):
        key = (id(go), "diag", b.dtype, device_key(b.device))
        if key not in self._setup_cache or not self._keep(go, reuse):
            if op is not None:
                d = op.diagonal(dtype=b.dtype, device=b.device)
            else:
                d = go.jacobian_diagonal(x_lin.to(device=b.device, dtype=b.dtype), time)
            self._setup_cache[key] = d.to(device=b.device, dtype=b.dtype)
        return self._setup_cache[key]

    def _precond_setup(self, go, op, x_lin, b, time, reuse=False):
        """Preconditioner data, computed once per operator, dtype and device
        for a linear operator and at each solve for a nonlinear one unless
        reuse=True."""
        p = self.precond
        if p in (None, "none", "richardson"):
            return {}
        key = (id(go), "precond", p, b.dtype, device_key(b.device))
        if key in self._setup_cache and self._keep(go, reuse):
            return self._setup_cache[key]
        xl = x_lin.to(device=b.device, dtype=b.dtype)
        setup = {}
        if p in ("jacobi", "chebyshev"):
            setup["diag"] = self._jacobi_diag(go, op, x_lin, b, time, reuse)
        if p == "chebyshev":
            setup["lmax"] = preconditioners.power_iteration(
                lambda z: go.jacobian_apply(xl, z, time), setup["diag"],
                go.space.ndofs, dtype=b.dtype)
        elif p in ("block_jacobi", "block_gs"):
            blocks = go.element_diagonal_blocks(xl, time)
            setup["dofs"] = torch.as_tensor(go.elem_gdofs_cat, device=b.device)
            setup["dinv"] = preconditioners._explicit_block_inverse(blocks)
            if p == "block_gs":
                setup["colors"] = preconditioners.checkerboard_colors(
                    go.mesh, device=b.device)
        self._setup_cache[key] = setup
        return setup

    def _make_M(self, setup, A):
        p = self.precond
        if p in (None, "none", "richardson"):
            return krylov._identity
        if p == "jacobi":
            diag = setup["diag"]
            return lambda r: r / diag
        if p == "chebyshev":
            return preconditioners.chebyshev(A, setup["diag"], setup["lmax"],
                                             degree=self.cheby_degree)
        if p == "block_jacobi":
            return preconditioners._block_jacobi_apply(setup["dofs"], setup["dinv"])
        return preconditioners._colored_sweeps(A, setup["dofs"], setup["dinv"],
                                               setup["colors"])

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
            if not self.matrix_free and not reasons:
                lines.append("  (assembled path requested: matrix_free="
                             "False; stencil tiers not attempted)")
            if self.matrix_free and "general-jvp" in p and not reasons:
                lines.append("  (stencil tier not attempted: nonlinear "
                             "operator or use_stencil=False)")
        return "\n".join(lines)

    def _operator(self, go, x_lin, b, time, reuse=False):
        """(A, the stencil Jacobi reads its diagonal from or None, path)."""
        if callable(self.precond) and not getattr(self.precond, "krylov_fast_tiers",
                                                  False):
            return (_general_apply(go, x_lin, b, time)[0], None,
                    "general-jvp (matrix-free) + custom preconditioner "
                    f"{type(self.precond).__name__}")
        if not self.matrix_free:
            mat = self._assembled_for(go, x_lin, time, reuse)
            if isinstance(mat, EllMatrix):
                how = _kernel_how(mat.uses_ell27, "ell27", b.device)
                return mat, None, f"assembled EllMatrix [{how}]"
            return (lambda z: mat @ z, None,
                    "assembled sparse COO matvec (slowest assembled tier)")
        st = None
        if self.use_stencil and getattr(go.lop, "is_linear", False):
            st = self._stencil_for(go, x_lin, time)
        if isinstance(st, MMBlockStencil):
            how = _kernel_how(True, "blockstencil", b.device)
            layout = ("mode-major resident" if self.precond in _MM_PRECONDS
                      else "flat")
            return st, st, f"compiled block stencil MMBlockStencil [{layout}; {how}]"
        if st is not None and hasattr(st, "W_taps"):
            how = _kernel_how(True, "blockstencil", b.device)
            return (st, st, "compiled block stencil BlockStencilOperator "
                    f"[element-major; {how}]")
        if st is not None:
            how = _kernel_how(st.uses_stencil27, "stencil27", b.device)
            return st, st, f"compiled stencil StencilOperator [{how}]"
        apply, how = _general_apply(go, x_lin, b, time)
        if b.device.type == "cuda":
            apply, how = GraphedApply(apply), "; CUDA graph replay"
        return apply, None, f"general-jvp (matrix-free batched assembly per apply{how})"

    def solve(self, go, x_lin, b, reduction, time=0.0, x0=None, reuse=False):
        """Solve J(x_lin) z = b to relative `reduction`; returns (z, stats).

        reuse=True: keep the previously assembled Jacobian and
        preconditioner data (the NewtonMethod reassemble_threshold
        contract, reference: dune/pdelab/solver/newton.hh:98-120); x_lin
        must then be the linearization point of that earlier assembly. A
        callable preconditioner keeps its own cache (GeometricMultigrid:
        per linearization point)."""
        A, op, path = self._operator(go, x_lin, b, time, reuse)
        kw = {"restart": self.restart} if self.solver == "gmres" else {}
        run = krylov.SOLVERS[self.solver]
        if callable(self.precond):
            M = self.precond(go, x_lin, time)
            if getattr(self.precond, "krylov_fast_tiers", False):
                path += f" + preconditioner {type(self.precond).__name__}"
        else:
            setup = self._precond_setup(go, op, x_lin, b, time, reuse)
            if isinstance(A, MMBlockStencil) and self.precond in _MM_PRECONDS:
                # iterate in the mode-major layout: to_mm is a permutation,
                # so the diagonal transforms as the residual does
                mm = A

                def A_mm(v):
                    return mm.apply_mm(v.reshape(mm.mm_shape)).reshape(-1)

                def to_mm(v):
                    return mm.to_mm(v).reshape(-1)

                setup = {k: to_mm(v) if k == "diag" else v for k, v in setup.items()}
                A, b = A_mm, to_mm(b)
                x0 = None if x0 is None else to_mm(x0)
            M = self._make_M(setup, A)
        z, stats = run(A, b, x0=x0, M=M, tol=reduction, maxiter=self.maxiter, **kw)
        self.stats_history.append(stats)
        if isinstance(A, GraphedApply):
            if A.reason is not None:
                path += " [graph declined]"
                self._reasons(go)["CUDA graph replay"] = A.reason
            else:
                self._reasons(go).pop("CUDA graph replay", None)
        self._last_path[id(go)] = path
        if A is not op and isinstance(op, MMBlockStencil):
            z = op.from_mm(z.reshape(op.mm_shape))
        return z, stats


# Convenience constructors mirroring common reference backends -------------

def SEQ_CG_Jacobi(**kw):
    """ISTLBackend_SEQ_CG_Jac analog (seqistlsolverbackend.hh)."""
    return LinearSolverBackend(solver="cg", precond="jacobi", **kw)


def SEQ_BCGS_Jacobi(**kw):
    """ISTLBackend_SEQ_BCGS_Jac analog."""
    return LinearSolverBackend(solver="bicgstab", precond="jacobi", **kw)


def SEQ_GMRES_Jacobi(**kw):
    return LinearSolverBackend(solver="gmres", precond="jacobi", **kw)


def SEQ_CG_ILU0(**kw):
    """ISTLBackend_SEQ_CG_ILU0 analog: CG with the fine-grained parallel
    lattice ILU(0) (linalg/ilu.py; needs a single-leaf C0 Qk space)."""
    from dune_pdelab_tpu_torch.linalg.ilu import ilu0_preconditioner
    return LinearSolverBackend(solver="cg", precond=ilu0_preconditioner, **kw)


def SEQ_BCGS_ILU0(**kw):
    """ISTLBackend_SEQ_BCGS_ILU0 analog."""
    from dune_pdelab_tpu_torch.linalg.ilu import ilu0_preconditioner
    return LinearSolverBackend(solver="bicgstab", precond=ilu0_preconditioner, **kw)


def SEQ_CG_ILUn(level=1, **kw):
    """ISTLBackend_SEQ_CG_ILUn analog: lattice ILU with fill level n."""
    from dune_pdelab_tpu_torch.linalg.ilu import ilun_preconditioner
    return LinearSolverBackend(solver="cg", precond=ilun_preconditioner(level), **kw)


def SEQ_BCGS_ILUn(level=1, **kw):
    """ISTLBackend_SEQ_BCGS_ILUn analog."""
    from dune_pdelab_tpu_torch.linalg.ilu import ilun_preconditioner
    return LinearSolverBackend(solver="bicgstab", precond=ilun_preconditioner(level),
                               **kw)


def SEQ_CG_SSOR(omega=1.0, sweeps=1, **kw):
    """ISTLBackend_SEQ_CG_SSOR analog: multicolor SSOR on the DOF lattice
    (forward+backward Gauss-Seidel over coordinate-parity color classes)."""
    p = functools.partial(preconditioners.ssor_preconditioner, omega=omega,
                          sweeps=sweeps)
    return LinearSolverBackend(solver="cg", precond=p, **kw)


def SEQ_BCGS_SSOR(omega=1.0, sweeps=1, **kw):
    """ISTLBackend_SEQ_BCGS_SSOR analog."""
    p = functools.partial(preconditioners.ssor_preconditioner, omega=omega,
                          sweeps=sweeps)
    return LinearSolverBackend(solver="bicgstab", precond=p, **kw)


def SEQ_CG_BlockJacobi(**kw):
    """CG with element-block Jacobi (exact block-diagonal inverse on DG)."""
    kw.setdefault("solver", "cg")
    return LinearSolverBackend(precond="block_jacobi", **kw)


def MatrixFree_CG_Richardson(**kw):
    """ISTLBackend_SEQ_MatrixFree_Richardson analog (matrixfree/backends.hh)."""
    return LinearSolverBackend(solver="cg", precond="richardson", **kw)


def SEQ_CG_AMG(**amg_kw):
    """ISTLBackend_SEQ_CG_AMG_* analog (seqistlsolverbackend.hh:829-1060):
    CG preconditioned by smoothed-aggregation AMG on the assembled operator
    (linalg/amg.py), on any mesh and space. The keyword arguments split
    into AMG knobs (theta, max_coarse, smoother, ...) and backend knobs."""
    import inspect

    from dune_pdelab_tpu_torch.linalg.amg import AlgebraicMultigrid
    names = set(inspect.signature(AlgebraicMultigrid.__init__).parameters) - {"self"}
    akw = {k: v for k, v in amg_kw.items() if k in names}
    bkw = {k: v for k, v in amg_kw.items() if k not in names}
    return LinearSolverBackend(solver="cg", precond=AlgebraicMultigrid(**akw), **bkw)


def SEQ_BCGS_AMG(**amg_kw):
    """ISTLBackend_SEQ_BCGS_AMG_* analog."""
    b = SEQ_CG_AMG(**amg_kw)
    b.solver = "bicgstab"
    return b
