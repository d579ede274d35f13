"""Algebraic multigrid (smoothed aggregation) for general assembled operators.

PyTorch port of dune_pdelab_tpu/linalg/amg.py (reference: dune-istl's
aggregation AMG behind ISTLBackend_SEQ_CG_AMG_SSOR,
dune/pdelab/backend/istl/seqistlsolverbackend.hh:829-1060). It works on
any assembled sparse matrix (simplex, unstructured), where the structured
multigrids (LatticeGMG, GeometricMultigrid) do not apply.

* SETUP stays host numpy/scipy, function for function as in the reference:
  strength-of-connection filtering, greedy aggregation (the port's own
  csrc/amg_setup.cc, built with g++ into build/torch_kernels/ at first use;
  a failed build raises, and the Python `_aggregate` runs only when asked
  with native=False), near-nullspace tentative prolongation with
  per-aggregate QR, Jacobi-smoothed prolongation, Galerkin RAP products.
  The setup runs in float64 whatever the solve's dtype; the level matrices
  are cast to the dtype of the vector the cycle is applied to.
* CYCLE runs on the device: padded-ELL level matrices as tensors, every
  SpMV `(vals * z[cols]).sum(1)` in plain torch (a gather, a multiply and a
  reduction), damped-Jacobi or Chebyshev smoothers and a dense LU coarse
  solve, factored on the host in float64 (torch.linalg.lu_factor: LAPACK's
  1-based pivots) and solved on the device. Eager torch: about five SpMVs
  per level and cycle, each a few launches.

Usage: `AlgebraicMultigrid()` is a LinearSolverBackend `precond` callable
(`(go, x_lin, time) -> (r -> M r)`), or build one directly from a scipy
CSR with `AlgebraicMultigrid.from_csr(A)`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time as _time

import numpy as np
import torch

from dune_pdelab_tpu_torch.utils.common import device_key, resolve_device

_SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "csrc", "amg_setup.cc")
_GXX_FLAGS = ["-O3", "-shared", "-fPIC"]
_NATIVE = None


# ---------------------------------------------------------------------------
# host-side setup: aggregation hierarchy (numpy/scipy only)
# ---------------------------------------------------------------------------

def _strength_graph(A, theta):
    """Symmetric strength-of-connection: keep a_ij with
    |a_ij| >= theta * sqrt(|a_ii a_jj|). Returns a boolean CSR (no diag)."""
    import scipy.sparse as sp

    d = np.abs(A.diagonal())
    d = np.where(d > 0, d, 1.0)
    C = A.tocoo(copy=True)
    off = C.row != C.col
    keep = off & (np.abs(C.data) >= theta * np.sqrt(d[C.row] * d[C.col]))
    return sp.csr_matrix((np.ones(keep.sum(), np.int8), (C.row[keep], C.col[keep])),
                         shape=A.shape)


def native_library() -> ctypes.CDLL:
    """The aggregation library, compiled from csrc/amg_setup.cc with g++
    into build/torch_kernels/ (keyed by a hash of the source and flags) on
    first use. A missing g++ or a failed compile raises."""
    global _NATIVE
    if _NATIVE is not None:
        return _NATIVE
    from dune_pdelab_tpu_torch.kernels._build import BUILD_DIR

    with open(_SOURCE, "rb") as f:
        src = f.read()
    h = hashlib.sha256(" ".join(_GXX_FLAGS).encode() + src).hexdigest()[:16]
    lib = BUILD_DIR / f"libamgsetup_{h}.so"
    if not lib.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        try:
            proc = subprocess.run(["g++", *_GXX_FLAGS, "-o", str(tmp), _SOURCE],
                                  capture_output=True, text=True)
        except FileNotFoundError as e:
            raise RuntimeError("g++ not found: the AMG aggregation is built from "
                               "csrc/amg_setup.cc at first use") from e
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}) on {_SOURCE}:\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib)
    L = ctypes.CDLL(str(lib))
    i64p = ctypes.POINTER(ctypes.c_int64)
    L.amg_aggregate.restype = ctypes.c_int64
    L.amg_aggregate.argtypes = [ctypes.c_int64, i64p, i64p,
                                ctypes.POINTER(ctypes.c_uint8), i64p]
    _NATIVE = L
    return L


def _aggregate(S, decoupled, native=True):
    """Greedy (Vanek) aggregation on the strength graph.

    Pass 1: a node whose strong neighbourhood is untouched seeds an
    aggregate of itself + neighbours. Pass 2: leftovers join the first
    aggregated strong neighbour. Pass 3: remaining isolated nodes become
    singletons. Structurally decoupled rows (no off-diagonal entries in A
    at all: Dirichlet identity rows after symmetric elimination) are
    excluded from the coarse space (agg = -2). native=True runs
    csrc/amg_setup.cc, native=False the Python loop below (the behavioural
    spec; an isolated non-decoupled node is numbered in pass 1 there and
    in pass 3 here, as in the reference). Returns (agg, n_agg)."""
    n = S.shape[0]
    if native:
        L = native_library()
        i64p = ctypes.POINTER(ctypes.c_int64)
        indptr64 = np.ascontiguousarray(S.indptr, np.int64)
        indices64 = np.ascontiguousarray(S.indices, np.int64)
        dec = np.ascontiguousarray(decoupled, np.uint8)
        agg = np.empty(n, np.int64)
        n_agg = L.amg_aggregate(n, indptr64.ctypes.data_as(i64p),
                                indices64.ctypes.data_as(i64p),
                                dec.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                                agg.ctypes.data_as(i64p))
        return agg, int(n_agg)
    agg = np.full(n, -1, np.int64)
    agg[decoupled] = -2
    indptr, indices = S.indptr, S.indices
    n_agg = 0
    for i in range(n):
        if agg[i] != -1:
            continue
        nbrs = indices[indptr[i]:indptr[i + 1]]
        if nbrs.size and np.all(agg[nbrs] == -1):
            agg[i] = n_agg
            agg[nbrs] = n_agg
            n_agg += 1
    for i in range(n):
        if agg[i] != -1:
            continue
        nbrs = indices[indptr[i]:indptr[i + 1]]
        owned = nbrs[agg[nbrs] >= 0]
        if owned.size:
            agg[i] = agg[owned[0]]
    for i in range(n):
        if agg[i] == -1:
            agg[i] = n_agg
            n_agg += 1
    return agg, n_agg


def _tentative_prolongation(agg, n_agg, B):
    """Near-nullspace-exact tentative prolongation.

    B: (n, nb) near-nullspace block (default: the constant vector). Per
    aggregate, the thin QR of B's rows gives an orthonormal local basis (the
    P0 column block) and the coarse-level near-nullspace (the R factor)."""
    import scipy.sparse as sp

    n, nb = B.shape
    member = np.flatnonzero(agg >= 0)
    if nb == 1:
        # vectorised normalisation; a column sign flip would propagate as an
        # exact +-1 similarity through smoothing and RAP
        nrm2 = np.zeros(n_agg, B.dtype)
        np.add.at(nrm2, agg[member], B[member, 0] ** 2)
        nrm = np.sqrt(nrm2)
        nrm_safe = np.where(nrm == 0, 1.0, nrm)
        P0 = sp.csr_matrix((B[member, 0] / nrm_safe[agg[member]],
                            (member, agg[member])), shape=(n, n_agg))
        return P0, nrm[:, None]
    order = member[np.argsort(agg[member], kind="stable")]
    bounds = np.searchsorted(agg[order], np.arange(n_agg + 1))
    rows, cols, vals = [], [], []
    Bc = np.zeros((n_agg * nb, nb), B.dtype)
    for a in range(n_agg):
        idx = order[bounds[a]:bounds[a + 1]]
        Q, R = np.linalg.qr(B[idx])  # (m, nb), (nb, nb)
        rows.append(np.repeat(idx, nb))
        cols.append(np.tile(a * nb + np.arange(nb), idx.size))
        vals.append(Q.reshape(-1))
        Bc[a * nb:(a + 1) * nb] = R
    P0 = sp.csr_matrix((np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
                       shape=(n, n_agg * nb))
    return P0, Bc


def _spectral_radius(A, iters=15, seed=0):
    """Power-iteration estimate of rho(D^-1 A) (host, scipy; numpy's
    default_rng(seed) start vector, as the reference)."""
    rng = np.random.default_rng(seed)
    d = A.diagonal()
    d = np.where(np.abs(d) > 0, d, 1.0)
    x = rng.standard_normal(A.shape[0])
    x /= np.linalg.norm(x)
    rho = 1.0
    for _ in range(iters):
        y = (A @ x) / d
        ny = np.linalg.norm(y)
        if ny == 0:
            return 1.0
        rho, x = ny, y / ny
    return rho


def _csr_to_ell(A):
    """CSR -> padded ELL numpy arrays (cols (n, k) int64, vals (n, k)); pads
    hold a zero value at column min(row, ncols - 1), in bounds (the
    reference pads with the row index, which XLA's gather clamps to the
    last column of a wide P or R)."""
    A = A.tocsr()
    A.sum_duplicates()
    n = A.shape[0]
    counts = np.diff(A.indptr)
    k = max(int(counts.max()), 1)
    pad = np.minimum(np.arange(n, dtype=np.int64), A.shape[1] - 1)
    cols = np.tile(pad[:, None], (1, k))
    vals = np.zeros((n, k), A.dtype)
    r = np.repeat(np.arange(n), counts)
    pos = np.arange(A.nnz) - np.repeat(A.indptr[:-1], counts)
    cols[r, pos] = A.indices
    vals[r, pos] = A.data
    return cols, vals


def _ell_apply(cols, vals, z):
    return (vals * z[cols]).sum(dim=1)


class _Level:
    """One level's host ELL arrays (float64) and their device copies per
    (dtype, device)."""
    __slots__ = ("A", "P", "R", "diag", "lmax", "n", "nc", "dev")


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class AlgebraicMultigrid:
    """Smoothed-aggregation AMG V-cycle preconditioner.

    Parameters mirror dune-istl's Amg::Parameters knobs where they exist:
    theta = strength threshold, max_coarse = coarsen target (ISTL
    coarsenTarget), presmooth/postsmooth = smoother steps, smoother =
    'jacobi' (damped 2/3) or 'chebyshev'. near_nullspace: (n, nb) array;
    None -> constants. The cycle lives on the device its setup names.

    A LinearSolverBackend running it keeps its fast operator tiers (the
    compiled stencil on a lattice space), `krylov_fast_tiers`; the
    reference runs every callable preconditioner on the general jvp.
    """

    krylov_fast_tiers = True

    def __init__(self, theta=0.02, max_coarse=256, max_levels=12,
                 omega=4.0 / 3.0, smoother="jacobi", presmooth=1,
                 postsmooth=1, jacobi_damping=2.0 / 3.0, cheby_degree=2,
                 near_nullspace=None):
        if smoother not in ("jacobi", "chebyshev"):
            raise ValueError(f"smoother={smoother!r}")
        self.theta = theta
        self.max_coarse = max_coarse
        self.max_levels = max_levels
        self.omega = omega
        self.smoother = smoother
        self.presmooth = presmooth
        self.postsmooth = postsmooth
        self.jacobi_damping = jacobi_damping
        self.cheby_degree = cheby_degree
        self.near_nullspace = near_nullspace
        self._setup_key = None
        self._levels = None
        self.setup_times = {}

    # -- setup ---------------------------------------------------------------
    def _tick(self, key, t0):
        self.setup_times[key] = self.setup_times.get(key, 0.0) + _time.perf_counter() - t0
        return _time.perf_counter()

    def setup_from_csr(self, A, keep_host=False, parts=None, device=None):
        """Build the hierarchy from a scipy sparse matrix (set up in
        float64).

        keep_host: also keep the hierarchy as host scipy CSRs
        (`self.host_levels` = [(A, P, R, diag, lmax), ...],
        `self.host_coarse` = dense coarse matrix).

        parts: decoupled per-block aggregation (Tuminaro/Tong): each level's
        rows split into `parts` contiguous blocks whose aggregates never span
        blocks, with per-block smoothed prolongation and Galerkin RAP
        contributions; `self.setup_part_walls[level]` records the measured
        per-block walls and `setup_parts_report()` extrapolates the
        distributed setup wall. The cycle lives on `device` (default: the
        default device).

        `setup_times` accumulates the host seconds of each phase over the
        levels: strength, aggregate, smooth_p (tentative P, rho, smoothed
        P), rap, ell_upload (ELL conversion and copy to the device),
        coarse_lu."""
        import scipy.sparse as sp

        device = resolve_device(device)
        A = sp.csr_matrix(A, dtype=np.float64)
        B = self.near_nullspace
        if B is None:
            B = np.ones((A.shape[0], 1))
        B = np.asarray(B, np.float64)
        host = []
        self.setup_parts = parts
        self.setup_part_walls = []
        for key in ("strength", "aggregate", "smooth_p", "rap", "ell_upload",
                    "coarse_lu"):
            self.setup_times.setdefault(key, 0.0)
        while A.shape[0] > self.max_coarse and len(host) < self.max_levels - 1:
            t = _time.perf_counter()
            S = _strength_graph(A, self.theta)
            offdiag = A - sp.diags(A.diagonal())
            offdiag.eliminate_zeros()
            decoupled = np.diff(offdiag.tocsr().indptr) == 0
            t = self._tick("strength", t)
            d = A.diagonal()
            d = np.where(np.abs(d) > 0, d, 1.0)
            if parts and parts > 1 and A.shape[0] >= 4 * parts:
                n = A.shape[0]
                bounds = np.linspace(0, n, parts + 1).astype(np.int64)
                agg = np.full(n, -2, np.int64)
                n_agg = 0
                walls = []
                Sc = S.tocsr()
                for p in range(parts):
                    t0 = _time.perf_counter()
                    r0, r1 = int(bounds[p]), int(bounds[p + 1])
                    ab, na = _aggregate(Sc[r0:r1, r0:r1], decoupled[r0:r1])
                    loc = ab >= 0
                    agg[r0:r1][loc] = ab[loc] + n_agg
                    n_agg += na
                    walls.append(_time.perf_counter() - t0)
                t = self._tick("aggregate", t)
                if n_agg == 0 or n_agg * B.shape[1] >= n:
                    break
                rho = _spectral_radius(A)
                P0, Bc = _tentative_prolongation(agg, n_agg, B)
                P_blocks = []
                for p in range(parts):
                    t0 = _time.perf_counter()
                    r0, r1 = int(bounds[p]), int(bounds[p + 1])
                    Pb = (P0[r0:r1] - (self.omega / rho)
                          * sp.diags(1.0 / d[r0:r1]) @ (A[r0:r1] @ P0))
                    P_blocks.append(Pb.tocsr())
                    walls[p] += _time.perf_counter() - t0
                P = sp.vstack(P_blocks).tocsr()
                t = self._tick("smooth_p", t)
                rap = None
                for p in range(parts):
                    t0 = _time.perf_counter()
                    r0, r1 = int(bounds[p]), int(bounds[p + 1])
                    contrib = P[r0:r1].T @ (A[r0:r1] @ P)
                    rap = contrib if rap is None else rap + contrib
                    walls[p] += _time.perf_counter() - t0
                A_next = rap.tocsr()
                self.setup_part_walls.append(walls)
                R = P.T.tocsr()
                t = self._tick("rap", t)
            else:
                agg, n_agg = _aggregate(S, decoupled)
                t = self._tick("aggregate", t)
                if n_agg == 0 or n_agg * B.shape[1] >= A.shape[0]:
                    break  # aggregation stalled (e.g. a diagonal matrix)
                rho = _spectral_radius(A)
                P0, Bc = _tentative_prolongation(agg, n_agg, B)
                P = (P0 - (self.omega / rho) * (sp.diags(1.0 / d) @ (A @ P0))).tocsr()
                R = P.T.tocsr()
                t = self._tick("smooth_p", t)
                A_next = (R @ (A @ P)).tocsr()
                t = self._tick("rap", t)
            host.append((A, P, R, d, float(rho)))
            A = A_next
            A.eliminate_zeros()
            B = Bc
        if keep_host:
            self.host_levels = host
            self.host_coarse = A.toarray()
        return self._install(host, A.toarray(), A.nnz, device)

    def _install(self, host, coarse, coarse_nnz, device):
        """The cycle's levels from host (A, P, R, diag, rho) CSR tuples and
        the dense coarse matrix: padded ELL arrays, the coarse LU (host,
        float64) and the float64 device copy."""
        t = _time.perf_counter()
        levels = []
        for A, P, R, d, rho in host:
            lvl = _Level()
            lvl.n, lvl.nc = A.shape[0], P.shape[1]
            lvl.A, lvl.P, lvl.R = _csr_to_ell(A), _csr_to_ell(P), _csr_to_ell(R)
            lvl.diag = np.asarray(d, np.float64)
            lvl.lmax = float(rho)
            lvl.dev = {}
            levels.append(lvl)
        t = self._tick("ell_upload", t)
        lu, piv = torch.linalg.lu_factor(torch.as_tensor(np.asarray(coarse, np.float64)))
        self._coarse = (lu.numpy(), piv.numpy())
        self._coarse_dev = {}
        self._levels = levels
        self._nnz_per_level = [int((l.A[1] != 0).sum()) for l in levels] + [int(coarse_nnz)]
        t = self._tick("coarse_lu", t)
        self._level_tensors(torch.float64, device)   # upload the float64 copy now
        self._tick("ell_upload", t)
        return self

    def setup_from_grid_operator(self, go, x_lin=None, time=0.0, keep_host=False,
                                 parts=None):
        """Assemble through the lattice-ELL path when the space qualifies
        (O(N * taps) memory), else through go.jacobian (sparse COO on the
        device, then a host CSR). assemble_ell's decline (None for a space
        without a DOF lattice, e.g. on a simplex mesh) takes the general
        path; no exception is caught. The cycle lives on x_lin's device
        (default: zeros in float64 on the constraint mask's device, else the
        default device). Adds `assemble` and `host_csr` to `setup_times`."""
        from dune_pdelab_tpu_torch.assembly.ell import assemble_ell, ell_to_csr
        from dune_pdelab_tpu_torch.assembly.gridoperator import sparse_to_csr

        if x_lin is None:
            dev = go.cg.mask.device if go.cg is not None else resolve_device(None)
            x_lin = torch.zeros(go.space.ndofs, dtype=torch.float64, device=dev)
        self.setup_times = {}
        t = _time.perf_counter()
        ell = assemble_ell(go, x_lin, time)
        if ell is not None:
            _sync(x_lin.device)
            t = self._tick("assemble", t)
            A = ell_to_csr(ell)
        else:
            J = go.jacobian(x_lin, time)
            _sync(x_lin.device)
            t = self._tick("assemble", t)
            A = sparse_to_csr(J)
            del J
        self._tick("host_csr", t)
        return self.setup_from_csr(A, keep_host=keep_host, parts=parts, device=x_lin.device)

    @classmethod
    def from_csr(cls, A, **kw):
        return cls(**kw).setup_from_csr(A)

    # -- device tensors --------------------------------------------------------
    def _level_tensors(self, dtype, device):
        """Per level (A_cols, A_vals, diag, P_cols, P_vals, R_cols, R_vals,
        lmax) on `device` in `dtype`, and the coarse (LU, pivots); built once
        per (dtype, device)."""
        key = (dtype, device_key(device))
        out = []
        for lvl in self._levels:
            if key not in lvl.dev:
                def t(a, dt=dtype):
                    return torch.as_tensor(a, dtype=dt, device=device)
                lvl.dev[key] = (t(lvl.A[0], torch.int64), t(lvl.A[1]), t(lvl.diag),
                                t(lvl.P[0], torch.int64), t(lvl.P[1]),
                                t(lvl.R[0], torch.int64), t(lvl.R[1]), lvl.lmax)
            out.append(lvl.dev[key])
        if key not in self._coarse_dev:
            lu, piv = self._coarse
            self._coarse_dev[key] = (torch.as_tensor(lu, dtype=dtype, device=device),
                                     torch.as_tensor(piv, device=device))
        return out, self._coarse_dev[key]

    # -- V-cycle ---------------------------------------------------------------
    def _smooth(self, lv, x, r, steps):
        """`steps` sweeps from x; x None stands for zero (its residual is r,
        so the first sweep skips an SpMV of zeros; same values)."""
        Ac, Av, diag, lmax = lv[0], lv[1], lv[2], lv[7]
        if self.smoother == "chebyshev":
            from dune_pdelab_tpu_torch.linalg import preconditioners
            cheb = preconditioners.chebyshev(lambda z: _ell_apply(Ac, Av, z), diag,
                                             lmax, degree=self.cheby_degree)
            for _ in range(steps):
                x = cheb(r) if x is None else x + cheb(r - _ell_apply(Ac, Av, x))
            return x
        wj = self.jacobi_damping
        for _ in range(steps):
            x = (wj * r / diag if x is None
                 else x + wj * (r - _ell_apply(Ac, Av, x)) / diag)
        return x

    def _vcycle(self, levels, coarse, l, r):
        if l == len(levels):
            lu, piv = coarse
            return torch.linalg.lu_solve(lu, piv, r[:, None])[:, 0]
        lv = levels[l]
        x = self._smooth(lv, None, r, self.presmooth)
        res = r if x is None else r - _ell_apply(lv[0], lv[1], x)
        xc = self._vcycle(levels, coarse, l + 1, _ell_apply(lv[5], lv[6], res))
        xp = _ell_apply(lv[3], lv[4], xc)
        x = xp if x is None else x + xp
        return self._smooth(lv, x, r, self.postsmooth)

    def apply(self, r):
        """One V-cycle on r, in r's dtype on r's device."""
        if self._levels is None:
            raise RuntimeError("AlgebraicMultigrid: set up first "
                               "(setup_from_csr / setup_from_grid_operator)")
        levels, coarse = self._level_tensors(r.dtype, r.device)
        return self._vcycle(levels, coarse, 0, r)

    def __call__(self, go_or_r, x_lin=None, time=0.0):
        """Dual calling convention: as a LinearSolverBackend precond factory
        `(go, x_lin, time)`, or, once set up, directly on a residual."""
        if hasattr(go_or_r, "jacobian_apply") or hasattr(go_or_r, "space"):
            # linear operator: one hierarchy serves every solve; nonlinear:
            # rebuilt per linearization point
            key = ((id(go_or_r), float(time))
                   if getattr(go_or_r.lop, "is_linear", False) else object())
            if self._levels is None or self._setup_key != key:
                xl = None if x_lin is None else x_lin.to(torch.float64)
                self.setup_from_grid_operator(go_or_r, xl, time)
                self._setup_key = key
            return self.apply
        return self.apply(go_or_r)

    # -- diagnostics -----------------------------------------------------------
    def hierarchy_info(self):
        """Per-level (n, nnz) + operator complexity (sum nnz / fine nnz)."""
        sizes = [l.n for l in self._levels] + [int(self._coarse[0].shape[0])]
        nnz = self._nnz_per_level
        return {"sizes": sizes, "nnz": nnz,
                "operator_complexity": float(sum(nnz)) / max(nnz[0], 1)}

    def setup_parts_report(self, target_n=None):
        """Distributed-setup accounting (after setup_from_csr(parts=p)):
        measured per-block setup walls per level, the critical path (max
        block per level, summed), and an O(N)-extrapolated wall for
        `target_n` rows on the same per-row rate."""
        if not getattr(self, "setup_part_walls", None):
            return None
        crit = sum(max(w) for w in self.setup_part_walls)
        total = sum(sum(w) for w in self.setup_part_walls)
        n0 = self._levels[0].n if self._levels else 0
        rep = {"parts": self.setup_parts, "critical_path_s": crit,
               "serial_equivalent_s": total,
               "parallel_efficiency": total / (crit * self.setup_parts) if crit else 0.0}
        if target_n and n0:
            rep["extrapolated_critical_path_s_at_target"] = crit * target_n / n0
            rep["target_n"] = target_n
        return rep
