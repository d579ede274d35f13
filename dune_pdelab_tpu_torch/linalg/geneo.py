"""GenEO-style spectral two-level overlapping Schwarz preconditioner.

PyTorch port of dune_pdelab_tpu/linalg/geneo.py (reference: the GenEO stack
of dune/pdelab/backend/istl/geneo/: partition of unity
partitionofunity.hh, per-subdomain generalized eigenproblems
geneobasis.hh:22, Galerkin coarse matrix subdomainprojectedcoarsespace.hh:27,
TwoLevelOverlappingAdditiveSchwarz two_level_schwarz.hh:18).

    M r = Z A0^{-1} Z^T r + sum_i R_i^T A_i^{-1} R_i r

Two implementations:
  * `GenEOPreconditioner`: the dense variant. The set-up eigenproblems run
    on the host (scipy eigh per subdomain, as in the reference); the padded
    (nsub, m, m) local matrices are LU-factorised as one batch on the
    device, and an apply is one batched lu_solve plus the coarse solve;
  * `GenEOLatticePreconditioner`: for lattice-ELL operators. The local
    solves are lattice ILU(0) sweeps batched over the subdomains (the boxes
    stacked along an extra slowest lattice axis, linalg/ilu.py EllILU0);
    the set-up eigenproblems are sparse shift-invert ARPACK (scipy eigsh)
    on the host; the coarse basis is stored subdomain-sparse.

The coarse LUs are factorised on the host in float64
(torch.linalg.lu_factor: LAPACK's 1-based pivots); the overlapping sums of
an apply go through a transpose gather map (no atomics, the same sums on
every call).
"""
from __future__ import annotations

import itertools
import time as _time
from types import SimpleNamespace

import numpy as np
import torch

from dune_pdelab_tpu_torch.assembly.dofmaps import IndexDofMap
from dune_pdelab_tpu_torch.utils.common import resolve_device


def lattice_box_subdomains(grid_shape, nsub_axes, overlap: int, pou: str = "linear"):
    """Overlapping BOX subdomains of a DOF lattice with a product-hat
    partition of unity (the reference's rank-subdomain geometry,
    partitionofunity.hh). grid_shape is slowest-axis-first; returns
    (idx_list, chi_list) of flat index arrays / PU weights."""
    dim = len(grid_shape)
    nsub_axes = tuple(nsub_axes)
    assert len(nsub_axes) == dim
    ax_ranges, ax_hats = [], []
    for n, ns in zip(grid_shape, nsub_axes):
        base = n // ns
        rngs, hats = [], []
        for i in range(ns):
            lo = max(0, i * base - overlap)
            hi = min(n, ((i + 1) * base if i < ns - 1 else n) + overlap)
            idx = np.arange(lo, hi)
            chi = np.ones(len(idx))
            if pou == "linear":
                core_lo, core_hi = i * base, ((i + 1) * base if i < ns - 1 else n)
                below = idx < core_lo
                above = idx >= core_hi
                chi[below] = 1.0 - (core_lo - idx[below]) / (overlap + 1.0)
                chi[above] = 1.0 - (idx[above] - core_hi + 1) / (overlap + 1.0)
            rngs.append(idx)
            hats.append(chi)
        ax_ranges.append(rngs)
        ax_hats.append(hats)
    # strides of the flat C-order index (grid_shape is the array shape)
    strides = np.ones(dim, dtype=np.int64)
    for d in range(dim - 2, -1, -1):
        strides[d] = strides[d + 1] * grid_shape[d + 1]
    idx_list, chi_list = [], []
    for combo in itertools.product(*[range(ns) for ns in nsub_axes]):
        flat = np.zeros((1,), dtype=np.int64)
        chi = np.ones((1,))
        for d in range(dim):
            flat = (flat[:, None] + (ax_ranges[d][combo[d]] * strides[d])[None, :]).ravel()
            chi = (chi[:, None] * ax_hats[d][combo[d]][None, :]).ravel()
        idx_list.append(flat)
        chi_list.append(chi)
    return idx_list, chi_list


def _normalised_pou(idx_list, chi_list, N):
    """The partition of unity scaled to sum to 1 at every DOF."""
    den = np.zeros(N)
    for idx, chi in zip(idx_list, chi_list):
        den[idx] += chi
    return [chi / den[idx] for idx, chi in zip(idx_list, chi_list)]


def _coarse_lu(A0, device):
    """Host float64 LU of the (regularised) coarse matrix, on `device`."""
    lu, piv = torch.linalg.lu_factor(torch.as_tensor(A0 + 1e-12 * np.eye(A0.shape[0])))
    return lu.to(device), piv.to(device)


def _gen_eigh_smallest(A, B, nev):
    """Smallest-eigenpair solutions of A v = lambda B v (dense host scipy;
    the arpackpp_geneo.hh analog)."""
    import scipy.linalg as sla

    w, v = sla.eigh(A, B + 1e-12 * np.eye(len(B)))
    order = np.argsort(w)[:nev]
    return w[order], v[:, order]


class _Cast:
    """Float64 tensors of a preconditioner, cast once per (dtype, device) of
    the vectors it is applied to."""

    def __init__(self, **tensors):
        self._base = tensors
        self._memo = {}

    def get(self, ref):
        key = (ref.dtype, ref.device)
        if key not in self._memo:
            self._memo[key] = {k: (v.to(ref.device) if v.dtype in (torch.int32, torch.int64)
                                   or v.dtype == torch.bool else v.to(ref.device, ref.dtype))
                               for k, v in self._base.items()}
        return self._memo[key]


class GenEOPreconditioner:
    def __init__(self, A_dense, nsub: int = 0, overlap: int = 1, nev: int = 3,
                 pou: str = "linear", neumann: str = "rowsum", subdomains=None,
                 device=None):
        """A_dense: (N, N) assembled operator (scipy sparse, numpy or a
        dense tensor); nsub equal overlapping index slabs with `overlap`
        extra indices each side, or explicit `subdomains` (idx_list,
        chi_list) such as lattice_box_subdomains; nev eigenvectors per
        subdomain feed the coarse space. The apply runs on `device`
        (default: the default device).

        neumann: local matrices for the eigenproblem,
          'rowsum': diagonal corrected so local off-diagonal row sums are
                    kept (the exact Neumann matrix of an operator with a
                    constant kernel, e.g. diffusion; the coarse space then
                    holds the partition-of-unity constants),
          'dirichlet': plain submatrix (no kernel modes; not scalable).
        """
        import scipy.sparse as sp

        device = resolve_device(device)
        if isinstance(A_dense, torch.Tensor):
            A_dense = A_dense.detach().cpu().numpy()
        sparse = sp.issparse(A_dense)
        A = A_dense.tocsr() if sparse else np.asarray(A_dense)
        N = A.shape[0]
        self.N = N
        if subdomains is not None:
            idx_list = [np.asarray(ix, np.int64) for ix in subdomains[0]]
            chi_list = [np.asarray(c, np.float64) for c in subdomains[1]]
            nsub = len(idx_list)
        else:
            base = N // nsub
            assert base * nsub == N, "N must be divisible by nsub"
            idx_list, chi_list = [], []
            for i in range(nsub):
                idx = np.arange(max(0, i * base - overlap), min(N, (i + 1) * base + overlap))
                chi = np.ones(len(idx))
                if pou == "linear":
                    # linear partition-of-unity hat over the overlap region
                    for j, g in enumerate(idx):
                        if g < i * base:
                            chi[j] = 1.0 - (i * base - g) / (overlap + 1.0)
                        elif g >= (i + 1) * base:
                            chi[j] = 1.0 - (g - (i + 1) * base + 1) / (overlap + 1.0)
                idx_list.append(idx)
                chi_list.append(chi)
        chi_list = _normalised_pou(idx_list, chi_list, N)

        # pad to equal subdomain size for batching
        m = max(len(ix) for ix in idx_list)
        self.m = m
        sub_idx = np.zeros((nsub, m), dtype=np.int64)
        sub_mask = np.zeros((nsub, m))
        sub_chi = np.zeros((nsub, m))
        A_loc = np.zeros((nsub, m, m))
        for i, (idx, chi) in enumerate(zip(idx_list, chi_list)):
            k = len(idx)
            sub_idx[i, :k] = idx
            sub_mask[i, :k] = 1.0
            sub_chi[i, :k] = chi
            A_loc[i, :k, :k] = A[idx][:, idx].toarray() if sparse else A[np.ix_(idx, idx)]
            # identity on padding keeps the factorisations nonsingular
            A_loc[i, np.arange(k, m), np.arange(k, m)] = 1.0

        # GenEO eigenproblem on the NEUMANN local matrix:
        #   A_i^Neu v = lambda (X_i A_i^Neu X_i) v,  X = diag(chi);
        # the smallest-lambda modes weighted by the PU form the coarse space
        basis = []
        for i in range(nsub):
            k = len(idx_list[i])
            Ai = A_loc[i, :k, :k]
            if neumann == "rowsum":
                An = Ai.copy()
                np.fill_diagonal(An, 0.0)
                np.fill_diagonal(An, -An.sum(axis=1))
            else:
                An = Ai
            X = np.diag(sub_chi[i, :k])
            B = X @ An @ X
            # regularise: B is singular where chi -> 0 and on kernel modes
            reg = 1e-10 * max(1.0, np.abs(An).max())
            _, v = _gen_eigh_smallest(An + reg * np.eye(k), B + reg * np.eye(k), nev)
            for j in range(v.shape[1]):
                z = np.zeros(N)
                z[idx_list[i]] = sub_chi[i, :k] * v[:, j]
                basis.append(z)
        Z = np.stack(basis, axis=1)                       # (N, ncoarse)
        A0 = Z.T @ (A @ Z)
        lu_loc, piv_loc = torch.linalg.lu_factor(torch.as_tensor(A_loc, device=device))
        lu0, piv0 = _coarse_lu(A0, device)
        self.ncoarse = Z.shape[1]
        self.sub_idx = torch.as_tensor(sub_idx, device=device)
        self._sum = IndexDofMap.of_tensor(self.sub_idx)
        self._t = _Cast(Z=torch.as_tensor(Z, device=device), lu0=lu0, piv0=piv0,
                        lu_loc=lu_loc, piv_loc=piv_loc,
                        mask=torch.as_tensor(sub_mask, device=device))

    def __call__(self, r):
        t = self._t.get(r)
        # coarse: Z A0^{-1} Z^T r; local: sum_i R_i^T A_i^{-1} R_i r
        zc = torch.linalg.lu_solve(t["lu0"], t["piv0"], (t["Z"].T @ r)[:, None])[:, 0]
        r_loc = r[self.sub_idx] * t["mask"]                       # (nsub, m)
        z_loc = torch.linalg.lu_solve(t["lu_loc"], t["piv_loc"], r_loc[..., None])[..., 0]
        return self._sum.scatter_add(t["Z"] @ zc, z_loc * t["mask"])


class GenEOLatticePreconditioner:
    """GenEO on a lattice-ELL operator with no dense (m, m) local operator:

      * subdomains = overlapping lattice boxes (equal padded shape);
      * local solves = the Chow-Patel lattice ILU(0) (linalg/ilu.py),
        batched over subdomains: the boxes are stacked along an extra
        slowest lattice axis whose tap offsets are all 0, so one EllILU0
        covers every subdomain with shift-MACs;
      * set-up eigenproblems = sparse shift-invert Lanczos (scipy eigsh,
        the reference's arpackpp_geneo.hh route) on the local CSR Neumann
        matrices, on the host;
      * the coarse basis Z is stored subdomain-sparse ((nsub, nev, m) values
        + index map); A0 = Z^T A Z through the ELL apply on the device.

    `setup_times` holds the host seconds of: extract (box values and local
    CSRs), eigsh, ilu (the batched factorisation), coarse (A0 and its LU).
    Reference: geneobasis.hh:22, subdomainprojectedcoarsespace.hh:27,
    two_level_schwarz.hh:18.
    """

    def __init__(self, ell, boxes, overlap=2, nev=3, sweeps=8, tri_iters=6,
                 neumann: str = "rowsum"):
        # high-contrast operators need more Chow-Patel fixed-point sweeps and
        # truncated-triangular terms than the EllILU0 defaults
        import scipy.sparse as sp
        import scipy.sparse.linalg as spla

        from dune_pdelab_tpu_torch.linalg.ilu import EllILU0

        self.setup_times = {"extract": 0.0, "eigsh": 0.0, "ilu": 0.0, "coarse": 0.0}
        t = _time.perf_counter()
        device = ell.values.device
        grid_shape = ell.grid_shape            # slowest axis first
        dim = len(grid_shape)
        N = int(np.prod(grid_shape))
        self.N = N
        idx_list, chi_list = lattice_box_subdomains(grid_shape, boxes, overlap)
        nsub = len(idx_list)
        chi_list = _normalised_pou(idx_list, chi_list, N)

        # equal box shape: per-axis maximum extent over subdomains
        box = tuple(min(grid_shape[d],
                        grid_shape[d] // boxes[d] + 2 * overlap + (grid_shape[d] % boxes[d]))
                    for d in range(dim))
        m = int(np.prod(box))
        self.m = m

        vals_np = ell.values.detach().to("cpu", torch.float64).numpy()   # (ntaps, *grid)
        ntaps = vals_np.shape[0]
        offsets = np.asarray(ell.offsets)               # (ntaps, dim) dim 0 fastest
        sub_vals = np.zeros((ntaps, nsub) + box)
        sub_idx = np.zeros((nsub, m), np.int64)
        sub_mask = np.zeros((nsub, m))
        diag_t = int(np.nonzero((offsets == 0).all(axis=1))[0][0])
        gstr = np.ones(dim, np.int64)
        for d in range(dim - 2, -1, -1):
            gstr[d] = gstr[d + 1] * grid_shape[d + 1]
        bstr = np.ones(dim, np.int64)
        for d in range(dim - 2, -1, -1):
            bstr[d] = bstr[d + 1] * box[d + 1]
        basis_rows = []
        for i, (gidx, chi) in enumerate(zip(idx_list, chi_list)):
            t = self._tick("extract", t)
            mi = np.stack(np.unravel_index(gidx, grid_shape), axis=1)
            lo = mi.min(axis=0)
            ext = mi.max(axis=0) - lo + 1
            sl = tuple(slice(lo[d], lo[d] + ext[d]) for d in range(dim))
            bsl = tuple(slice(0, ext[d]) for d in range(dim))
            for tp in range(ntaps):
                sub_vals[(tp, i) + bsl] = vals_np[(tp,) + sl]
            # box-local flat indices of the true rows, C-order over `box`
            lflat = (mi - lo[None, :]) @ bstr
            sub_idx[i, lflat] = gidx
            sub_mask[i, lflat] = 1.0
            # identity rows on padding
            pad = np.ones(box, bool)
            pad[bsl] = False
            sub_vals[diag_t, i][pad] = 1.0

            # local CSR of the global values restricted to this subdomain's
            # TRUE rows (couplings leaving the subdomain dropped)
            gset = np.full(N, -1, np.int64)
            gset[gidx] = np.arange(len(gidx))
            rows, cols, data = [], [], []
            for tp in range(ntaps):
                tgt = mi + offsets[tp][::-1][None, :]          # grid-axis order
                ok = np.all((tgt >= 0) & (tgt < np.asarray(grid_shape)[None]), axis=1)
                tflat = np.clip(tgt, 0, None) @ gstr
                lcol = np.where(ok, gset[np.clip(tflat, 0, N - 1)], -1)
                keep = lcol >= 0
                rows.append(np.arange(len(gidx))[keep])
                cols.append(lcol[keep])
                data.append(vals_np[tp].reshape(-1)[gidx][keep])
            k = len(gidx)
            Ai = sp.csr_matrix((np.concatenate(data),
                                (np.concatenate(rows), np.concatenate(cols))), shape=(k, k))
            if neumann == "rowsum":
                d0 = np.asarray(Ai.diagonal())
                offsum = np.asarray(Ai.sum(axis=1)).ravel() - d0
                An = Ai - sp.diags(d0) - sp.diags(offsum)
            else:
                An = Ai
            X = sp.diags(chi)
            Bm = (X @ An @ X).tocsc()
            reg = 1e-10 * max(1.0, abs(An).max())
            An_r = (An + reg * sp.eye(k)).tocsc()
            B_r = (Bm + reg * sp.eye(k)).tocsc()
            kreq = min(nev, k - 2)
            t = self._tick("extract", t)
            try:
                w, v = spla.eigsh(An_r, k=kreq, M=B_r, sigma=0.0, which="LM")
            except (spla.ArpackError, RuntimeError):
                # the reference's dense fallback when ARPACK fails
                import scipy.linalg as sla
                wd, vd = sla.eigh(An_r.toarray(), B_r.toarray())
                order = np.argsort(wd)[:kreq]
                w, v = wd[order], vd[:, order]
            t = self._tick("eigsh", t)
            vb = np.zeros((nev, m))
            for j in range(v.shape[1]):
                vb[j, lflat] = chi * v[:, j]
            basis_rows.append(vb)

        Zv = np.stack(basis_rows)                       # (nsub, nev, m)
        self.ncoarse = nsub * nev
        self.sub_idx = torch.as_tensor(sub_idx, device=device)
        self._sum = IndexDofMap.of_tensor(self.sub_idx)

        # batched local ILU: boxes stacked on an extra slowest axis with
        # zero tap offsets (not an EllMatrix: the ell27 kernel's 3D tap
        # order does not apply to a stacked 2D lattice)
        t = self._tick("extract", t)
        st = SimpleNamespace(
            dims=tuple(reversed(box)) + (nsub,), k=ell.k,
            offsets=np.concatenate([offsets, np.zeros((ntaps, 1), offsets.dtype)], axis=1),
            values=torch.as_tensor(sub_vals, dtype=ell.values.dtype, device=device),
            mask=torch.as_tensor((sub_mask == 0).reshape(-1), device=device))
        self._ilu = EllILU0(st, sweeps=sweeps, tri_iters=tri_iters)
        t = self._tick("ilu", t)

        # coarse matrix A0 = Z^T A Z via the ELL apply on the device
        Zfull = np.zeros((self.ncoarse, N))
        for i in range(nsub):
            for j in range(nev):
                np.add.at(Zfull[i * nev + j], sub_idx[i], Zv[i, j] * sub_mask[i])
        Zt = torch.as_tensor(Zfull, dtype=ell.values.dtype, device=device)
        AZ = torch.stack([ell(z) for z in Zt]).to("cpu", torch.float64).numpy()
        A0 = Zfull @ AZ.T
        lu0, piv0 = _coarse_lu(A0, device)
        self._t = _Cast(Zv=torch.as_tensor(Zv, device=device), lu0=lu0, piv0=piv0,
                        mask=torch.as_tensor(sub_mask, device=device))
        self._tick("coarse", t)

    def _tick(self, key, t0):
        self.setup_times[key] += _time.perf_counter() - t0
        return _time.perf_counter()

    def __call__(self, r):
        t = self._t.get(r)
        Zv, mask = t["Zv"], t["mask"]
        # coarse correction: Z A0^{-1} Z^T r (subdomain-sparse Z)
        r_loc = r[self.sub_idx] * mask                       # (nsub, m)
        rc = torch.einsum("sjm,sm->sj", Zv, r_loc).reshape(-1)
        zc = torch.linalg.lu_solve(t["lu0"], t["piv0"], rc[:, None])[:, 0]
        z_c = torch.einsum("sjm,sj->sm", Zv, zc.reshape(Zv.shape[0], Zv.shape[1])) * mask
        # local ILU solves, batched over the stacked-box lattice
        z_ilu = self._ilu(r_loc.reshape(-1).to(self._ilu.vals.dtype))
        z_ilu = z_ilu.reshape(r_loc.shape).to(r.dtype) * mask
        return self._sum.scatter_add(torch.zeros_like(r), z_c + z_ilu)


def geneo_preconditioner_for(go, x_lin=None, nsub=4, overlap=None, nev=3, time=0.0,
                             boxes=None, method="dense"):
    """Assemble the operator and build GenEO for a GridOperator.

    Lattice Qk spaces: lattice-ELL assembly (O(N * taps) memory) and
    overlapping BOX subdomains with a product-hat PU; `boxes` = per-axis
    subdomain counts (slowest axis first; default: the slowest axis split
    into `nsub`), method='ilu' the GenEOLatticePreconditioner. Other spaces
    (assemble_ell declines, e.g. on a simplex mesh; no exception is caught)
    take the sparse Jacobian (go.jacobian_csr) and 1D index slabs. The
    preconditioner lives on x_lin's device (default: zeros in float64 on the
    constraint mask's device)."""
    from dune_pdelab_tpu_torch.assembly.ell import assemble_ell, ell_to_csr

    if x_lin is None:
        dev = go.cg.mask.device if go.cg is not None else resolve_device(None)
        x_lin = torch.zeros(go.space.ndofs, dtype=torch.float64, device=dev)
    ell = assemble_ell(go, x_lin, time)
    if ell is not None:
        grid_shape = ell.grid_shape
        if boxes is None:
            boxes = (nsub,) + (1,) * (len(grid_shape) - 1)
        if overlap is None:
            overlap = max(1, grid_shape[0] // max(boxes[0], 1) // 4)
        if method == "ilu":
            return GenEOLatticePreconditioner(ell, boxes, overlap=overlap, nev=nev)
        subs = lattice_box_subdomains(grid_shape, boxes, overlap)
        return GenEOPreconditioner(ell_to_csr(ell), nev=nev, subdomains=subs,
                                   device=x_lin.device)
    A = go.jacobian_csr(x_lin, time)
    N = A.shape[0]
    if N % nsub:
        raise ValueError(f"ndofs {N} not divisible by nsub {nsub}")
    overlap = overlap if overlap is not None else max(1, N // nsub // 8)
    return GenEOPreconditioner(A, nsub, overlap, nev=nev, device=x_lin.device)
