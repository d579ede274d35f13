"""Geometric multigrid on structured mesh hierarchies.

PyTorch port of dune_pdelab_tpu/linalg/multigrid.py (the geometric
replacement of the reference's AMG backends, dune/pdelab/backend/istl/
seqistlsolverbackend.hh AMG combinations). The hierarchy is explicit,
mesh.coarsen(2) per level, so

  * level operators are re-discretisations on the general GridOperator
    (not Galerkin products); every level apply is `go.jacobian_apply`
    (torch.func.jvp), as in the reference;
  * transfers are FE interpolation (`build_prolongation`). Prolongation
    gathers the m coarse values of each fine DOF; restriction gathers
    through the transpose map, built once per level, so both are sums in
    a fixed order and give the same bits on every run (the reference's
    scatter-add is an atomic add on the card);
  * smoothing is damped Jacobi or Chebyshev; the coarsest level is a dense
    LU (torch.linalg.lu_factor on the level's device).

`_transfer_1d` (the 1D Lagrange prolongation) also feeds the lattice
multigrids (linalg/gmg_lattice.py, linalg/gmg_varcoeff.py). There is no
jit: the V-cycle runs eagerly.
"""
from __future__ import annotations

import numpy as np
import torch

from dune_pdelab_tpu_torch.fe.basis import (
    _lagrange_coeffs, _poly_eval, lagrange_nodes_1d,
)
from dune_pdelab_tpu_torch.utils.common import (
    default_float, full_fp32_on_cuda, resolve_device,
)


def _transfer_1d(k: int, nc: int, periodic: bool):
    """1D prolongation map from a coarse Qk DOF line (nc cells) to the
    2x-refined fine line: per fine DOF, (k+1) coarse indices + weights."""
    nodes = lagrange_nodes_1d(k)
    C = _lagrange_coeffs(nodes)
    nfd = 2 * k * nc if periodic else 2 * k * nc + 1
    ncd = k * nc if periodic else k * nc + 1
    gf = np.arange(nfd)
    s = gf / (2.0 * k)                      # position in coarse-element units
    e = np.minimum(np.floor(s + 1e-12).astype(int), nc - 1)
    xi = s - e
    vals, _ = _poly_eval(C, xi)             # (nfd, k+1)
    idx = k * e[:, None] + np.arange(k + 1)[None, :]
    if periodic:
        idx = idx % ncd
    return idx.astype(np.int64), vals, nfd, ncd


def build_prolongation(coarse_space, fine_space):
    """(NF, m) coarse-DOF indices (int32) and interpolation weights with
    fine = sum_j w[f, j] * coarse[idx[f, j]]."""
    meshc, meshf = coarse_space.mesh, fine_space.mesh
    k = fine_space.fem.degree
    dim = meshf.dim
    I1, W1, nfd, strides = [], [], [], []
    stride = 1
    for d in range(dim):
        idx, w, nf_d, nc_d = _transfer_1d(k, meshc.cells[d], meshc.periodic[d])
        I1.append(idx)
        W1.append(w)
        nfd.append(nf_d)
        strides.append(stride)
        stride *= nc_d
    NF = int(np.prod(nfd))
    if NF != fine_space.ndofs or stride != coarse_space.ndofs:
        raise ValueError("the fine space is not the 2x refinement of the coarse one")
    g = np.arange(NF, dtype=np.int64)       # fine flat index, dim 0 fastest
    mi = np.empty((NF, dim), dtype=np.int64)
    for d in range(dim):
        mi[:, d] = g % nfd[d]
        g = g // nfd[d]
    idx = np.zeros((NF, 1), dtype=np.int64)
    w = np.ones((NF, 1))
    for d in range(dim):
        idx = (idx[:, :, None] + (I1[d][mi[:, d]] * strides[d])[:, None, :]
               ).reshape(NF, -1)
        w = (w[:, :, None] * W1[d][mi[:, d]][:, None, :]).reshape(NF, -1)
    return idx.astype(np.int32), w


def transpose_map(idx, w, ncoarse):
    """The gather form of P^T: (ridx, rw), (ncoarse, K) tensors on idx's
    device, with (P^T r)[c] = sum_t rw[c, t] * r[ridx[c, t]]. Entries of
    zero weight are dropped; within a row the fine indices ascend (the
    order of the reference's scatter); padding is index 0, weight 0."""
    nf, m = idx.shape
    keep = (w != 0).reshape(-1)
    c = idx.reshape(-1).to(torch.int64)[keep]
    f = torch.arange(nf, device=idx.device).repeat_interleave(m)[keep]
    wv = w.reshape(-1)[keep]
    c, order = torch.sort(c, stable=True)
    f, wv = f[order], wv[order]
    counts = torch.bincount(c, minlength=ncoarse)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(c.numel(), device=idx.device) - starts[c]
    K = int(counts.max())
    ridx = torch.zeros((ncoarse, K), dtype=torch.int64, device=idx.device)
    rw = torch.zeros((ncoarse, K), dtype=w.dtype, device=idx.device)
    ridx[c, pos] = f
    rw[c, pos] = wv
    return ridx, rw


def _gather_sum(v, idx, w):
    """out[i] = sum_t w[i, t] * v[idx[i, t]]: one gather and one reduction
    along t (fixed order, no atomics)."""
    return (w * v[idx]).sum(dim=1)


def _time_key(time):
    """Hashable identity of a solve 'time' (a float, or an opaque stage
    context such as instationary.StageContext)."""
    try:
        return float(time)
    except (TypeError, ValueError, RuntimeError):
        return object()   # no identity: always set up again (safe)


class GeometricMultigrid:
    """V/W-cycle multigrid preconditioner for operators on a structured
    Qk space. Usable directly as the `precond` callable of
    LinearSolverBackend.

    device: where the level operators and transfers live (default: the
    default device). power_v0: optional per-level start vectors of the
    Chebyshev power iteration (the reference draws them from jax.random;
    a test hands those in).
    """

    def __init__(self, lop, mesh, fem, bctype=None, nlevels=None,
                 pre_sweeps=2, post_sweeps=2, omega=0.67, cycle="v",
                 quad_order=None, coarsest_cells=2, smoother="jacobi",
                 device=None, power_v0=None):
        from dune_pdelab_tpu_torch.assembly.gridoperator import GridOperator
        from dune_pdelab_tpu_torch.constraints.dirichlet import (
            constraints as make_constraints,
        )
        from dune_pdelab_tpu_torch.space.space import FunctionSpace

        if smoother not in ("jacobi", "chebyshev"):
            raise ValueError(f"unknown smoother {smoother!r}")
        if cycle not in ("v", "w"):
            raise ValueError(f"unknown cycle {cycle!r}")
        self.lop = lop
        self.omega = omega
        self.pre = pre_sweeps
        self.post = post_sweeps
        self.cycle = cycle
        # chebyshev: polynomial smoothing on [lmax/4, lmax] per level; the
        # sweep counts become the polynomial degree
        self.smoother = smoother
        self.device = resolve_device(device)
        self.power_v0 = power_v0
        meshes = [mesh]
        while nlevels is None or len(meshes) < nlevels:
            m = meshes[-1]
            if any(c % 2 or c < 2 * coarsest_cells for c in m.cells):
                break
            meshes.append(m.coarsen(2))
        self.meshes = meshes            # fine -> coarse
        self.spaces = [FunctionSpace(m, fem) for m in meshes]
        self.cgs = [make_constraints(bctype, s, device=self.device)
                    if bctype is not None else None for s in self.spaces]
        self.gos = [GridOperator(s, lop, constraints=c, quad_order=quad_order)
                    for s, c in zip(self.spaces, self.cgs)]
        # transfers[l]: coarse level l+1 -> fine level l, as numpy (idx, w)
        self.transfers = [build_prolongation(self.spaces[l + 1], self.spaces[l])
                          for l in range(len(meshes) - 1)]
        self._maps = None
        self._apply = None
        self._setup_key = None

    @property
    def nlevels(self):
        return len(self.meshes)

    # -- setup ----------------------------------------------------------------
    def _level_maps(self, dtype):
        """Per level (idx, w, ridx, rw) on the device in `dtype`; the
        transpose maps are built once, the weights cast per dtype."""
        if self._maps is None:
            self._maps = []
            for l, (idx, w) in enumerate(self.transfers):
                ti = torch.as_tensor(idx, dtype=torch.int64, device=self.device)
                tw = torch.as_tensor(w, dtype=torch.float64, device=self.device)
                ridx, rw = transpose_map(ti, tw, self.spaces[l + 1].ndofs)
                self._maps.append((ti, tw, ridx, rw))
        return [(i, w.to(dtype), ri, rw.to(dtype)) for i, w, ri, rw in self._maps]

    def setup(self, x_lin=None, time=0.0, dtype=None):
        """Level diagonals, Chebyshev bounds and the dense coarse LU at the
        linearization point x_lin (default: zeros of `dtype` on the
        device); the coarse levels' states are the fine state restricted
        by P^T scaled with its row sums."""
        if self.device.type == "cuda":
            full_fp32_on_cuda()
        L = self.nlevels
        if x_lin is None:
            x_lin = torch.zeros(self.spaces[0].ndofs, dtype=dtype or default_float(),
                                device=self.device)
        x_lin = x_lin.to(self.device)
        maps = self._level_maps(x_lin.dtype)
        xs = [x_lin]
        for l in range(L - 1):
            _, _, ridx, rw = maps[l]
            wsum = rw.sum(dim=1)
            xs.append(_gather_sum(xs[l], ridx, rw)
                      / torch.clamp(wsum, min=torch.finfo(wsum.dtype).tiny))
        self._xs = xs
        self._time = time
        self._diags = [go.jacobian_diagonal(x, time) for go, x in zip(self.gos, xs)]
        if self.smoother == "chebyshev":
            from dune_pdelab_tpu_torch.linalg.preconditioners import power_iteration
            v0s = self.power_v0 or [None] * L
            self._lmax = [
                power_iteration(lambda z, go=go, x=x: go.jacobian_apply(x, z, time),
                                d, s.ndofs, dtype=d.dtype, v0=v0)
                for go, x, d, s, v0 in zip(self.gos, xs, self._diags, self.spaces, v0s)]
        Ac = self.gos[-1].jacobian(xs[-1], time).to_dense()
        self._coarse_lu = torch.linalg.lu_factor(Ac)
        self._build_apply(maps)

    def _build_apply(self, maps):
        L = self.nlevels
        gos, diags, xs, time = self.gos, self._diags, self._xs, self._time
        omega = self.omega
        masks = [None if c is None else c.mask_on(self.device) for c in self.cgs]
        lu, piv = self._coarse_lu

        def A(l, z):
            return gos[l].jacobian_apply(xs[l], z, time)

        if self.smoother == "chebyshev":
            from dune_pdelab_tpu_torch.linalg.preconditioners import chebyshev
            chebs = [chebyshev(lambda z, l=l: A(l, z), diags[l], self._lmax[l],
                               lambda_min_ratio=0.25, degree=max(self.pre, self.post))
                     for l in range(L)]

            def smooth(l, z, r, sweeps):
                z = z + chebs[l](r - A(l, z))
                if masks[l] is not None:
                    z = torch.where(masks[l], r, z)
                return z
        else:
            def smooth(l, z, r, sweeps):
                for _ in range(sweeps):
                    z = z + omega * (r - A(l, z)) / diags[l]
                    if masks[l] is not None:
                        z = torch.where(masks[l], r, z)   # constrained: unit diag
                return z

        def cycle(l, r):
            if l == L - 1:
                return torch.linalg.lu_solve(lu, piv, r[:, None])[:, 0]
            idx, w, ridx, rw = maps[l]
            z = smooth(l, torch.zeros_like(r), r, self.pre)
            rc = _gather_sum(r - A(l, z), ridx, rw)
            if masks[l + 1] is not None:
                rc = torch.where(masks[l + 1], 0.0, rc)
            zc = cycle(l + 1, rc)
            if self.cycle == "w" and l + 1 < L - 1:
                zc = zc + cycle(l + 1, rc - A(l + 1, zc))
            corr = _gather_sum(zc, idx, w)
            if masks[l] is not None:
                corr = torch.where(masks[l], 0.0, corr)
            return smooth(l, z + corr, r, self.post)

        self._apply = lambda r: cycle(0, r)

    # -- preconditioner protocol ---------------------------------------------
    def __call__(self, go, x_lin, time):
        """LinearSolverBackend `precond` callable: (go, x_lin, time) -> M.

        Setup is cached per linearization point: a linear operator sets up
        once per dtype; a nonlinear one again whenever x_lin's values or
        the time change (a non-float time such as a StageContext always
        sets up again)."""
        linear = getattr(self.lop, "is_linear", False)
        key_x = None if x_lin is None else (
            tuple(x_lin.shape), x_lin.dtype,
            0 if linear else hash(x_lin.detach().cpu().numpy().tobytes()))
        key = (key_x, None if linear else _time_key(time))
        if self._apply is None or self._setup_key != key:
            self.setup(x_lin, time)
            self._setup_key = key
        return self._apply

    def apply(self, r):
        """One cycle on r (set up at zeros of r's dtype on first use)."""
        if self._apply is None:
            self.setup(dtype=r.dtype)
        return self._apply(r)
