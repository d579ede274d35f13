"""DOF-sharded stencil operator: lattice decomposition + halo exchange.

PyTorch port of dune_pdelab_tpu/parallel/dofsharded.py. The DOF lattice is
split over a 1D or 2D mesh of ranks along its slowest axes; every apply
exchanges k halo planes per sharded axis with the neighbouring ranks (the
analog of the reference's nonoverlapping matrix-consistency scheme,
dune/pdelab/backend/istl/novlpistlsolverbackend.hh:96: the coupling is
(2k+1)^d-local, so neighbour exchanges are all the communication).

Generality as in the reference: any order k (Qk residue classes), lattice
dims that do not divide the rank count (zero-padded at the top of each
sharded axis to a multiple of nranks_axis * k, exact because the
sequential operator zero-pads beyond the lattice too), and a 2D rank mesh
with a corner-correct two-stage exchange (the slowest axis first, then the
second axis of the already extended block, which carries the diagonal
neighbours' corners).

The local apply. A 3D k = 1 single-class stencil (StencilOperator's
`uses_stencil27`) runs the stencil27 kernel (K2; its plain version for a
CPU tensor) on the rank's halo-extended block with the global mask sliced
to that block, and keeps the interior: K2 reads zeros outside the block it
is given, which touches only the discarded halo rows. Every other case runs
StencilOperator's plain form (`_apply_impl`) on the halo-extended block of
the masked vector. Either way each interior point sees the values and the
order of sums of the sequential operator.

Vectors are rank-local blocks of the zero-padded lattice (slowest axis
first); `device_put(x_flat)` cuts this rank's block out of a full vector,
`gather(block)` all-gathers the full vector on every rank. Padded rows are
"constrained to zero" (mask True, value 0), so they never perturb a dot.
Krylov dots are the group's reproducible global dots (`Comm.dot`).

Process model: parallel/__init__.py. On a single rank the exchange is
empty; an apply communicates only when a neighbour exists, so a one-rank
group's apply can be captured into a CUDA graph, and any other group's
cannot (`Comm.refuse_capture`).
"""
from __future__ import annotations

import numpy as np
import torch

from dune_pdelab_tpu_torch.assembly.stencil import StencilOperator
from dune_pdelab_tpu_torch.kernels.stencil27 import stencil27
from dune_pdelab_tpu_torch.parallel.comm import Comm, group_of, rank_device
from dune_pdelab_tpu_torch.space.space import to_numpy


def _ceil_to(n, m):
    return -(-n // m) * m


def _planes(t, axis, start, stop):
    idx = [slice(None)] * t.ndim
    idx[axis] = slice(start, stop)
    return t[tuple(idx)]


class DofShardedStencil:
    """Sharded y = mask ? z : stencil(z) on rank-local lattice blocks.

    stencil_op: a StencilOperator (assembly/stencil.py). devices / group: the
    process group (default: the world group; `devices` may be a group, the
    reference's argument name). mesh_shape: the rank mesh over the slowest
    lattice axes (default (nranks,)); its product must be the group size.
    padded_shape: caller-enforced padding of the sharded axes (2:1 level
    alignment in parallel/gmg_sharded.py). device: this rank's device
    (default: parallel.comm.rank_device()).
    """

    def __init__(self, stencil_op, devices=None, mesh_shape=None,
                 axis_names=("sz", "sy"), padded_shape=None, group=None, device=None):
        st = stencil_op
        self.st = st
        self.group = group_of(devices, group)
        self.comm = Comm(self.group)
        self.device = rank_device(device)
        dims = tuple(st.dims)                   # dim0 fastest
        dim = len(dims)
        k = st.k
        self.k = k
        if mesh_shape is None:
            mesh_shape = (self.comm.size,)
        if len(mesh_shape) not in (1, 2) or len(mesh_shape) > dim - (dim > 1):
            raise ValueError(f"unsupported rank mesh shape {mesh_shape}")
        if int(np.prod(mesh_shape)) != self.comm.size:
            raise ValueError(f"rank mesh {tuple(mesh_shape)} needs "
                             f"{int(np.prod(mesh_shape))} ranks, the group has "
                             f"{self.comm.size}")
        self.mesh_shape = tuple(int(m) for m in mesh_shape)
        self.axis_names = axis_names[:len(self.mesh_shape)]
        self.coords = tuple(int(c) for c in np.unravel_index(self.comm.rank,
                                                            self.mesh_shape))

        self.grid_shape = tuple(reversed(dims))        # (nz, ..., nx)
        padded = list(self.grid_shape)
        for a, nd_a in enumerate(self.mesh_shape):
            padded[a] = _ceil_to(padded[a], nd_a * k)
        if padded_shape is not None:
            for a, nd_a in enumerate(self.mesh_shape):
                p = int(padded_shape[a])
                if p < padded[a] or p % (nd_a * k):
                    raise ValueError(
                        f"padded_shape[{a}]={p} not a feasible multiple "
                        f"of nranks*k={nd_a * k} covering {padded[a]}")
                padded[a] = p
        self.padded_shape = tuple(padded)
        self.pad_amount = tuple(p - g for p, g in zip(self.padded_shape, self.grid_shape))
        self.local_shape = tuple(p // nd for p, nd in
                                 zip(self.padded_shape, self.mesh_shape)) + \
            self.padded_shape[len(self.mesh_shape):]
        self.lo = tuple(c * n for c, n in zip(self.coords, self.local_shape))

        # masks: padded rows are "constrained to 0"
        mask_np = (to_numpy(st.mask).reshape(self.grid_shape).astype(bool)
                   if st.mask is not None else np.zeros(self.grid_shape, bool))
        mask_pad = np.pad(mask_np, [(0, p) for p in self.pad_amount], constant_values=True)
        self.mask_grid = torch.as_tensor(self._block(mask_pad), device=self.device)
        self.uses_stencil27 = st.uses_stencil27
        if self.uses_stencil27:
            # the halo-extended block of the mask (True beyond the lattice)
            ext = np.pad(mask_pad, [(1, 1)] * len(self.mesh_shape)
                         + [(0, 0)] * (dim - len(self.mesh_shape)), constant_values=True)
            sl = tuple(slice(lo, lo + n + 2) for lo, n in zip(self.lo, self.local_shape))
            self._ext_mask = torch.as_tensor(ext[sl].reshape(-1).copy(), device=self.device)
            self._ext_dims = tuple(reversed(
                tuple(n + 2 for n in self.local_shape[:len(self.mesh_shape)])
                + self.local_shape[len(self.mesh_shape):]))
        else:
            ext_shape = tuple(n + 2 * k for n in self.local_shape[:len(self.mesh_shape)]) + \
                self.local_shape[len(self.mesh_shape):]
            self._ext_op = StencilOperator(tuple(reversed(ext_shape)), k, st.weights,
                                           st.offsets, None, st.interior_classes)

    # -- flat <-> rank-local lattice blocks ---------------------------------
    def _block(self, g):
        """This rank's block of a padded (C-order) lattice array."""
        return g[tuple(slice(lo, lo + n) for lo, n in zip(self.lo, self.local_shape))]

    def device_put(self, x_flat):
        """This rank's block of the full flat (N,) vector x_flat."""
        x = torch.as_tensor(x_flat).to(self.device)
        g = x.reshape(self.grid_shape)
        g = torch.nn.functional.pad(
            g, [v for p in reversed(self.pad_amount) for v in (0, p)])
        return self._block(g).contiguous()

    def gather(self, xg):
        """The full flat (N,) vector from every rank's block, on every rank."""
        parts = self.comm.allgather(xg.contiguous())
        full = torch.zeros(self.padded_shape, dtype=xg.dtype, device=xg.device)
        for r, p in enumerate(parts):
            c = np.unravel_index(r, self.mesh_shape)
            sl = tuple(slice(int(ci) * n, (int(ci) + 1) * n)
                       for ci, n in zip(c, self.local_shape))
            full[sl] = p
        return full[tuple(slice(0, n) for n in self.grid_shape)].reshape(-1)

    def zeros(self, dtype=None):
        return torch.zeros(self.local_shape, dtype=dtype or torch.get_default_dtype(),
                           device=self.device)

    def diagonal(self, dtype=None):
        """This rank's block of the stencil diagonal (1.0 on masked and
        padded rows)."""
        d = self.st.diagonal(dtype=dtype or torch.float64, device="cpu").reshape(
            self.grid_shape)
        d = torch.nn.functional.pad(
            d, [v for p in reversed(self.pad_amount) for v in (0, p)], value=1.0)
        return self._block(d).contiguous().to(self.device)

    # -- halo exchange ------------------------------------------------------
    def _neighbour(self, a, step):
        c = list(self.coords)
        c[a] += step
        if not 0 <= c[a] < self.mesh_shape[a]:
            return None
        return int(np.ravel_multi_index(c, self.mesh_shape))

    def halo(self, loc, a, lo_planes, hi_planes):
        """loc extended along sharded axis a by the previous rank's last
        `lo_planes` planes and the next rank's first `hi_planes` planes
        (zeros at the chain ends): one neighbour exchange."""
        sends, recvs = [], []
        n = loc.shape[a]
        shape = list(loc.shape)
        shape[a] = lo_planes
        below = torch.zeros(shape, dtype=loc.dtype, device=loc.device)
        shape[a] = hi_planes
        above = torch.zeros(shape, dtype=loc.dtype, device=loc.device)
        prev, nxt = self._neighbour(a, -1), self._neighbour(a, 1)
        if prev is not None:
            if hi_planes:
                sends.append((prev, _planes(loc, a, 0, hi_planes).contiguous()))
            if lo_planes:
                recvs.append((prev, below))
        if nxt is not None:
            if lo_planes:
                sends.append((nxt, _planes(loc, a, n - lo_planes, n).contiguous()))
            if hi_planes:
                recvs.append((nxt, above))
        self.comm.sendrecv(sends, recvs)
        return torch.cat([below, loc, above], dim=a)

    def _extend(self, loc, k):
        """loc with k halo planes on every sharded axis, the slowest first
        (so the second axis's planes carry the corners)."""
        ext = loc
        for a in range(len(self.mesh_shape)):
            ext = self.halo(ext, a, k, k)
        return ext

    def _interior(self, ext, k):
        return ext[tuple(slice(k, k + n) for n in self.local_shape[:len(self.mesh_shape)])]

    # -- apply ----------------------------------------------------------------
    def _apply_impl(self, zg):
        self.comm.refuse_capture("DofShardedStencil")
        if self.uses_stencil27:
            ext = self._extend(zg, 1)
            y = stencil27(ext.reshape(-1), self._ext_mask, self.st.w27, self._ext_dims)
            return self._interior(y.reshape(ext.shape), 1)
        zf = torch.where(self.mask_grid, 0.0, zg)
        ext = self._extend(zf, self.k)
        y = self._ext_op._apply_impl(ext.reshape(-1)).reshape(ext.shape)
        return torch.where(self.mask_grid, zg, self._interior(y, self.k))

    def __call__(self, zg):
        return self._apply_impl(zg)


def sharded_cg_solve(sharded_op: DofShardedStencil, b, diag=None, tol=1e-10,
                     maxiter=5000, x0=None):
    """CG on rank-local lattice blocks with the group's global dots.

    b / diag are full flat (N,) vectors on every rank; x0 a local block (a
    redistributed state). Returns the full flat solution and the stats.
    Iteration counts match the sequential stencil CG (padded rows are zero
    throughout and add nothing to any dot)."""
    from dune_pdelab_tpu_torch.linalg.krylov import cg

    bg = sharded_op.device_put(b)
    if diag is not None:
        dg = sharded_op.device_put(diag).to(bg.dtype)
        dg = torch.where(sharded_op.mask_grid, 1.0, torch.where(dg == 0, 1.0, dg))

        def M(r):
            return r / dg
    else:
        def M(r):
            return r
    xg, stats = cg(sharded_op._apply_impl, bg, x0=x0, M=M, tol=tol, maxiter=maxiter,
                   dot=sharded_op.comm.dot)
    return sharded_op.gather(xg), stats
