"""Sharded stencil-resident geometric multigrid: LatticeGMG over ranks.

PyTorch port of dune_pdelab_tpu/parallel/gmg_sharded.py (reference analog:
parallel AMG-CG over distributed index sets, dune/pdelab/backend/istl/
novlpistlsolverbackend.hh:330-1128 + parallelhelper.hh:273-440):

  * every sharded level's operator is a `DofShardedStencil`: a 3D Q1 level
    launches the stencil27 kernel (K2) on the rank's halo-extended block;
  * vectors are rank-local blocks of zero-padded lattices, padded rows zero
    throughout, so the global dots see the sequential vectors;
  * transfers between sharded levels are neighbour-local for every order k:
    level paddings are 2:1 aligned (padded_f = 2 * padded_c along each
    sharded axis, the coarsest sharded level padded to a multiple of
    nranks * k, as the reference's), so a rank's coarse rows depend on its
    own fine block plus a few planes of its neighbours' (restriction: up to
    2k - 1, prolongation: one; the switch level's rank blocks are the
    coarse rows of each rank's fine block, so it restricts the same way).
    Each transfer applies the sequential LatticeGMG's own 1D maps,
    axis by axis in its order, to the halo-extended block: the same taps,
    weights and order of sums as the sequential transfer, whatever k. (The
    reference transfers Qk, k > 1, through a replicated full fine vector,
    gmg_sharded.py:107-109; this port does not.)
  * levels with fewer DOFs than `gather_below` run replicated: the last
    sharded level restricts into its block of the next level, one
    all-gather of that coarse level makes it whole on every rank, the
    sequential LatticeGMG cycles it, and each rank prolongs its own fine
    block from the replicated coarse correction. No rank ever gathers a
    fine-level vector.

The cycle's arithmetic is the sequential one level for level, so V-cycles
agree to rounding and GMG-CG iteration counts match `LatticeGMG.solve_host`.
"""
from __future__ import annotations

import numpy as np
import torch

from dune_pdelab_tpu_torch.linalg.gmg_lattice import LatticeGMG, _axis_apply
from dune_pdelab_tpu_torch.parallel.comm import Comm, group_of, rank_device
from dune_pdelab_tpu_torch.parallel.dofsharded import DofShardedStencil, _ceil_to
from dune_pdelab_tpu_torch.utils.common import device_key


def _local_map(idx, w, rows, n_real, base):
    """Rows [rows) of a 1D gather map (n_out, t), shifted to a local
    coordinate origin `base`; rows at or past n_real (lattice padding) and
    zero-weight taps get weight 0 and local index 0."""
    lo, hi = rows
    li = np.zeros((hi - lo, idx.shape[1]), np.int64)
    lw = np.zeros((hi - lo, idx.shape[1]))
    real = min(hi, n_real) - lo
    if real > 0:
        sub_i, sub_w = idx[lo:lo + real], w[lo:lo + real]
        keep = sub_w != 0
        li[:real] = np.where(keep, sub_i - base, 0)
        lw[:real] = np.where(keep, sub_w, 0.0)
    return li, lw


def _needed(idx, w, rows, n_real):
    """(min, max) source index with a nonzero weight over rows [rows)."""
    lo, hi = rows
    hi = min(hi, n_real)
    if hi <= lo:
        return None
    sub_i, sub_w = idx[lo:hi], w[lo:hi]
    used = sub_i[sub_w != 0]
    return int(used.min()), int(used.max())


class ShardedLatticeGMG:
    """Distributed V-cycle + GMG-preconditioned CG over a rank mesh.

    gmg: a built sequential `LatticeGMG` (its stencils, transfers and lmax
    are the single source of truth). devices / group, mesh_shape,
    axis_names: as DofShardedStencil (default: a 1D mesh over the slowest
    lattice axis with every rank of the world group). gather_below: levels
    with fewer DOFs run replicated. device: this rank's device.
    """

    def __init__(self, gmg: LatticeGMG, devices=None, mesh_shape=None,
                 axis_names=("sz", "sy"), gather_below=32**3, group=None, device=None):
        self.seq = gmg
        self.group = group_of(devices, group)
        self.comm = Comm(self.group)
        self.device = rank_device(device)
        if mesh_shape is None:
            mesh_shape = (self.comm.size,)
        self.mesh_shape = tuple(int(m) for m in mesh_shape)
        k = gmg.stencils[0].k
        self.k = k

        n_sharded = 0
        for l, dims in enumerate(gmg.dims):
            grid = tuple(reversed(dims))
            if not (int(np.prod(dims)) >= gather_below
                    and all(grid[a] >= nd for a, nd in enumerate(self.mesh_shape))):
                break
            n_sharded = l + 1
        n_sharded = min(n_sharded, gmg.nlevels - 1)   # the dense-LU level stays replicated
        if n_sharded == 0:
            raise ValueError(f"no level above gather_below={gather_below}; use the "
                             "sequential LatticeGMG")
        self.n_sharded = n_sharded

        # paddings of the sharded axes: 2:1 aligned from the coarsest sharded
        # level up, as the reference's; then the layout the switch level
        # restricts into (`_block_rows`: each rank the coarse rows of its own
        # fine block)
        coarsest = n_sharded - 1
        grid_c = tuple(reversed(gmg.dims[coarsest]))
        padded = [None] * (n_sharded + 1)
        padded[coarsest] = tuple(_ceil_to(grid_c[a], nd * k)
                                 for a, nd in enumerate(self.mesh_shape))
        for l in range(coarsest - 1, -1, -1):
            padded[l] = tuple(2 * p for p in padded[l + 1])
        padded[n_sharded] = tuple(-(-p // 2) for p in padded[coarsest])
        self.padded = padded
        self.sstencils = [DofShardedStencil(gmg.stencils[l], group=self.group,
                                            mesh_shape=self.mesh_shape,
                                            axis_names=axis_names, padded_shape=padded[l],
                                            device=self.device)
                          for l in range(n_sharded)]
        self.coords = self.sstencils[0].coords

        # per level pair and sharded axis: halo widths and local 1D maps
        self._plans = [self._transfer_plan(l) for l in range(n_sharded)]
        self._cache = {}

    # -- layouts ---------------------------------------------------------------
    def _block_rows(self, l, a, c):
        """Rows [lo, hi) of block c along sharded axis a at level l: equal
        blocks on the sharded levels; on the switch level the coarse rows
        (the even fine rows halved) of fine block c, which differ in length
        by one at most."""
        if l == self.n_sharded:
            m = self.padded[l - 1][a] // self.mesh_shape[a]
            return (c * m + 1) // 2, ((c + 1) * m + 1) // 2
        n = self.padded[l][a] // self.mesh_shape[a]
        return c * n, (c + 1) * n

    def _transfer_plan(self, l):
        """Halo widths (the same on every rank) and this rank's local maps
        for the transfers between levels l and l + 1 along each sharded
        axis."""
        seq = self.seq
        dim = len(seq.dims[l])
        plan = {}
        for a in range(len(self.mesh_shape)):
            d = dim - 1 - a
            idx, w, ridx, rw = seq.transfers[l][d]
            nf, nc = seq.dims[l][d], seq.dims[l + 1][d]
            nd = self.mesh_shape[a]
            r_lo = r_hi = p_lo = p_hi = 0
            for c in range(nd):
                f0, f1 = self._block_rows(l, a, c)
                c0, c1 = self._block_rows(l + 1, a, c)
                need = _needed(ridx, rw, (c0, c1), nc)       # fine planes
                if need:
                    r_lo, r_hi = max(r_lo, f0 - need[0]), max(r_hi, need[1] - (f1 - 1))
                need = _needed(idx, w, (f0, f1), nf)         # coarse planes
                if need:
                    p_lo, p_hi = max(p_lo, c0 - need[0]), max(p_hi, need[1] - (c1 - 1))
            if max(r_lo, r_hi) > self.padded[l][a] // nd or (
                    l + 1 < self.n_sharded and max(p_lo, p_hi) > self.padded[l + 1][a] // nd):
                raise ValueError("a transfer halo exceeds a neighbour's block; use "
                                 "fewer ranks along this axis or a larger gather_below")
            c = self.coords[a]
            f0, f1 = self._block_rows(l, a, c)
            c0, c1 = self._block_rows(l + 1, a, c)
            plan[a] = {"r_halo": (r_lo, r_hi), "p_halo": (p_lo, p_hi),
                       "r_map": _local_map(ridx, rw, (c0, c1), nc, f0 - r_lo),
                       "p_map": _local_map(idx, w, (f0, f1), nf, c0 - p_lo)}
        return plan

    def _map(self, l, a, which, v):
        key = ("map", l, a, which, v.dtype, device_key(v.device))
        if key not in self._cache:
            i, w = self._plans[l][a][which]
            self._cache[key] = (torch.as_tensor(i, device=v.device),
                                torch.as_tensor(w, dtype=v.dtype, device=v.device))
        return self._cache[key]

    def _dinv(self, l, r):
        key = ("dinv", l, r.dtype, device_key(r.device))
        if key not in self._cache:
            self._cache[key] = 1.0 / self.sstencils[l].diagonal(dtype=r.dtype).to(r.device)
        return self._cache[key]

    # -- flat <-> sharded --------------------------------------------------------
    def device_put(self, x_flat):
        return self.sstencils[0].device_put(x_flat)

    def gather(self, xg):
        return self.sstencils[0].gather(xg)

    # -- transfers --------------------------------------------------------------
    def _restrict(self, l, res):
        """Fine block (level l) -> this rank's block of level l + 1."""
        seq = self.seq
        dim = len(seq.dims[l])
        g = res
        for d in range(dim):
            a = dim - 1 - d
            if a < len(self.mesh_shape):
                lo, hi = self._plans[l][a]["r_halo"]
                ext = self.sstencils[l].halo(g, a, lo, hi)
                i, w = self._map(l, a, "r_map", g)
                g = _axis_apply(ext, i, w, a)
            else:
                _, _, ridx, rw = seq._transfer(l, d, g)
                g = _axis_apply(g, ridx, rw, a)
        return g

    def _prolong(self, l, zc, replicated):
        """Level l + 1 -> this rank's fine block of level l. zc is this
        rank's coarse block, or (replicated) the whole coarse level as a
        padded grid."""
        seq = self.seq
        dim = len(seq.dims[l])
        g = zc
        for d in range(dim):
            a = dim - 1 - d
            if a < len(self.mesh_shape):
                lo, hi = self._plans[l][a]["p_halo"]
                if replicated:
                    c0, c1 = self._block_rows(l + 1, a, self.coords[a])
                    n = g.shape[a]
                    src = g.narrow(a, max(c0 - lo, 0), min(c1 + hi, n) - max(c0 - lo, 0))
                    pad = [0, 0] * g.ndim
                    pad[2 * (g.ndim - 1 - a)] = max(lo - c0, 0)
                    pad[2 * (g.ndim - 1 - a) + 1] = max(c1 + hi - n, 0)
                    ext = torch.nn.functional.pad(src, pad)
                else:
                    ext = self.sstencils[l + 1].halo(g, a, lo, hi)
                i, w = self._map(l, a, "p_map", g)
                g = _axis_apply(ext, i, w, a)
            else:
                idx, w, _, _ = seq._transfer(l, d, g)
                g = _axis_apply(g, idx, w, a)
        return g

    def _to_replicated(self, l, rc):
        """This rank's block of level l + 1 (the switch level) -> the whole
        level as a flat vector on every rank: one all-gather."""
        nax = len(self.mesh_shape)
        most = [-(-self.padded[l][a] // (2 * nd)) for a, nd in enumerate(self.mesh_shape)]
        pad = [0, 0] * rc.ndim                   # equal shapes for the all-gather
        for a in range(nax):
            pad[2 * (rc.ndim - 1 - a) + 1] = most[a] - rc.shape[a]
        parts = self.comm.allgather(torch.nn.functional.pad(rc, pad).contiguous())
        full = torch.zeros(self.padded[l + 1] + tuple(rc.shape[nax:]),
                           dtype=rc.dtype, device=rc.device)
        for r, p in enumerate(parts):
            c = np.unravel_index(r, self.mesh_shape)
            rows = [self._block_rows(l + 1, a, int(c[a])) for a in range(nax)]
            full[tuple(slice(*b) for b in rows)] = p[tuple(slice(0, hi - lo) for lo, hi in rows)]
        grid = tuple(reversed(self.seq.dims[l + 1]))
        return full[tuple(slice(0, n) for n in grid)].reshape(-1)

    def _from_replicated(self, l, zc):
        """The whole level l + 1 (flat) as a padded grid of the transfer
        layout."""
        nax = len(self.mesh_shape)
        grid = tuple(reversed(self.seq.dims[l + 1]))
        g = zc.reshape(grid)
        pad = []
        for a in reversed(range(len(grid))):
            pad += [0, (self.padded[l + 1][a] - grid[a]) if a < nax else 0]
        return torch.nn.functional.pad(g, pad)

    # -- smoother (LatticeGMG._smooth on blocks) ---------------------------------
    def _smooth(self, l, z, r, steps):
        seq = self.seq
        sst = self.sstencils[l]
        mask = sst.mask_grid
        dinv = self._dinv(l, r)
        if seq.smoother == "jacobi":
            for _ in range(steps):
                z = z + seq.omega * dinv * (r - sst(z))
                z = torch.where(mask, r, z)
            return z
        lmax = seq.lmax[l]
        lmin = lmax / 4.0
        theta = 0.5 * (lmax + lmin)
        delta = 0.5 * (lmax - lmin)
        sigma = theta / delta
        res = r - sst(z)
        d = (1.0 / theta) * (dinv * res)
        z = torch.where(mask, r, z + d)
        rho = 1.0 / sigma
        for _ in range(steps - 1):
            res = r - sst(z)
            rho_new = 1.0 / (2.0 * sigma - rho)
            d = (rho_new * rho) * d + (2.0 * rho_new / delta) * (dinv * res)
            z = torch.where(mask, r, z + d)
            rho = rho_new
        return z

    # -- V-cycle -------------------------------------------------------------------
    def _coarse(self, l, rc):
        """Cycle of level l + 1 on its rank block rc; returns the correction
        as a block (sharded level) or as the replicated padded grid."""
        seq = self.seq
        L = seq.nlevels
        if l + 1 < self.n_sharded:
            maskc = self.sstencils[l + 1].mask_grid
            rc = torch.where(maskc, 0.0, rc)
            zc = self._vcycle(l + 1, rc)
            if seq.cycle == "w" and l + 1 < L - 1:
                rc2 = torch.where(maskc, 0.0, rc - self.sstencils[l + 1](zc))
                zc = zc + self._vcycle(l + 1, rc2)
            return zc, False
        rcf = torch.where(seq.stencils[l + 1].mask, 0.0, self._to_replicated(l, rc))
        zc = seq._vcycle(l + 1, rcf)
        if seq.cycle == "w" and l + 1 < L - 1:
            rc2 = torch.where(seq.stencils[l + 1].mask, 0.0, rcf - seq.stencils[l + 1](zc))
            zc = zc + seq._vcycle(l + 1, rc2)
        return self._from_replicated(l, zc), True

    def _vcycle(self, l, r):
        sst = self.sstencils[l]
        z = self._smooth(l, torch.zeros_like(r), r, self.seq.pre)
        res = r - sst(z)
        zc, replicated = self._coarse(l, self._restrict(l, res))
        corr = self._prolong(l, zc, replicated)
        z = z + torch.where(sst.mask_grid, 0.0, corr)
        return self._smooth(l, z, r, self.seq.post)

    def apply(self, rg):
        """One V-cycle on a rank-local block."""
        return self._vcycle(0, rg)

    def apply_flat(self, r_flat):
        return self.gather(self.apply(self.device_put(r_flat)))

    # -- host-loop GMG-CG (LatticeGMG.solve_host on blocks) ----------------------
    def solve_host(self, b, tol=1e-8, atol=0.0, maxiter=200):
        """GMG-preconditioned CG on the blocks; b is a block or a full flat
        vector. The defect is read on the host once per iteration.
        Returns (x block, info) as LatticeGMG.solve_host."""
        sst = self.sstencils[0]
        dot = self.comm.dot

        def norm(v):
            return float(torch.sqrt(dot(v, v)))

        bg = b if tuple(b.shape) == sst.local_shape else self.device_put(b)
        x = torch.zeros_like(bg)
        r = bg
        defect0 = norm(r)
        target = max(tol * defect0, atol)
        z = self.apply(r)
        p = z
        rho = dot(r, z)
        defect = defect0
        it = 0
        while defect > target and it < maxiter:
            q = sst(p)
            alpha = rho / dot(p, q)
            x = x + alpha * p
            r = r - alpha * q
            defect = norm(r)
            it += 1
            if defect <= target:
                break
            z = self.apply(r)
            rho_new = dot(r, z)
            p = z + (rho_new / rho) * p
            rho = rho_new
        true_defect = norm(bg - sst(x))
        return x, {"iterations": it, "converged": defect <= target,
                   "defect0": defect0, "defect": defect, "true_defect": true_defect}
