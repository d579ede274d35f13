"""Leaf DOF transfer strategies: local<->global gather/scatter.

PyTorch port of dune_pdelab_tpu/assembly/dofmaps.py:

  * SlicedDofMap  - structured-mesh tensor-product C0 spaces: "element e,
    local node l -> k*e + l" is a strided slice of the DOF grid per local
    node, so gather and scatter-add are nloc strided slice copies/adds.
  * ReshapeDofMap - DG spaces: element DOFs are contiguous, so the whole
    transfer is one reshape.
  * IndexDofMap   - fallback: explicit index arrays. Gather is one
    indexing op; scatter-add is one gather through the transpose map
    (each touched global DOF's local slots, built once per device) and one
    sum in a fixed order, so it uses no floating-point atomic and gives the
    same bits on every run (the reference's `.at[].add` is an atomic add on
    the card).

All expose gather(x) -> (E, nloc) and scatter_add(r, r_loc) -> r. Face
groups have their own transfers: SlabFaceTransfer (DG leaves on a
structured mesh: the inside/outside elements of a face group are a slab of
the element grid, so a slice) and IndexFaceTransfer (index arrays). The
scatter-adds build fresh tensors (in-place slice adds on new zeros, or
zero padding), which torch.func.jvp differentiates (forward mode) like the
reference's functional `.at[...].add`.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from dune_pdelab_tpu_torch.utils.common import device_key, plain_tensors


class IndexDofMap:
    """General index-array path (interleaved or permuted composite leaves,
    C0 face groups)."""

    def __init__(self, element_dofs: np.ndarray):
        self._dofs_np = np.asarray(element_dofs, np.int64)
        self._dofs = {}
        self._tmaps = {}

    @classmethod
    def of_tensor(cls, element_dofs: torch.Tensor) -> "IndexDofMap":
        """The map of an int64 tensor, kept on its device."""
        m = cls(element_dofs.cpu().numpy())
        m._dofs[device_key(element_dofs.device)] = element_dofs
        return m

    def _on(self, device):
        key = device_key(device)
        if key not in self._dofs:
            with plain_tensors():
                self._dofs[key] = torch.as_tensor(self._dofs_np, device=device)
        return self._dofs[key]

    def _transpose(self, n, device):
        """(rows, slots): the global DOFs the map touches, ascending (None
        when it touches all n), and for each its (K,) slots of the
        flattened local array, ascending; padding points at one slot past
        the end (a zero appended at scatter time). A face group touches a
        few DOFs only: keeping its rows compact keeps the padding, and the
        duplicate indices a reverse-mode pass through the gather
        accumulates, to a few per row."""
        key = (device_key(device), int(n))
        if key not in self._tmaps:
            from dune_pdelab_tpu_torch.linalg.multigrid import transpose_map

            with plain_tensors():
                idx = self._on(device).reshape(-1)
                rows = torch.unique(idx)                       # sorted
                local = torch.searchsorted(rows, idx)[:, None]
                ridx, rw = transpose_map(local, torch.ones(local.shape, dtype=torch.float64,
                                                           device=idx.device), len(rows))
                self._tmaps[key] = (None if len(rows) == n else rows,
                                    torch.where(rw != 0, ridx, idx.shape[0]))
        return self._tmaps[key]

    def gather(self, x):
        return x[self._on(x.device)]

    def scatter_add(self, r, r_loc):
        rows, tmap = self._transpose(r.shape[0], r.device)
        flat = r_loc.reshape(-1).to(r.dtype)
        sums = torch.cat([flat, flat.new_zeros(1)])[tmap].sum(dim=1)
        if rows is None:
            return r + sums
        # distinct rows: an index_put without accumulation, the same adds
        return r.index_put((rows,), r[rows] + sums)


class ReshapeDofMap:
    """DG fast path: element DOFs are [offset + e*nb + l]."""

    def __init__(self, offset: int, nelements: int, nbasis: int):
        self.offset = int(offset)
        self.E = int(nelements)
        self.nb = int(nbasis)

    def gather(self, x):
        return x[self.offset:self.offset + self.E * self.nb].reshape(self.E, self.nb)

    def scatter_add(self, r, r_loc):
        flat = r_loc.reshape(-1).to(r.dtype)
        n = self.E * self.nb
        return r + F.pad(flat, (self.offset, r.shape[0] - self.offset - n))


class SlicedDofMap:
    """Structured C0 fast path: strided slices of the DOF lattice.

    DOF grid dims (per axis, dim 0 fastest): n_d = k*c_d (+1 if not
    periodic). Element flat order and local tensor order both have dim 0
    fastest, so the (reversed-shape) C-order reshape lines the axes up.
    Periodic axes compute on an extended (+1) grid: gather reads a wrapped
    copy of the first plane, scatter folds the last plane back onto it.
    """

    def __init__(self, offset: int, k: int, cells, periodic, local_mi):
        self.offset = int(offset)
        self.k = k
        self.cells = tuple(cells)
        self.periodic = tuple(bool(p) for p in periodic)
        self.dim = len(cells)
        self.local_mi = np.asarray(local_mi)      # (nloc, dim)
        self.dims = tuple(k * c if p else k * c + 1
                          for c, p in zip(cells, self.periodic))   # stored grid
        self.ext_dims = tuple(k * c + 1 for c in cells)           # computation grid
        self.n = int(np.prod(self.dims))
        self.nloc = len(self.local_mi)

    def _grid(self, ext=False):
        """C-order grid shape (slowest axis first)."""
        return tuple(reversed(self.ext_dims if ext else self.dims))

    def _slices(self, l):
        """Index expression (slowest axis first) for local node l on the
        extended grid."""
        mi = self.local_mi[l]
        out = []
        for d in reversed(range(self.dim)):
            start = int(mi[d])
            out.append(slice(start, start + self.k * (self.cells[d] - 1) + 1,
                             self.k))
        return tuple(out)

    def _extend(self, xg):
        """Stored grid -> extended grid (wrap the first plane on periodic
        axes)."""
        for d in range(self.dim):
            if self.periodic[d]:
                ax = self.dim - 1 - d
                xg = torch.cat([xg, xg.narrow(ax, 0, 1)], dim=ax)
        return xg

    def _fold(self, rg):
        """Extended grid -> stored grid (fold the last plane onto the
        first)."""
        for d in range(self.dim):
            if self.periodic[d]:
                ax = self.dim - 1 - d
                n = rg.shape[ax] - 1
                body = rg.narrow(ax, 0, n)
                last = rg.narrow(ax, n, 1)
                rg = body + F.pad(last, [0, 0] * (self.dim - 1 - ax) + [0, n - 1])
        return rg

    def gather(self, x):
        xg = self._extend(x[self.offset:self.offset + self.n].reshape(self._grid()))
        cols = [xg[self._slices(l)].reshape(-1) for l in range(self.nloc)]
        return torch.stack(cols, dim=1)           # (E, nloc)

    def scatter_add(self, r, r_loc):
        eshape = tuple(reversed(self.cells))
        rg = torch.zeros(self._grid(ext=True), dtype=r.dtype, device=r.device)
        for l in range(self.nloc):
            rg[self._slices(l)] += r_loc[:, l].reshape(eshape).to(r.dtype)
        rg = self._fold(rg)
        return r + F.pad(rg.reshape(-1),
                         (self.offset, r.shape[0] - self.offset - self.n))


def make_leaf_dof_map(leaf, element_dofs: np.ndarray | None, offset=None):
    """Choose the fastest transfer strategy for a leaf space.

    `element_dofs` is the (E, nloc) GLOBAL map (offsets applied), or None
    for a standalone leaf at offset 0; the index array is only built (from
    `leaf.element_dofs`, lazily) when no fast path applies. `offset` is the
    leaf's contiguous global offset, else None.
    """
    fem = leaf.fem
    mesh = leaf.mesh
    if offset is not None and fem.continuity == "DG":
        E, nb = mesh.nelements, fem.nbasis
        if element_dofs is None:
            # standalone DG leaf: the layout is element-major by construction
            return ReshapeDofMap(int(offset), E, nb)
        # a DG leaf inside a composite space: contiguous and element-major
        expected = (offset + np.arange(E, dtype=np.int64)[:, None] * nb
                    + np.arange(nb, dtype=np.int64)[None, :])
        if np.array_equal(np.asarray(element_dofs, np.int64), expected):
            return ReshapeDofMap(int(offset), E, nb)
    if (offset is not None and fem.continuity == "C0"
            and hasattr(fem, "_mi")
            and getattr(fem, "variant", "equidistant") == "equidistant"
            and mesh.geometry_type == "cube" and not hasattr(mesh, "hanging_constraints")):
        return SlicedDofMap(int(offset), fem.degree, mesh.cells,
                            mesh.periodic, fem._mi)
    return IndexDofMap(leaf.element_dofs if element_dofs is None
                       else element_dofs)


class IndexFaceTransfer:
    """General face-group transfer via element index arrays (F, nloc)."""

    def __init__(self, leaf_dofs: np.ndarray):
        self._map = IndexDofMap(leaf_dofs)

    def gather(self, x):
        return self._map.gather(x)

    def scatter_add(self, r, r_loc):
        return self._map.scatter_add(r, r_loc)


class SlabFaceTransfer:
    """Structured-mesh face-group transfer for DG (reshape) leaves.

    For faces normal to `axis`, the inside/outside element sets are slabs
    of the element grid, [lo, cells[axis] + hi_off) along that axis, so
    gathering the face coefficients is a reshape + slice of the leaf's
    contiguous DOF block, and the scatter-add zero-pads the slab back to
    the grid: no index arrays. On a periodic axis the outside slab of the
    wrap-closed skeleton group is the grid rolled by `periodic_roll` cells
    (the reference's `periodic_roll`).
    """

    def __init__(self, offset: int, cells, nbasis: int, axis: int,
                 lo: int, hi_off: int, periodic_roll: int = 0):
        self.offset = int(offset)
        self.cells = tuple(int(c) for c in cells)
        self.nb = int(nbasis)
        self.E = int(np.prod(self.cells))
        self.dim = len(self.cells)
        self.axis = int(axis)
        self.gax = self.dim - 1 - self.axis      # C-order axis in the grid view
        self.lo = int(lo)
        self.hi = self.cells[self.axis] + int(hi_off)
        self.roll = int(periodic_roll)
        self.grid_shape = tuple(reversed(self.cells)) + (self.nb,)

    def _slc(self):
        idx = [slice(None)] * (self.dim + 1)
        idx[self.gax] = slice(self.lo, self.hi)
        return tuple(idx)

    def gather(self, x):
        g = x[self.offset:self.offset + self.E * self.nb].reshape(self.grid_shape)
        if self.roll:
            g = torch.roll(g, -self.roll, dims=self.gax)
        return g[self._slc()].reshape(-1, self.nb)

    def scatter_add(self, r, r_loc):
        shape = list(self.grid_shape)
        shape[self.gax] = self.hi - self.lo
        g = r_loc.reshape(shape).to(r.dtype)
        # F.pad lists (before, after) pairs from the last axis backwards
        pad = [0, 0] * (self.dim - self.gax) + [self.lo, self.cells[self.axis] - self.hi]
        full = F.pad(g, pad)
        if self.roll:
            full = torch.roll(full, self.roll, dims=self.gax)
        n = self.E * self.nb
        return r + F.pad(full.reshape(-1), (self.offset, r.shape[0] - self.offset - n))
