"""Leaf DOF transfer strategies: local<->global gather/scatter.

PyTorch port of dune_pdelab_tpu/assembly/dofmaps.py (SlicedDofMap,
IndexDofMap and make_leaf_dof_map; the DG ReshapeDofMap and the face
transfers wait for ROADMAP slice 7).

  * SlicedDofMap - structured-mesh tensor-product C0 spaces: "element e,
    local node l -> k*e + l" is a strided slice of the DOF grid per local
    node, so gather and scatter-add are nloc strided slice copies/adds.
  * IndexDofMap  - fallback: explicit index arrays + gather / index_add.

Both expose gather(x) -> (E, nloc) and scatter_add(r, r_loc) -> r. The
scatter-adds write into fresh tensors with in-place slice adds, which
torch.func.jvp differentiates (forward mode) like the reference's
functional `.at[...].add`.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


class IndexDofMap:
    """General index-array path."""

    def __init__(self, element_dofs: np.ndarray):
        self._dofs_np = np.asarray(element_dofs, np.int64)
        self._dofs = {}

    def _on(self, device):
        key = str(device)
        if key not in self._dofs:
            self._dofs[key] = torch.as_tensor(self._dofs_np, device=device)
        return self._dofs[key]

    def gather(self, x):
        return x[self._on(x.device)]

    def scatter_add(self, r, r_loc):
        idx = self._on(r.device).reshape(-1)
        return r.index_add(0, idx, r_loc.reshape(-1).to(r.dtype))


class SlicedDofMap:
    """Structured C0 fast path: strided slices of the DOF lattice.

    DOF grid dims (per axis, dim 0 fastest): n_d = k*c_d + 1. Element flat
    order and local tensor order both have dim 0 fastest, so the
    (reversed-shape) C-order reshape lines the axes up.
    """

    def __init__(self, offset: int, k: int, cells, periodic, local_mi):
        if any(periodic):
            raise NotImplementedError(
                "periodic DOF lattices are not ported yet (ROADMAP slice 11)")
        self.offset = int(offset)
        self.k = k
        self.cells = tuple(cells)
        self.dim = len(cells)
        self.local_mi = np.asarray(local_mi)      # (nloc, dim)
        self.dims = tuple(k * c + 1 for c in cells)
        self.n = int(np.prod(self.dims))
        self.nloc = len(self.local_mi)

    def _grid(self):
        return tuple(reversed(self.dims))         # C-order: slowest axis first

    def _slices(self, l):
        """Index expression (slowest axis first) for local node l."""
        mi = self.local_mi[l]
        out = []
        for d in reversed(range(self.dim)):
            start = int(mi[d])
            out.append(slice(start, start + self.k * (self.cells[d] - 1) + 1,
                             self.k))
        return tuple(out)

    def gather(self, x):
        xg = x[self.offset:self.offset + self.n].reshape(self._grid())
        cols = [xg[self._slices(l)].reshape(-1) for l in range(self.nloc)]
        return torch.stack(cols, dim=1)           # (E, nloc)

    def scatter_add(self, r, r_loc):
        eshape = tuple(reversed(self.cells))
        rg = torch.zeros(self._grid(), dtype=r.dtype, device=r.device)
        for l in range(self.nloc):
            rg[self._slices(l)] += r_loc[:, l].reshape(eshape).to(r.dtype)
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
    if (offset is not None and fem.continuity == "C0"
            and hasattr(fem, "_mi")
            and getattr(fem, "variant", "equidistant") == "equidistant"
            and mesh.geometry_type == "cube"):
        return SlicedDofMap(int(offset), fem.degree, mesh.cells,
                            mesh.periodic, fem._mi)
    return IndexDofMap(leaf.element_dofs if element_dofs is None
                       else element_dofs)
