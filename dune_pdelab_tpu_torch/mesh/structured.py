"""Structured hypercube meshes as index arithmetic.

PyTorch port of dune_pdelab_tpu/mesh/structured.py, limited to the uniform
non-periodic mesh (periodic and mapped meshes wait for ROADMAP slice 11).
The mesh is a set of numpy index maps computed on demand; nothing of size
E or N is built at construction. The face lists (interior_faces,
boundary_faces) feed the DG path's face groups.

Element / vertex / DOF indices are lexicographic with dimension 0 fastest.
"""
from __future__ import annotations

import numpy as np


class StructuredMesh:
    """Axis-aligned uniform structured quad/hex mesh on [lower, upper]."""

    def __init__(self, lower, upper, cells, periodic=None, coords=None):
        self.lower = np.asarray(lower, dtype=np.float64)
        self.upper = np.asarray(upper, dtype=np.float64)
        self.cells = tuple(int(c) for c in np.atleast_1d(cells))
        self.dim = len(self.cells)
        if self.lower.shape != (self.dim,) or self.upper.shape != (self.dim,):
            raise ValueError("lower/upper must have one entry per axis")
        if (periodic is not None and any(periodic)) or coords is not None:
            raise NotImplementedError(
                "periodic and mapped StructuredMesh are not ported yet "
                "(ROADMAP slice 11)")
        self.periodic = (False,) * self.dim
        self.h = (self.upper - self.lower) / np.array(self.cells)
        self.nelements = int(np.prod(self.cells))
        self.vdims = tuple(c + 1 for c in self.cells)     # vertex grid
        self.nvertices = int(np.prod(self.vdims))

    @property
    def uniform(self) -> bool:
        """True: every element is the same axis-aligned box."""
        return True

    @property
    def geometry_type(self) -> str:
        return "cube"

    @property
    def ncorners(self) -> int:
        return 2**self.dim

    def element_multi_index(self) -> np.ndarray:
        """(E, dim) per-axis element indices, dimension 0 fastest."""
        e = np.arange(self.nelements, dtype=np.int64)
        mi = np.empty((self.nelements, self.dim), dtype=np.int64)
        for d in range(self.dim):
            mi[:, d] = e % self.cells[d]
            e = e // self.cells[d]
        return mi

    def element_index(self, mi: np.ndarray) -> np.ndarray:
        """Inverse of element_multi_index."""
        strides = np.cumprod((1,) + self.cells[:-1]).astype(np.int64)
        return np.asarray(mi, dtype=np.int64) @ strides

    def corner_offsets(self) -> np.ndarray:
        """(2^dim, dim) 0/1 offsets; corner c uses bit d of c for axis d
        (matches the Q1 tensor basis ordering, dim 0 fastest)."""
        return np.array(
            [[(c >> d) & 1 for d in range(self.dim)] for c in range(self.ncorners)],
            dtype=np.int64,
        )

    def element_vertex_indices(self) -> np.ndarray:
        """(E, 2^dim) global vertex ids per element, corners in bit order."""
        g = self.element_multi_index()[:, None, :] + self.corner_offsets()[None]
        strides = np.cumprod((1,) + self.vdims[:-1]).astype(np.int64)
        return g @ strides

    def vertex_coords(self) -> np.ndarray:
        """(NV, dim) vertex coordinates, dimension 0 fastest."""
        v = np.arange(self.nvertices, dtype=np.int64)
        mi = np.empty((self.nvertices, self.dim), dtype=np.int64)
        for d in range(self.dim):
            mi[:, d] = v % self.vdims[d]
            v = v // self.vdims[d]
        return self.lower + mi * self.h

    def element_corner_coords(self) -> np.ndarray:
        """(E, 2^dim, dim) corner coordinates."""
        mi = self.element_multi_index()
        off = self.corner_offsets()
        g = mi[:, None, :] + off[None, :, :]
        return self.lower + g * self.h

    def element_centers(self) -> np.ndarray:
        """(E, dim) element centres."""
        return self.element_corner_coords().mean(axis=1)

    # -- faces ---------------------------------------------------------------
    def face_tangential_axes(self, axis: int):
        """Axes spanning a face normal to `axis`, in increasing order."""
        return tuple(d for d in range(self.dim) if d != axis)

    def interior_faces(self):
        """Unique interior faces (reference: the `ids > idn` unique visit).

        Returns a dict of int64 arrays:
          inside  (F,)  element on the lower side (owns the face)
          outside (F,)  element on the upper side
          axis    (F,)  face normal axis; the normal from inside is +e_axis
        Faces normal to axis a lie between cells i and i+1 along a.
        """
        mi_all = self.element_multi_index()
        inside, outside, axis = [], [], []
        for a in range(self.dim):
            ins = np.nonzero(mi_all[:, a] < self.cells[a] - 1)[0]
            mi_out = mi_all[ins].copy()
            mi_out[:, a] += 1
            inside.append(ins)
            outside.append(self.element_index(mi_out))
            axis.append(np.full(len(ins), a, dtype=np.int64))
        return {"inside": np.concatenate(inside),
                "outside": np.concatenate(outside),
                "axis": np.concatenate(axis)}

    def boundary_faces(self):
        """Boundary faces: dict of int64 arrays element (F,), axis (F,),
        side (F,) (0 = lower, 1 = upper); the outward unit normal is
        (2*side - 1) * e_axis."""
        mi_all = self.element_multi_index()
        elem, axis, side = [], [], []
        for a in range(self.dim):
            for s in (0, 1):
                sel = np.nonzero(
                    mi_all[:, a] == (0 if s == 0 else self.cells[a] - 1))[0]
                elem.append(sel)
                axis.append(np.full(len(sel), a, dtype=np.int64))
                side.append(np.full(len(sel), s, dtype=np.int64))
        return {"element": np.concatenate(elem), "axis": np.concatenate(axis),
                "side": np.concatenate(side)}

    def refine(self, factor: int = 2) -> "StructuredMesh":
        """Uniformly refined mesh (global refinement analog of
        grid.globalRefine). Mapped meshes are refused at construction
        (ROADMAP slice 11)."""
        return StructuredMesh(self.lower, self.upper,
                              tuple(c * factor for c in self.cells))

    def coarsen(self, factor: int = 2) -> "StructuredMesh":
        """Uniformly coarsened mesh (for geometric multigrid hierarchies).
        Mapped meshes, whose coarsening keeps every factor-th vertex plane
        in the reference, are refused at construction (ROADMAP slice 11)."""
        if any(c % factor for c in self.cells):
            raise ValueError(f"cells {self.cells} not divisible by {factor}")
        return StructuredMesh(self.lower, self.upper,
                              tuple(c // factor for c in self.cells))

    def __repr__(self):
        return (f"StructuredMesh(dim={self.dim}, cells={self.cells}, "
                f"periodic={self.periodic}, uniform={self.uniform})")
