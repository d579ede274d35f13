"""Structured hypercube meshes as index arithmetic.

PyTorch port of dune_pdelab_tpu/mesh/structured.py, limited to the uniform
non-periodic mesh (periodic and mapped meshes wait for ROADMAP slice 11).
The mesh is a set of numpy index maps computed on demand; nothing of size
E or N is built at construction.

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

    def corner_offsets(self) -> np.ndarray:
        """(2^dim, dim) 0/1 offsets; corner c uses bit d of c for axis d
        (matches the Q1 tensor basis ordering, dim 0 fastest)."""
        return np.array(
            [[(c >> d) & 1 for d in range(self.dim)] for c in range(self.ncorners)],
            dtype=np.int64,
        )

    def element_corner_coords(self) -> np.ndarray:
        """(E, 2^dim, dim) corner coordinates."""
        mi = self.element_multi_index()
        off = self.corner_offsets()
        g = mi[:, None, :] + off[None, :, :]
        return self.lower + g * self.h

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
