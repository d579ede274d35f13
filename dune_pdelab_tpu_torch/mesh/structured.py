"""Structured hypercube meshes as index arithmetic.

PyTorch port of dune_pdelab_tpu/mesh/structured.py (reference analog:
YaspGrid as consumed by PDELab, dune/pdelab/test/gridexamples.hh:26-60).
The mesh is a set of numpy index maps computed on demand; nothing of size
E or N is built at construction on a uniform mesh:

  * element -> corner vertex connectivity (lexicographic; periodic axes
    wrap, identifying the last vertex plane with the first),
  * interior-face and boundary-face lists (periodic axes add the wrap
    faces and have no boundary faces),
  * per-element geometry: one shared box (uniform), or multilinear from a
    vertex coordinate array `coords` over the full (c+1)-plane grid
    (mapped; a mapped periodic axis must close: its last coordinate plane
    equals its first, checked with rtol=0 and atol=1e-12 where the
    reference keeps numpy's default rtol=1e-5).

Element / vertex / DOF indices are lexicographic with dimension 0 fastest.
"""
from __future__ import annotations

import numpy as np


class StructuredMesh:
    """Axis-aligned structured quad/hex mesh on [lower, upper], optionally
    periodic per axis, optionally with perturbed vertex coordinates."""

    def __init__(self, lower, upper, cells, periodic=None, coords=None):
        self.lower = np.asarray(lower, dtype=np.float64)
        self.upper = np.asarray(upper, dtype=np.float64)
        self.cells = tuple(int(c) for c in np.atleast_1d(cells))
        self.dim = len(self.cells)
        if self.lower.shape != (self.dim,) or self.upper.shape != (self.dim,):
            raise ValueError("lower/upper must have one entry per axis")
        self.periodic = tuple(bool(p) for p in (periodic or (False,) * self.dim))
        self.h = (self.upper - self.lower) / np.array(self.cells)
        self.nelements = int(np.prod(self.cells))
        # vertex grid: periodic axes identify last plane with first
        self.vdims = tuple(
            c if p else c + 1 for c, p in zip(self.cells, self.periodic)
        )
        self.nvertices = int(np.prod(self.vdims))
        # geometric vertex grid: ALWAYS c+1 planes per axis. Topology
        # (DOF identification) lives on vdims; geometry (coords) on gdims.
        # For a mapped periodic axis the caller supplies coordinates for
        # the full gdims grid with the CLOSURE contract: the last plane is
        # the same physical curve as the first (e.g. theta = 2*pi == 0 on
        # an annulus), so wrap elements keep continuous corner geometry
        # while their DOFs are identified (reference analog: YaspGrid
        # periodic overlap geometry, dune/pdelab/test/gridexamples.hh).
        self.gdims = tuple(c + 1 for c in self.cells)
        self.ngvertices = int(np.prod(self.gdims))
        if coords is not None:
            coords = np.asarray(coords, dtype=np.float64)
            if coords.shape != (self.ngvertices, self.dim):
                raise ValueError(
                    f"coords must cover the full geometric vertex grid "
                    f"{self.gdims} = {self.ngvertices} vertices (periodic axes "
                    f"included: last plane == first plane physically), got "
                    f"{coords.shape}")
            if any(self.periodic):
                grid = coords.reshape(
                    tuple(reversed(self.gdims)) + (self.dim,))
                for a in range(self.dim):
                    if not self.periodic[a]:
                        continue
                    ax = self.dim - 1 - a
                    first = np.take(grid, 0, axis=ax)
                    last = np.take(grid, self.gdims[a] - 1, axis=ax)
                    if not np.allclose(first, last, rtol=0.0, atol=1e-12):
                        raise ValueError(
                            f"periodic axis {a}: mapped coords do not "
                            "close (last vertex plane must coincide with "
                            "the first)")
        self.coords = coords

    # -- basic properties ----------------------------------------------------
    @property
    def uniform(self) -> bool:
        """True when every element is the same axis-aligned box (fast geometry)."""
        return self.coords is None

    @property
    def geometry_type(self) -> str:
        return "cube"

    @property
    def ncorners(self) -> int:
        return 2**self.dim

    # -- index arithmetic ----------------------------------------------------
    def _strides(self, dims) -> np.ndarray:
        s = np.ones(self.dim, dtype=np.int64)
        for d in range(1, self.dim):
            s[d] = s[d - 1] * dims[d - 1]
        return s

    def element_multi_index(self) -> np.ndarray:
        """(E, dim) per-axis element indices, dimension 0 fastest."""
        e = np.arange(self.nelements, dtype=np.int64)
        mi = np.empty((self.nelements, self.dim), dtype=np.int64)
        for d in range(self.dim):
            mi[:, d] = e % self.cells[d]
            e = e // self.cells[d]
        return mi

    def element_index(self, mi: np.ndarray) -> np.ndarray:
        """Inverse of element_multi_index (with periodic wrap)."""
        mi = np.asarray(mi)
        wrapped = np.mod(mi, np.array(self.cells))
        return wrapped @ self._strides(self.cells)

    def corner_offsets(self) -> np.ndarray:
        """(2^dim, dim) 0/1 offsets; corner c uses bit d of c for axis d
        (matches the Q1 tensor basis ordering, dim 0 fastest)."""
        return np.array(
            [[(c >> d) & 1 for d in range(self.dim)] for c in range(self.ncorners)],
            dtype=np.int64,
        )

    def element_vertex_indices(self) -> np.ndarray:
        """(E, 2^dim) global vertex ids per element (periodic axes wrap)."""
        mi = self.element_multi_index()                      # (E, dim)
        off = self.corner_offsets()                          # (C, dim)
        g = mi[:, None, :] + off[None, :, :]                 # (E, C, dim)
        vd = np.array(self.vdims)
        g = np.mod(g, vd)  # wraps only where periodic (vdims == cells there)
        return g @ self._strides(self.vdims)

    def vertex_coords(self) -> np.ndarray:
        """(NV, dim) vertex coordinates on the IDENTIFIED grid (periodic
        axes keep the first plane's coordinates)."""
        if self.coords is not None:
            if not any(self.periodic):
                return self.coords
            grid = self.coords.reshape(
                tuple(reversed(self.gdims)) + (self.dim,))
            sl = tuple(
                slice(0, self.vdims[a])
                for a in reversed(range(self.dim)))
            return np.ascontiguousarray(grid[sl].reshape(-1, self.dim))
        v = np.arange(self.nvertices, dtype=np.int64)
        mi = np.empty((self.nvertices, self.dim), dtype=np.int64)
        for d in range(self.dim):
            mi[:, d] = v % self.vdims[d]
            v = v // self.vdims[d]
        return self.lower + mi * self.h

    def element_corner_coords(self) -> np.ndarray:
        """(E, 2^dim, dim) geometric corner coordinates.

        For periodic axes the wrapped corners are *unwrapped* so the element
        geometry stays a proper box (geometry is position, not topology).
        """
        if self.coords is not None:
            # index the FULL geometric grid without wrapping: a wrap
            # element's upper corners read the closure plane, so its
            # multilinear geometry stays continuous (topology wraps via
            # element_vertex_indices; geometry never does)
            mi = self.element_multi_index()
            off = self.corner_offsets()
            g = mi[:, None, :] + off[None, :, :]
            return self.coords[g @ self._strides(self.gdims)]
        mi = self.element_multi_index()
        off = self.corner_offsets()
        g = mi[:, None, :] + off[None, :, :]
        return self.lower + g * self.h

    def element_centers(self) -> np.ndarray:
        return self.element_corner_coords().mean(axis=1)

    # -- faces ---------------------------------------------------------------
    def face_tangential_axes(self, axis: int):
        """Axes spanning a face normal to `axis`, in increasing order."""
        return tuple(d for d in range(self.dim) if d != axis)

    def interior_faces(self):
        """Unique interior faces.

        Returns dict with int64 arrays:
          inside  (F,)  element on the lower side (owns the face; the
                        analog of the `ids > idn` unique-visit rule)
          outside (F,)  element on the upper side (wraps on periodic axes)
          axis    (F,)  face normal axis; normal from inside is +e_axis
        Faces normal to axis a between cell i and i+1; periodic axes add the
        wrap faces (last cell -> first cell).
        """
        mi_all = self.element_multi_index()
        inside, outside, axis = [], [], []
        for a in range(self.dim):
            n_a = self.cells[a]
            keep = (
                mi_all[:, a] < n_a - 1
                if not self.periodic[a]
                else np.ones(self.nelements, dtype=bool)
            )
            if self.periodic[a] and n_a < 2:
                keep[:] = False  # degenerate: self-neighbor
            ins = np.nonzero(keep)[0]
            mi_out = mi_all[ins].copy()
            mi_out[:, a] += 1
            inside.append(ins)
            outside.append(self.element_index(mi_out))
            axis.append(np.full(len(ins), a, dtype=np.int64))
        return {
            "inside": np.concatenate(inside) if inside else np.zeros(0, np.int64),
            "outside": np.concatenate(outside) if outside else np.zeros(0, np.int64),
            "axis": np.concatenate(axis) if axis else np.zeros(0, np.int64),
        }

    def boundary_faces(self):
        """Boundary faces on non-periodic axes.

        Returns dict with int64 arrays:
          element (F,), axis (F,), side (F,)  (0 = lower, 1 = upper)
        Outward unit normal is (2*side - 1) * e_axis.
        """
        mi_all = self.element_multi_index()
        elem, axis, side = [], [], []
        for a in range(self.dim):
            if self.periodic[a]:
                continue
            for s in (0, 1):
                sel = np.nonzero(
                    mi_all[:, a] == (0 if s == 0 else self.cells[a] - 1)
                )[0]
                elem.append(sel)
                axis.append(np.full(len(sel), a, dtype=np.int64))
                side.append(np.full(len(sel), s, dtype=np.int64))
        cat = lambda xs: np.concatenate(xs) if xs else np.zeros(0, np.int64)
        return {"element": cat(elem), "axis": cat(axis), "side": cat(side)}

    # -- refinement ----------------------------------------------------------
    def refine(self, factor: int = 2) -> "StructuredMesh":
        """Uniformly refined mesh (global refinement analog of
        grid.globalRefine). Mapped meshes refine by per-axis linear
        interpolation of the vertex coordinate grid — new vertices lie at
        parameter midpoints ON the parent Q1 surface, so the refined
        multilinear geometry reproduces the coarse geometry exactly
        (reference analog: geometry refinement through the grid manager,
        common/geometrywrapper.hh)."""
        if self.coords is not None:
            grid = self.coords.reshape(
                tuple(reversed(self.gdims)) + (self.dim,))
            for ax in range(self.dim):
                n = grid.shape[ax]
                new_n = (n - 1) * factor + 1
                t = np.linspace(0.0, n - 1.0, new_n)
                i0 = np.minimum(np.floor(t).astype(np.int64), n - 2)
                w = t - i0
                g0 = np.take(grid, i0, axis=ax)
                g1 = np.take(grid, i0 + 1, axis=ax)
                wshape = [1] * grid.ndim
                wshape[ax] = new_n
                w = w.reshape(wshape)
                grid = g0 * (1.0 - w) + g1 * w
            return StructuredMesh(
                self.lower, self.upper,
                tuple(c * factor for c in self.cells),
                periodic=self.periodic,
                coords=grid.reshape(-1, self.dim))
        return StructuredMesh(
            self.lower, self.upper,
            tuple(c * factor for c in self.cells),
            periodic=self.periodic,
        )

    def coarsen(self, factor: int = 2) -> "StructuredMesh":
        """Uniformly coarsened mesh (for geometric multigrid hierarchies).
        Mapped meshes keep every factor-th vertex plane (the standard
        nested-corner coarse geometry of geometric multigrid)."""
        if any(c % factor for c in self.cells):
            raise ValueError(f"cells {self.cells} not divisible by {factor}")
        if self.coords is not None:
            grid = self.coords.reshape(
                tuple(reversed(self.gdims)) + (self.dim,))
            sl = tuple(slice(None, None, factor) for _ in range(self.dim))
            return StructuredMesh(
                self.lower, self.upper,
                tuple(c // factor for c in self.cells),
                periodic=self.periodic,
                coords=grid[sl].reshape(-1, self.dim))
        return StructuredMesh(
            self.lower, self.upper,
            tuple(c // factor for c in self.cells),
            periodic=self.periodic,
        )

    def __repr__(self):
        return (f"StructuredMesh(dim={self.dim}, cells={self.cells}, "
                f"periodic={self.periodic}, uniform={self.uniform})")
