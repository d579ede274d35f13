"""H(curl)-conforming edge elements: lowest-order Nedelec on cubes and
Whitney elements on triangles and tetrahedra.

PyTorch port of dune_pdelab_tpu/fe/hcurl.py (reference:
dune/pdelab/finiteelementmap/edges0.5fem.hh:24, the EdgeS0.5 Nedelec
elements). Host numpy tabulation, the port's own copy. On cubes the DOFs
are tangential line integrals along edges with the GLOBAL edge direction
+e_axis, so shared edges need no orientation flips; on simplices the space
layer supplies per-element diagonal signs (space/space.py
`_build_hcurl_map_simplex`).

Provides `tabulate_vector` (values (npts, nb, dim)) and `tabulate_curl`
((npts, nb) scalar curl in 2D, (npts, nb, 3) in 3D) on the reference
element; the assembler applies the covariant Piola map of the geometry.
"""
from __future__ import annotations

import itertools

import numpy as np


class N0Cube:
    """Lowest-order Nedelec (type 1) on the reference square/cube.

    Basis ordering: for each axis a (edge direction), the 2^(dim-1)
    transverse corner combinations in bit order (dim0-fastest among the
    transverse axes). phi has only component a nonzero, equal to the tensor
    Q1 hat function of the transverse coordinates.
    """

    geometry = "cube"
    continuity = "Hcurl"
    nodes = None
    degree = 1

    def __init__(self, dim: int):
        assert dim in (2, 3)
        self.dim = dim
        self.edges = []   # (axis, transverse bits)
        for a in range(dim):
            tdims = [d for d in range(dim) if d != a]
            for bits in itertools.product((0, 1), repeat=dim - 1):
                self.edges.append((a, tuple(tdims), bits))
        self.nbasis = len(self.edges)   # 4 (2D) / 12 (3D)

    @staticmethod
    def _hat(x, bit):
        return x if bit else 1.0 - x

    @staticmethod
    def _dhat(bit):
        return 1.0 if bit else -1.0

    def tabulate_vector(self, points):
        points = np.atleast_2d(points)
        npts = points.shape[0]
        v = np.zeros((npts, self.nbasis, self.dim))
        for b, (a, tdims, bits) in enumerate(self.edges):
            val = np.ones(npts)
            for td, bit in zip(tdims, bits):
                val = val * self._hat(points[:, td], bit)
            v[:, b, a] = val
        return v

    def tabulate_curl(self, points):
        points = np.atleast_2d(points)
        npts = points.shape[0]
        if self.dim == 2:
            # scalar curl = d v_y/dx - d v_x/dy
            c = np.zeros((npts, self.nbasis))
            for b, (a, tdims, bits) in enumerate(self.edges):
                td, bit = tdims[0], bits[0]
                if a == 0:       # v = (hat(td), 0): curl = -d/dy hat
                    c[:, b] = -self._dhat(bit)
                else:            # v = (0, hat(td)): curl = d/dx hat
                    c[:, b] = self._dhat(bit)
            return c
        # 3D: curl phi for phi = hat(t1)hat(t2) e_a
        c = np.zeros((npts, self.nbasis, 3))
        for b, (a, tdims, bits) in enumerate(self.edges):
            t1, t2 = tdims
            b1, b2 = bits
            h1 = self._hat(points[:, t1], b1)
            h2 = self._hat(points[:, t2], b2)
            d1 = self._dhat(b1)
            d2 = self._dhat(b2)
            # curl(f e_a) = grad f x e_a ; grad f = d1 h2 e_t1 + h1 d2 e_t2
            for (td, dval) in ((t1, d1 * h2), (t2, h1 * d2)):
                e_td = np.zeros(3)
                e_td[td] = 1.0
                e_a = np.zeros(3)
                e_a[a] = 1.0
                cr = np.cross(e_td, e_a)
                for comp in range(3):
                    if cr[comp] != 0.0:
                        c[:, b, comp] += cr[comp] * dval
        return c

    def __repr__(self):
        return f"N0Cube(dim={self.dim}, nbasis={self.nbasis}, Hcurl)"


class N0Simplex:
    """Lowest-order Nedelec (Whitney) edge element on the reference
    triangle/tetrahedron (reference: dune/pdelab/finiteelementmap/
    edges0.5fem.hh — EdgeS0.5 on simplices, 2D AND 3D).

    P1 geometry convention (fe/basis.py PkFEM(1, dim).nodes): vertex 0 at
    the origin, vertex j (j >= 1) the unit vector along axis dim - j, so
    barycentrics are lambda_0 = 1 - sum(x), lambda_j = x[dim - j]. Edges
    ordered by local vertex pairs (a, b), a < b, lexicographic — matching
    SimplexMesh.edges(). Basis w_(a,b) = lambda_a grad(lambda_b) -
    lambda_b grad(lambda_a) with unit tangential circulation along a->b;
    the global edge direction (ascending global vertex id) is a
    per-element diagonal sign from the space layer
    (space/space.py _build_hcurl_map_simplex). curl w_(a,b) =
    2 grad(lambda_a) x grad(lambda_b), constant per element.
    """

    geometry = "simplex"
    continuity = "Hcurl"
    nodes = None
    degree = 1

    def __init__(self, dim: int = 2):
        if dim not in (2, 3):
            raise NotImplementedError("N0Simplex: dim 2 or 3")
        self.dim = dim
        self._pairs = tuple((a, b) for a in range(dim + 1)
                            for b in range(a + 1, dim + 1))
        self.nbasis = len(self._pairs)              # 3 (2D) / 6 (3D)
        g = np.zeros((dim + 1, dim))
        g[0] = -1.0
        for j in range(1, dim + 1):
            g[j, dim - j] = 1.0
        self._grads = g                             # (nverts, dim)

    def _lams(self, points):
        lam = np.empty((len(points), self.dim + 1))
        lam[:, 0] = 1.0 - points.sum(axis=1)
        for j in range(1, self.dim + 1):
            lam[:, j] = points[:, self.dim - j]
        return lam                                  # (npts, nverts)

    def tabulate_vector(self, points):
        points = np.atleast_2d(points)
        lam = self._lams(points)
        v = np.zeros((len(points), self.nbasis, self.dim))
        for l, (a, b) in enumerate(self._pairs):
            v[:, l, :] = (lam[:, a:a + 1] * self._grads[b][None]
                          - lam[:, b:b + 1] * self._grads[a][None])
        return v

    def tabulate_curl(self, points):
        points = np.atleast_2d(points)
        if self.dim == 2:
            c = np.zeros((len(points), self.nbasis))
            for l, (a, b) in enumerate(self._pairs):
                ga, gb = self._grads[a], self._grads[b]
                c[:, l] = 2.0 * (ga[0] * gb[1] - ga[1] * gb[0])
            return c
        c = np.zeros((len(points), self.nbasis, 3))
        for l, (a, b) in enumerate(self._pairs):
            c[:, l, :] = 2.0 * np.cross(self._grads[a], self._grads[b])
        return c

    def __repr__(self):
        return f"N0Simplex(dim={self.dim}, nbasis={self.nbasis}, Hcurl)"


# backwards-compatible name (2D-only era)
N0Simplex2D = N0Simplex
