"""Unstructured simplex meshes (triangles / tetrahedra).

PyTorch port of dune_pdelab_tpu/mesh/simplex.py (reference analog: the
triangulated unit squares and cubes of dune/pdelab/test/gridexamples.hh:
26-273): a simplex mesh is explicit numpy connectivity (vertices + cells),
most conveniently made by triangulating a structured mesh. Geometry is
affine per element; the entity lists (edges, faces, boundary masks) are
computed once at setup for the Pk DOF maps and the constraints.

Volume assembly runs on these meshes. Face integrals (boundary and skeleton
kernels), gmsh input, `submesh` and the newest-vertex bisection refinement
wait for ROADMAP slice 11.
"""
from __future__ import annotations

import numpy as np


def _slice11(what):
    raise NotImplementedError(f"SimplexMesh.{what} is not ported yet "
                              "(ROADMAP slice 11)")


class SimplexMesh:
    geometry_type = "simplex"
    uniform = False
    coords = None

    def __init__(self, vertices: np.ndarray, cells: np.ndarray,
                 boundary_vertices: np.ndarray | None = None,
                 lower=None, upper=None):
        self.vertices = np.asarray(vertices, np.float64)
        self.cells = np.asarray(cells, np.int64)
        self.dim = self.vertices.shape[1]
        if self.cells.shape[1] != self.dim + 1:
            raise ValueError(f"cells of a {self.dim}D simplex mesh need "
                             f"{self.dim + 1} corners, got {self.cells.shape[1]}")
        self.nvertices = len(self.vertices)
        self.nelements = len(self.cells)
        self.ncorners = self.dim + 1
        self.periodic = (False,) * self.dim
        self.lower = (np.asarray(lower) if lower is not None
                      else self.vertices.min(axis=0))
        self.upper = (np.asarray(upper) if upper is not None
                      else self.vertices.max(axis=0))
        self._boundary_vertices = boundary_vertices
        self._edges = None
        self._faces = None

    # -- construction --------------------------------------------------------
    @classmethod
    def from_gmsh(cls, path):
        """Gmsh MSH 2.x input: ROADMAP slice 11."""
        _slice11("from_gmsh")

    @classmethod
    def from_structured(cls, smesh):
        """Triangulate a structured quad (2D) or hex (3D) mesh: two
        triangles per quad, six Kuhn tetrahedra per hex (along the 0-7
        diagonal)."""
        verts = smesh.vertex_coords()
        ev = smesh.element_vertex_indices()      # corners in bit order
        if smesh.dim == 2:
            # quad corners (00, 10, 01, 11) -> two triangles
            cells = np.concatenate([ev[:, [0, 1, 3]], ev[:, [0, 3, 2]]], axis=0)
        elif smesh.dim == 3:
            paths = [(0, 1, 3, 7), (0, 1, 5, 7), (0, 2, 3, 7),
                     (0, 2, 6, 7), (0, 4, 5, 7), (0, 4, 6, 7)]
            cells = np.concatenate([ev[:, list(p)] for p in paths], axis=0)
        else:
            raise NotImplementedError(smesh.dim)
        vb = np.zeros(len(verts), dtype=bool)
        for d in range(smesh.dim):
            if not smesh.periodic[d]:
                vb |= np.isclose(verts[:, d], smesh.lower[d])
                vb |= np.isclose(verts[:, d], smesh.upper[d])
        return cls(verts, cells, boundary_vertices=vb,
                   lower=smesh.lower, upper=smesh.upper)

    # -- entities ------------------------------------------------------------
    def element_corner_coords(self) -> np.ndarray:
        return self.vertices[self.cells]

    def element_vertex_indices(self) -> np.ndarray:
        """(E, dim+1) corner vertex ids (structured-mesh interface name)."""
        return self.cells

    def vertex_coords(self) -> np.ndarray:
        """(nvertices, dim) coordinates (structured-mesh interface name)."""
        return self.vertices

    def corner_offsets(self) -> np.ndarray:
        """Reference-simplex corner coordinates in local vertex order (the
        P1 geometry convention: v0 at the origin, v_j = e_{dim-j})."""
        from dune_pdelab_tpu_torch.fe.basis import p1_geometry
        return p1_geometry(self.dim).nodes

    def element_centers(self) -> np.ndarray:
        return self.element_corner_coords().mean(axis=1)

    def edges(self):
        """(unique_edges (NE, 2) sorted vertex pairs,
            cell_edges (E, nedges_per_cell) edge ids).
        Local edge l = pair (a, b) of local vertices in lexicographic order."""
        if self._edges is None:
            d = self.dim
            pairs = [(a, b) for a in range(d + 1) for b in range(a + 1, d + 1)]
            raw = np.stack([np.sort(self.cells[:, list(p)], axis=1) for p in pairs],
                           axis=1)                               # (E, np, 2)
            uniq, inv = np.unique(raw.reshape(-1, 2), axis=0, return_inverse=True)
            self._edges = (uniq, inv.reshape(self.nelements, len(pairs)))
            self._edge_pairs = pairs
        return self._edges

    def faces(self):
        """Unique codim-1 faces: (unique_faces (NF, dim) sorted global vertex
        tuples, face_of (E, dim+1) id of local face l, the face OPPOSITE
        local vertex l, counts (NF,) number of adjacent cells)."""
        if self._faces is None:
            d = self.dim
            locs = [[v for v in range(d + 1) if v != lf] for lf in range(d + 1)]
            raw = np.stack([self.cells[:, lv] for lv in locs], axis=1)
            key = np.sort(raw, axis=2)                 # (E, d+1, d)
            uniq, inv, counts = np.unique(key.reshape(-1, d), axis=0,
                                          return_inverse=True, return_counts=True)
            self._faces = (uniq, inv.reshape(self.nelements, d + 1), counts)
            self._face_locs = locs
        return self._faces

    def _face_cells(self):
        """(order, starts): the (cell, local face) pairs sorted by face id
        and the first position of every face in that order."""
        uniq, face_of, _ = self.faces()
        order = np.argsort(face_of.ravel(), kind="stable")
        starts = np.searchsorted(face_of.ravel()[order], np.arange(len(uniq)))
        return order, starts

    def interior_faces(self):
        """dict of arrays: inside/outside cell ids and their local face ids
        for every interior (2-cell) face. inside = lower cell id."""
        _, _, counts = self.faces()
        order, starts = self._face_cells()
        d1 = self.dim + 1
        interior = np.nonzero(counts == 2)[0]
        a = starts[interior]
        return {"face": interior,
                "inside": order[a] // d1, "face_in": order[a] % d1,
                "outside": order[a + 1] // d1, "face_out": order[a + 1] % d1}

    def boundary_faces(self):
        """dict of arrays: cell id + local face id of every boundary face."""
        _, _, counts = self.faces()
        order, starts = self._face_cells()
        d1 = self.dim + 1
        boundary = np.nonzero(counts == 1)[0]
        a = starts[boundary]
        return {"face": boundary, "element": order[a] // d1,
                "local_face": order[a] % d1}

    def boundary_vertex_mask(self) -> np.ndarray:
        if self._boundary_vertices is not None:
            return self._boundary_vertices
        # no mask given: the bounding-box predicate
        vb = np.zeros(self.nvertices, dtype=bool)
        for d in range(self.dim):
            vb |= np.isclose(self.vertices[:, d], self.lower[d])
            vb |= np.isclose(self.vertices[:, d], self.upper[d])
        return vb

    def boundary_edge_mask(self) -> np.ndarray:
        """Edges on the topological domain boundary: sub-edges of faces with
        a single adjacent cell (right for any domain shape)."""
        uniq, _ = self.edges()
        uniq_f, _, counts = self.faces()
        bf = uniq_f[counts == 1]                    # sorted vertex tuples
        if self.dim == 2:
            sub = bf
        else:
            sub = np.concatenate([bf[:, [0, 1]], bf[:, [0, 2]], bf[:, [1, 2]]], axis=0)
        key_e = uniq[:, 0] * np.int64(self.nvertices) + uniq[:, 1]
        key_b = sub[:, 0] * np.int64(self.nvertices) + sub[:, 1]
        return np.isin(key_e, key_b)

    def boundary_face_mask(self) -> np.ndarray:
        """(NF,) bool: codim-1 faces with a single adjacent cell."""
        _, _, counts = self.faces()
        return counts == 1

    def submesh(self, cell_mask):
        """Restriction to selected cells: ROADMAP slice 11."""
        _slice11("submesh")

    def oriented_for_bisection(self):
        """Newest-vertex bisection set-up: ROADMAP slice 11."""
        _slice11("oriented_for_bisection")

    def refine_bisection(self, marks):
        """Newest-vertex bisection refinement: ROADMAP slice 11."""
        _slice11("refine_bisection")

    def __repr__(self):
        return (f"SimplexMesh(dim={self.dim}, nvertices={self.nvertices}, "
                f"nelements={self.nelements})")
