"""Unstructured simplex meshes (triangles / tetrahedra).

PyTorch port of dune_pdelab_tpu/mesh/simplex.py (reference analog: the
triangulated unit squares and cubes of dune/pdelab/test/gridexamples.hh:
26-273): a simplex mesh is explicit numpy connectivity (vertices + cells),
most conveniently made by triangulating a structured mesh. Geometry is
affine per element; the entity lists (edges, faces, boundary masks) are
computed once at setup for the Pk DOF maps and the constraints.

Volume and face assembly run on these meshes (the face groups are built
in assembly/gridoperator.py). Local refinement is newest-vertex bisection
(`refine_bisection`, 2D) and Traxler's typed bisection (3D), host numpy as
in the reference; both produce the reference's arrays in the reference's
order (cells, vertices, parent cells, midpoints), so DOF numbering and
every later number agree. The reference's per-element emission loops are
vectorised here with the order kept: children are laid out in fixed slots
per parent and read back in row-major order. Gmsh MSH 2.x input goes
through the native C++ parser (io/msh_native.py) or the Python one, which
give equal arrays; a malformed file raises.
"""
from __future__ import annotations

import numpy as np


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
    def from_gmsh(cls, path, reader: str | None = None):
        """Read a Gmsh MSH 2.x ASCII file (reference: the test grids of
        dune/pdelab/test/grids/*.msh read through dune-grid's GmshReader).

        Triangles (element type 2) make a 2D mesh, tetrahedra (type 4) a 3D
        mesh (tets win when both appear: the triangles are then boundary
        facets). Physical tags are kept: `cell_tags` (E,) per cell, and
        `facet_tags` maps a sorted boundary-facet vertex tuple to its
        physical id.

        reader: "native" (csrc/msh_reader.cc, raises when it cannot be
        built), "python" (`_parse_msh_py`), or None, the reference's rule:
        the native reader when it can be built, else, or when it refuses
        the file, the Python parser (both follow the same rules, so a
        malformed file raises either way). `mesh.msh_reader` records
        which parser gave the arrays."""
        from dune_pdelab_tpu_torch.io import msh_native

        if reader not in (None, "native", "python"):
            raise ValueError(f"reader={reader!r}: 'native', 'python' or None")
        parsed = None
        if reader == "native" or (reader is None and msh_native.available()):
            try:
                parsed, used = msh_native.parse_msh(path), "native"
            except (ValueError, NotImplementedError):
                if reader == "native":
                    raise
        if parsed is None:
            parsed, used = cls._parse_msh_py(path), "python"
        coords, tris, tritags, tets, tettags, lines2, linetags = parsed
        if len(tets):
            dim, cells, ctags = 3, tets, tettags
            facets, ftags = tris, tritags
        elif len(tris):
            dim, cells, ctags = 2, tris, tritags
            facets, ftags = lines2, linetags
        else:
            raise ValueError(f"no triangles or tetrahedra in {path}")
        m = cls(coords[:, :dim], cells)
        m._positively_oriented()
        m._boundary_vertices = m._face_count_boundary()
        m.cell_tags = ctags
        m.facet_tags = {tuple(sorted(int(v) for v in fv)): int(t)
                        for fv, t in zip(facets, ftags)}
        m.msh_reader = used
        return m

    @staticmethod
    def _parse_msh_py(path):
        """MSH 2.x ASCII parser: (coords (n, 3), tris, tri tags, tets, tet
        tags, lines, line tags) as int64/float64 arrays. A missing section,
        a short or non-numeric line, or an unknown node id raises
        ValueError; MSH 4 raises NotImplementedError."""
        with open(path) as f:
            lines = f.read().split("\n")
        i = 0

        def seek(section):
            nonlocal i
            while i < len(lines) and lines[i].strip() != section:
                i += 1
            if i == len(lines):
                raise ValueError(f"{section} not found in {path}")
            i += 1

        try:
            seek("$MeshFormat")
            ver = lines[i].split()[0]
            if not ver.startswith("2"):
                raise NotImplementedError(
                    f"MSH format {ver}: only the 2.x ASCII format is supported "
                    "(export from gmsh with -format msh22)")
            seek("$Nodes")
            nn = int(lines[i])
            i += 1
            coords = np.empty((nn, 3))
            idmap = {}
            for r in range(nn):
                parts = lines[i + r].split()
                idmap[int(parts[0])] = r
                coords[r] = [float(parts[1]), float(parts[2]), float(parts[3])]
            i += nn
            seek("$Elements")
            ne = int(lines[i])
            i += 1
            out = {1: ([], []), 2: ([], []), 4: ([], [])}
            for r in range(ne):
                parts = lines[i + r].split()
                etype, ntags = int(parts[1]), int(parts[2])
                tag = int(parts[3]) if ntags > 0 else 0
                nodes = [idmap[int(p)] for p in parts[3 + ntags:]]
                if etype in out:
                    out[etype][0].append(nodes)
                    out[etype][1].append(tag)
        except (IndexError, KeyError) as err:
            raise ValueError(f"malformed MSH file {path}: {err!r}") from err

        def arr(etype, n):
            nodes, tags = out[etype]
            if any(len(v) != n for v in nodes):
                raise ValueError(f"malformed MSH file {path}: element of type "
                                 f"{etype} without {n} nodes")
            return (np.asarray(nodes, np.int64).reshape(-1, n),
                    np.asarray(tags, np.int64))

        (tris, tritags), (tets, tettags), (lines2, linetags) = arr(2, 3), arr(4, 4), arr(1, 2)
        return coords, tris, tritags, tets, tettags, lines2, linetags

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

    def _unique_rows(self, rows):
        """np.unique(rows, axis=0, return_inverse=True, return_counts=True)
        for sorted rows of vertex ids: rows compare lexicographically as the
        integer key sum_i row_i * nv^(k-1-i), so one 1D unique of the keys
        gives the same arrays (the 2D unique sorts void records, about ten
        times slower at 10^6 cells). Keys that could overflow int64 take
        the 2D path."""
        k = rows.shape[1]
        nv = np.int64(max(self.nvertices, 1))
        if float(self.nvertices) ** k >= 2.0 ** 62:
            return np.unique(rows, axis=0, return_inverse=True, return_counts=True)
        key = rows[:, 0].astype(np.int64)
        for i in range(1, k):
            key = key * nv + rows[:, i]
        ukey, first, inv, counts = np.unique(key, return_index=True, return_inverse=True,
                                             return_counts=True)
        return rows[first], inv.reshape(-1), counts

    def edges(self):
        """(unique_edges (NE, 2) sorted vertex pairs,
            cell_edges (E, nedges_per_cell) edge ids).
        Local edge l = pair (a, b) of local vertices in lexicographic order."""
        if self._edges is None:
            d = self.dim
            pairs = [(a, b) for a in range(d + 1) for b in range(a + 1, d + 1)]
            raw = np.stack([np.sort(self.cells[:, list(p)], axis=1) for p in pairs],
                           axis=1)                               # (E, np, 2)
            uniq, inv, _ = self._unique_rows(raw.reshape(-1, 2))
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
            uniq, inv, counts = self._unique_rows(key.reshape(-1, d))
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

    def _face_count_boundary(self) -> np.ndarray:
        """(nvertices,) bool: vertices of faces with a single adjacent cell
        (right for any domain shape, e.g. cut L-shapes)."""
        uniq_f, _, counts = self.faces()
        vb = np.zeros(self.nvertices, dtype=bool)
        vb[uniq_f[counts == 1].ravel()] = True
        return vb

    def submesh(self, cell_mask):
        """Restrict to the selected cells, compacting vertices (cuts non-box
        domains, e.g. L-shapes, out of a triangulated box). Boundary
        vertices are recomputed from face counts."""
        cells = self.cells[np.asarray(cell_mask)]
        used = np.unique(cells.ravel())
        remap = np.full(self.nvertices, -1, dtype=np.int64)
        remap[used] = np.arange(len(used))
        m = SimplexMesh(self.vertices[used], remap[cells])
        m._boundary_vertices = m._face_count_boundary()
        return m

    # -- local refinement: newest-vertex bisection ---------------------------
    def oriented_for_bisection(self):
        """Prepare the mesh for newest-vertex bisection. 2D: rotate each
        triangle so its LONGEST edge is opposite local vertex 0, keeping
        positive orientation. 3D: order each tetrahedron for Maubach's
        tagged bisection: refinement edge (the longest, ties broken by
        global vertex ids) at local positions (0, 3), the other two
        vertices in path order in between, type 0 (exact for Kuhn meshes,
        where the cube diagonal is every tet's longest edge). Call once
        before the first `refine_bisection`."""
        if self.dim == 3:
            return self._oriented_for_bisection_3d()
        if self.dim != 2:
            raise NotImplementedError("bisection refinement: dim 2 and 3 only")
        cc = self.element_corner_coords()                    # (E, 3, 2)
        # edge opposite vertex l has length |v_{l+1} - v_{l+2}|
        lens = np.stack([
            np.linalg.norm(cc[:, (l + 1) % 3] - cc[:, (l + 2) % 3], axis=1)
            for l in range(3)], axis=1)
        peak = np.argmax(lens, axis=1)                       # local v0 choice
        rot = (peak[:, None] + np.arange(3)[None, :]) % 3    # cyclic keeps det
        cells = np.take_along_axis(self.cells, rot, axis=1)
        m = SimplexMesh(self.vertices, cells,
                        boundary_vertices=self._boundary_vertices,
                        lower=self.lower, upper=self.upper)
        return m._positively_oriented()

    def _positively_oriented(self):
        """Swap local vertices 1 <-> 2 where the assembler's affine map has
        a negative determinant (keeps the refinement edge (v1, v2))."""
        cc = self.element_corner_coords()
        d1 = self.dim + 1
        J = np.stack([cc[:, d1 - 1 - i] - cc[:, 0] for i in range(self.dim)], axis=-1)
        neg = np.linalg.det(J) < 0
        cells = self.cells.copy()
        cells[neg, 1], cells[neg, 2] = self.cells[neg, 2], self.cells[neg, 1]
        self.cells = cells
        self._edges = self._faces = None
        return self

    def refine_bisection(self, marks):
        """Newest-vertex bisection of the marked cells with conforming
        closure (reference counterpart: local `grid.adapt()` on simplicial
        UGGrid/ALUGrid driven by dune/pdelab/adaptivity/adaptivity.hh:632;
        the closure leaves no hanging nodes).

        2D convention: the refinement edge of a cell is the edge opposite
        local vertex 0; children are stored newest-vertex-first, so the
        convention maintains itself. Closure marks the refinement edge of
        any cell touching a split edge (fixpoint); per call a cell bisects
        at most twice. The reference emits the children in a per-element
        loop; here each parent has four child slots, filled where the
        reference would emit and read back row-major: the same order.

        Returns (new_mesh, transfer) with transfer = (n_old_vertices,
        midpoint vertex ids, edge endpoint ids (nmid, 2)) for nodal solution
        transfer (P1: value at a midpoint = mean of its endpoints); the new
        mesh carries `parent_cells`.
        """
        if self.dim == 3:
            return self._refine_bisection_3d(marks)
        if self.dim != 2:
            raise NotImplementedError("bisection refinement: dim 2 and 3 only")
        marks = np.asarray(marks)
        if marks.dtype == bool:
            marks = np.nonzero(marks)[0]
        uniq_e, cell_e = self.edges()
        pairs = self._edge_pairs                              # [(0,1),(0,2),(1,2)]
        ref_eid = cell_e[:, pairs.index((1, 2))]
        split = np.zeros(len(uniq_e), dtype=bool)
        split[ref_eid[marks]] = True
        # closure fixpoint: any cell touching a split edge splits its
        # refinement edge
        while True:
            need = split[cell_e].any(axis=1) & ~split[ref_eid]
            if not need.any():
                break
            split[ref_eid[need]] = True
        split_ids = np.nonzero(split)[0]
        nv = self.nvertices
        mid_of = np.full(len(uniq_e), -1, dtype=np.int64)
        mid_of[split_ids] = nv + np.arange(len(split_ids))
        new_verts = np.concatenate([
            self.vertices,
            0.5 * (self.vertices[uniq_e[split_ids, 0]]
                   + self.vertices[uniq_e[split_ids, 1]])], axis=0)

        e01 = cell_e[:, pairs.index((0, 1))]
        e02 = cell_e[:, pairs.index((0, 2))]
        v0, v1, v2 = self.cells.T
        E = self.nelements
        slots = np.zeros((E, 4, 3), dtype=np.int64)
        valid = np.zeros((E, 4), dtype=bool)
        keep = ~split[ref_eid]
        slots[keep, 0] = self.cells[keep]
        valid[keep, 0] = True
        m12, m01, m02 = mid_of[ref_eid], mid_of[e01], mid_of[e02]
        # children (m12, v0, v1) and (m12, v2, v0), each bisected again
        # where its refinement edge (an original edge) is split
        for s0, ma, a, b, eid, mab in ((0, m12, v0, v1, e01, m01),
                                       (2, m12, v2, v0, e02, m02)):
            two = ~keep & split[eid]
            one = ~keep & ~split[eid]
            slots[two, s0] = np.stack([mab, ma, a], axis=1)[two]
            slots[two, s0 + 1] = np.stack([mab, b, ma], axis=1)[two]
            valid[two, s0] = valid[two, s0 + 1] = True
            slots[one, s0] = np.stack([ma, a, b], axis=1)[one]
            valid[one, s0] = True
        mesh = SimplexMesh(new_verts, slots[valid], lower=self.lower, upper=self.upper)
        mesh.parent_cells = np.repeat(np.arange(E, dtype=np.int64), valid.sum(axis=1))
        mesh._positively_oriented()
        mesh._boundary_vertices = mesh._face_count_boundary()
        return mesh, (nv, mid_of[split_ids], uniq_e[split_ids])

    # -- 3D: Traxler typed bisection -----------------------------------------
    def _oriented_for_bisection_3d(self):
        """The reference's per-element loop, kept as it is (it runs once,
        on the initial mesh): the tie-breaks compare float tuples, and a
        vectorised sum could round a distance differently."""
        cc = self.element_corner_coords()                    # (E, 4, 3)
        cells = np.asarray(self.cells)
        E = len(cells)
        # longest edge per tet, ties broken by (sorted global id pair)
        pairs = [(a, b) for a in range(4) for b in range(a + 1, 4)]
        lens = np.stack([np.linalg.norm(cc[:, a] - cc[:, b], axis=1)
                         for a, b in pairs], axis=1)
        gid = np.stack([np.sort(cells[:, [a, b]], axis=1)
                        for a, b in pairs], axis=1)          # (E, 6, 2)
        key = (np.round(lens / lens.max() * 1e12).astype(np.int64),
               -gid[:, :, 0], -gid[:, :, 1])
        order = np.lexsort((key[2], key[1], key[0]), axis=1)
        best = order[:, -1]                                  # (E,)
        new_cells = np.empty_like(cells)
        verts = self.vertices
        for e in range(E):
            a, b = pairs[best[e]]
            v0, vd = cells[e, a], cells[e, b]
            # consistent diagonal direction: v0 = the coordinate-
            # lexicographically smaller endpoint (Maubach's reflection
            # compatibility on Kuhn cubes)
            if tuple(verts[vd]) < tuple(verts[v0]):
                v0, vd = vd, v0
            rest = [v for v in cells[e] if v != v0 and v != vd]
            # middle vertices in path order: by distance from v0,
            # coordinate-lex tie-break
            rest.sort(key=lambda v: (float(np.dot(verts[v] - verts[v0],
                                                  verts[v] - verts[v0])),
                                     tuple(verts[v])))
            new_cells[e] = (v0, rest[0], rest[1], vd)
        m = SimplexMesh(self.vertices, new_cells,
                        boundary_vertices=self._boundary_vertices,
                        lower=self.lower, upper=self.upper)
        # Kuhn-ordered tets start at type 0 (uniform bisection then doubles
        # the cell count per generation with no closure cascade)
        m.bisect_tag = np.zeros(E, np.int64)
        return m

    def _refine_bisection_3d(self, marks):
        """Traxler's tagged newest-vertex bisection for tetrahedra with
        conforming closure (Traxler 1997; Stevenson 2008). Typed simplex
        (x0, x1, x2, x3)_t, t in {0, 1, 2}: refinement edge (x0, x3),
        midpoint z; children C1 = (x0, z, x1, x2)_{t+1 mod 3} and
        C2 = (x3, z, x2, x1) for t == 0, (x3, z, x1, x2) for t == 1, 2.
        Closure: bisect any tet holding an already split edge (by its own
        refinement edge), repeat to the fixpoint. Reference counterpart:
        `grid.adapt()` on simplicial grids (adaptivity.hh:632).

        Each pass is array work: the bisected cells in ascending order,
        their new midpoints numbered in order of first use (the reference's
        dict insertion order), the children in the parent's place. With
        multi-level closure a midpoint's edge endpoints may themselves be
        earlier midpoints; consumers resolve values in creation order
        (adaptivity/local.py does)."""
        marks = np.asarray(marks)
        if marks.dtype == bool:
            marks = np.nonzero(marks)[0]
        if not hasattr(self, "bisect_tag"):
            raise ValueError(
                "3D bisection needs Maubach tags: call "
                "oriented_for_bisection() on the initial mesh first")
        cells = self.cells.copy()
        tags = np.asarray(self.bisect_tag, np.int64).copy()
        parents = np.arange(self.nelements, dtype=np.int64)
        nv = self.nvertices
        coords = self.vertices
        mid_keys = np.zeros(0, np.int64)          # sorted edge keys
        mid_ids = np.zeros(0, np.int64)           # vertex id per sorted key
        order_keys = []                           # creation order
        pairs = [(a, b) for a in range(4) for b in range(a + 1, 4)]

        def keys_of(a, b):
            return (np.minimum(a, b) << 31) | np.maximum(a, b)

        def lookup(keys):
            pos = np.searchsorted(mid_keys, keys)
            pos = np.minimum(pos, max(len(mid_keys) - 1, 0))
            hit = (mid_keys[pos] == keys) if len(mid_keys) else np.zeros(len(keys), bool)
            return hit, pos

        work = np.unique(marks).astype(np.int64)
        for _pass in range(200):
            if len(work):
                cw, tw = cells[work], tags[work]
                key = keys_of(cw[:, 0], cw[:, 3])
                hit, _ = lookup(key)
                uk, first = np.unique(key[~hit], return_index=True)
                uk = uk[np.argsort(first, kind="stable")]     # first-use order
                ids = len(coords) + np.arange(len(uk), dtype=np.int64)
                a, b = uk >> 31, uk & ((1 << 31) - 1)
                coords = np.concatenate([coords, 0.5 * (coords[a] + coords[b])], axis=0)
                order_keys.append(uk)
                srt = np.argsort(np.concatenate([mid_keys, uk]), kind="stable")
                mid_keys = np.concatenate([mid_keys, uk])[srt]
                mid_ids = np.concatenate([mid_ids, ids])[srt]
                z = mid_ids[lookup(key)[1]]
                c1 = np.stack([cw[:, 0], z, cw[:, 1], cw[:, 2]], axis=1)
                c2 = np.where((tw == 0)[:, None],
                              np.stack([cw[:, 3], z, cw[:, 2], cw[:, 1]], axis=1),
                              np.stack([cw[:, 3], z, cw[:, 1], cw[:, 2]], axis=1))
                M = len(cells)
                slots = np.zeros((M, 2, 4), np.int64)
                valid = np.zeros((M, 2), bool)
                slots[:, 0] = cells
                valid[:, 0] = True
                slots[work, 0], slots[work, 1] = c1, c2
                valid[work, 1] = True
                nt = np.repeat(tags[:, None], 2, axis=1)
                nt[work] = ((tw + 1) % 3)[:, None]
                np_ = np.repeat(parents[:, None], 2, axis=1)
                cells, tags, parents = slots[valid], nt[valid], np_[valid]
            # closure: any cell holding a split edge bisects next round
            if len(mid_keys):
                ek = np.stack([keys_of(cells[:, i], cells[:, j]) for i, j in pairs], axis=1)
                work = np.nonzero(np.isin(ek, mid_keys).any(axis=1))[0]
            else:
                work = np.zeros(0, np.int64)
            if not len(work):
                break
        else:
            raise RuntimeError(
                "3D bisection closure did not terminate in 200 passes: "
                "initial mesh tags are incompatible; re-run "
                "oriented_for_bisection() on the coarse mesh or coarsen "
                "the marking")

        mesh = SimplexMesh(coords, cells, lower=self.lower, upper=self.upper)
        mesh.parent_cells = parents
        mesh.bisect_tag = tags
        mesh._boundary_vertices = mesh._face_count_boundary()
        ends_keys = (np.concatenate(order_keys) if order_keys
                     else np.zeros(0, np.int64))
        ends = np.stack([ends_keys >> 31, ends_keys & ((1 << 31) - 1)], axis=1)
        mids = nv + np.arange(len(ends_keys), dtype=np.int64)
        return mesh, (nv, mids, ends)
    def __repr__(self):
        return (f"SimplexMesh(dim={self.dim}, nvertices={self.nvertices}, "
                f"nelements={self.nelements})")
