"""Locally refined cube meshes: a 2:1-balanced quadtree/octree forest.

PyTorch port of dune_pdelab_tpu/mesh/adaptive.py (reference: local grid
adaptation, dune/pdelab/adaptivity/adaptivity.hh:632 adapt_grid over UG/ALU
grids; dune/pdelab/constraints/hangingnodemanager.hh shape regularity).
Adaptation is a set-up act: `refine(marks)` returns a NEW mesh object.
Everything here is integer lattice arithmetic in host numpy. Leaves and
vertices follow the reference's per-element loops and dict lookups; the
hanging rows' per-vertex leaf search runs as array work
(`_leaves_of`), with the reference's choice and tie-breaks, so leaves,
vertices and hanging rows come out equal to the reference's
(chip_smoke.py phase 12d times them).

Representation: leaf cells of a forest over a coarse structured mesh. Each
leaf = (level, origin) with origin in units of the *finest* lattice
(coarse_cells[d] * 2^max_level points per axis); a level-l cell spans
2^(max_level - l) lattice units. One-level difference across faces is
enforced by closure iterations in `refine`.

The mesh presents the interface the assembler's per-element geometry path
reads: `element_corner_coords`, `nelements`, `dim`, `geometry_type`,
`ncorners`, `uniform=False`. Q1 vertex numbering and hanging-node
constraint rows (vertex -> affine combination of coarse-face corners,
reference: dune/pdelab/constraints/hangingnode.hh:24,181) come from
`vertices()` / `hanging_constraints()`.
"""
from __future__ import annotations

import itertools

import numpy as np


class AdaptiveMesh:
    """2:1-balanced locally refined axis-aligned cube mesh."""

    geometry_type = "cube"
    uniform = False
    periodic = None  # set per-instance

    def __init__(self, lower, upper, coarse_cells, levels=None, origins=None,
                 max_level=0):
        self.lower = np.asarray(lower, dtype=np.float64)
        self.upper = np.asarray(upper, dtype=np.float64)
        self.coarse_cells = tuple(int(c) for c in np.atleast_1d(coarse_cells))
        self.dim = len(self.coarse_cells)
        self.periodic = (False,) * self.dim
        self.max_level = int(max_level)
        if levels is None:
            # all cells at level 0
            n = int(np.prod(self.coarse_cells))
            mi = np.stack(np.unravel_index(
                np.arange(n), self.coarse_cells, order="F"), axis=1)
            levels = np.zeros(n, dtype=np.int64)
            origins = mi.astype(np.int64)
            self.max_level = 0
        self.levels = np.asarray(levels, dtype=np.int64)       # (E,)
        self.origins = np.asarray(origins, dtype=np.int64)     # (E, dim)
        self.nelements = len(self.levels)
        # finest-lattice resolution per axis and spacing
        self.res = np.array(self.coarse_cells, np.int64) * (2 ** self.max_level)
        self.h_fine = (self.upper - self.lower) / self.res
        # leaf lookup: (level, origin tuple) -> element index
        self._leaf = {}
        for e in range(self.nelements):
            self._leaf[(int(self.levels[e]), tuple(self.origins[e]))] = e
        self._vertex_cache = None
        self._hanging_cache = None

    # -- sizes ----------------------------------------------------------
    @property
    def ncorners(self):
        return 2 ** self.dim

    def cell_size(self, level):
        """Edge length of a level-`level` cell in finest lattice units."""
        return 2 ** (self.max_level - int(level))

    def corner_offsets(self):
        return np.array(
            [[(c >> d) & 1 for d in range(self.dim)]
             for c in range(self.ncorners)], dtype=np.int64)

    # -- geometry -------------------------------------------------------
    def element_corner_coords(self) -> np.ndarray:
        """(E, 2^dim, dim) physical corner coordinates."""
        s = (2 ** (self.max_level - self.levels))[:, None]     # (E, 1)
        off = self.corner_offsets()                            # (C, dim)
        lat = self.origins[:, None, :] + s[:, :, None] * off[None, :, :]
        return self.lower + lat * self.h_fine

    def element_centers(self) -> np.ndarray:
        return self.element_corner_coords().mean(axis=1)

    def element_sizes(self) -> np.ndarray:
        """(E, dim) physical edge lengths per element."""
        s = (2 ** (self.max_level - self.levels))[:, None]
        return s * self.h_fine[None, :]

    # -- vertices (Q1 dof lattice) ---------------------------------------
    def vertices(self):
        """(corner_lattice (NV, dim) int64, element_vertices (E, 2^dim) int64).

        Vertex numbering: lexicographic over the unique corner lattice
        points (deterministic across runs).
        """
        if self._vertex_cache is not None:
            return self._vertex_cache
        s = (2 ** (self.max_level - self.levels))[:, None]
        off = self.corner_offsets()
        lat = (self.origins[:, None, :]
               + s[:, :, None] * off[None, :, :])              # (E, C, dim)
        flat = lat.reshape(-1, self.dim)
        # lexicographic unique (dim 0 fastest: sort by reversed columns)
        keys = flat @ self._lattice_strides()
        uniq, inv = np.unique(keys, return_inverse=True)
        nv = len(uniq)
        verts = np.empty((nv, self.dim), dtype=np.int64)
        k = uniq.copy()
        for d in range(self.dim):
            verts[:, d] = k % (self.res[d] + 1)
            k //= (self.res[d] + 1)
        ev = inv.reshape(self.nelements, self.ncorners)
        self._vertex_cache = (verts, ev)
        return self._vertex_cache

    def _lattice_strides(self):
        st = np.ones(self.dim, dtype=np.int64)
        for d in range(1, self.dim):
            st[d] = st[d - 1] * (self.res[d - 1] + 1)
        return st

    @property
    def nvertices(self):
        return len(self.vertices()[0])

    def element_vertex_indices(self):
        return self.vertices()[1]

    def vertex_coords(self) -> np.ndarray:
        return self.lower + self.vertices()[0] * self.h_fine

    def boundary_vertex_mask(self) -> np.ndarray:
        v = self.vertices()[0]
        m = np.zeros(len(v), dtype=bool)
        for d in range(self.dim):
            m |= (v[:, d] == 0) | (v[:, d] == self.res[d])
        return m

    # -- leaf lookup ------------------------------------------------------
    def find_leaf(self, lattice_cell) -> int | None:
        """Leaf element containing finest-lattice cell `lattice_cell`
        (coordinates of the cell's lower corner, all in [0, res))."""
        p = np.asarray(lattice_cell, dtype=np.int64)
        if np.any(p < 0) or np.any(p >= self.res):
            return None
        for lvl in range(self.max_level, -1, -1):
            s = self.cell_size(lvl)
            org = (p // s) * s
            e = self._leaf.get((lvl, tuple(org)))
            if e is not None:
                return e
        return None

    def locate(self, points):
        """(elem (n,), ref (n, dim)): containing leaf + reference coords."""
        pts = np.atleast_2d(np.asarray(points, dtype=np.float64))
        rel = (pts - self.lower) / self.h_fine
        cell = np.clip(np.floor(rel).astype(np.int64), 0, self.res - 1)
        elems = np.empty(len(pts), dtype=np.int64)
        ref = np.empty_like(rel)
        for i in range(len(pts)):
            e = self.find_leaf(cell[i])
            assert e is not None, (pts[i], cell[i])
            elems[i] = e
            s = self.cell_size(self.levels[e])
            ref[i] = (rel[i] - self.origins[e]) / s
        return elems, np.clip(ref, 0.0, 1.0)

    # -- hanging nodes -----------------------------------------------------
    def hanging_constraints(self):
        """Affine rows for hanging vertices (reference: hangingnode.hh:24).

        Returns (rows (M,), cols (M,), weights (M,)) with vertex ids:
        value[row] = sum of weight * value[col]; parents are transitively
        resolved so no col is itself hanging. A vertex v is hanging iff some
        leaf whose closure contains v does not have v as a corner; the
        constraint entity is the minimal face/edge of that (coarser) leaf
        containing v, parents = its corners with weights (1/2)^#mid-axes.
        The rows are computed once per mesh and kept (the mesh does not
        change; callers get copies).
        """
        if self._hanging_cache is None:
            self._hanging_cache = self._hanging_rows()
        return tuple(a.copy() for a in self._hanging_cache)

    def _leaves_of(self, cells):
        """find_leaf for an (n, dim) array of finest-lattice cells at once:
        the leaf element of each, -1 outside the lattice. The leaves
        partition the lattice, so at most one level matches; as in
        find_leaf, the finest match is taken."""
        P = int(np.prod(self.res))
        strides = np.cumprod(np.concatenate([[1], self.res[:-1]])).astype(np.int64)
        keys = self.levels * P + self.origins @ strides
        order = np.argsort(keys)
        skeys = keys[order]
        out = np.full(len(cells), -1, np.int64)
        inside = np.all((cells >= 0) & (cells < self.res), axis=1)
        for lvl in range(self.max_level, -1, -1):
            s = self.cell_size(lvl)
            k = lvl * P + ((cells // s) * s) @ strides
            pos = np.minimum(np.searchsorted(skeys, k), len(skeys) - 1)
            hit = inside & (out < 0) & (skeys[pos] == k)
            out[hit] = order[pos[hit]]
        return out

    def _hanging_rows(self):
        verts, ev = self.vertices()
        nv = len(verts)
        raw = {}   # vertex id -> list[(parent vertex lattice tuple, w)]
        vid = {tuple(p): i for i, p in enumerate(verts)}

        # leaves incident to each vertex v: those containing one of the up
        # to 2^dim finest-lattice cells around it (the reference's per-vertex
        # find_leaf loop, as array work). Among the leaves for which v is not
        # a corner, v is constrained against the COARSEST (largest) one, with
        # the minimal entity (fewest mid-axes), then the lowest element, as
        # tie-breaks: the reference's min over (-(cell size), n_mid, element).
        doffs = np.array(list(itertools.product((-1, 0), repeat=self.dim)), np.int64)
        cells = (verts[:, None, :] + doffs[None]).reshape(-1, self.dim)
        el = self._leaves_of(cells).reshape(nv, len(doffs))
        found = el >= 0
        e = np.where(found, el, 0)
        corner = (ev[e] == np.arange(nv)[:, None, None]).any(axis=2)
        size = 2 ** (self.max_level - self.levels[e])                 # (nv, K)
        rel2 = 2 * (verts[:, None, :] - self.origins[e])              # (nv, K, dim)
        nmid = (rel2 == size[..., None]).sum(axis=2)
        cand = found & ~corner & (nmid > 0)
        E = max(self.nelements, 1)
        key = ((2 ** self.max_level - size) * (self.dim + 1) + nmid) * E + e
        key = np.where(cand, key, np.iinfo(np.int64).max)
        pick = key.argmin(axis=1)
        for i in np.nonzero(cand.any(axis=1))[0]:
            p = verts[i]
            e = int(el[i, pick[i]])
            s = self.cell_size(self.levels[e])
            rel2 = 2 * (p - self.origins[e])
            assert np.all(rel2 >= 0) and np.all(rel2 <= 2 * s)
            mid = rel2 == s                        # mid-axes
            fixed = rel2 // s // 2                 # 0 or 1 on non-mid axes
            parents = []
            w = 0.5 ** int(mid.sum())
            for bits in itertools.product((0, 1), repeat=int(mid.sum())):
                q = self.origins[e].copy()
                bi = 0
                for d in range(self.dim):
                    if mid[d]:
                        q[d] += s * bits[bi]
                        bi += 1
                    else:
                        q[d] += s * fixed[d]
                parents.append((tuple(q), w))
            raw[int(i)] = parents

        # transitive resolution: parents at coarser levels may themselves
        # be hanging (level chains across corners); substitute to fixpoint
        def resolve(i, depth=0):
            assert depth <= self.max_level + 1, "hanging-constraint cycle"
            out = {}
            for (q, w) in raw[i]:
                j = vid[q]
                if j in raw:
                    for (q2, w2) in resolve(j, depth + 1).items():
                        out[q2] = out.get(q2, 0.0) + w * w2
                else:
                    out[q] = out.get(q, 0.0) + w
            return out

        rows, cols, weights = [], [], []
        for i in sorted(raw):
            for (q, w) in sorted(resolve(i).items()):
                rows.append(i)
                cols.append(vid[q])
                weights.append(w)
        return (np.array(rows, np.int64), np.array(cols, np.int64),
                np.array(weights, np.float64))

    # -- refinement --------------------------------------------------------
    def refine(self, marks) -> "AdaptiveMesh":
        """Split marked leaves into 2^dim children; enforce 2:1 balance
        across faces by closure (refining coarse neighbors as needed)."""
        marks = np.asarray(marks, dtype=bool)
        assert marks.shape == (self.nelements,)
        new_max = self.max_level + (
            1 if np.any(marks & (self.levels == self.max_level)) else 0)
        scale = 2 ** (new_max - self.max_level)

        # work set: dict {(level, origin tuple at NEW resolution)} of leaves
        cells = {}
        for e in range(self.nelements):
            cells[(int(self.levels[e]), tuple(self.origins[e] * scale))] = \
                bool(marks[e])

        def size_at(lvl):
            return 2 ** (new_max - lvl)

        res = np.array(self.coarse_cells, np.int64) * (2 ** new_max)

        # iterative: split marked cells, then mark coarse face-neighbors of
        # any cell whose neighbor got 2+ levels finer
        changed = True
        while changed:
            # split pass
            nxt = {}
            for (lvl, org), m in cells.items():
                if m:
                    s = size_at(lvl) // 2
                    for bits in itertools.product((0, 1), repeat=self.dim):
                        child = tuple(o + s * b for o, b in zip(org, bits))
                        nxt[(lvl + 1, child)] = False
                else:
                    nxt[(lvl, org)] = False
            cells = nxt
            # balance pass: find cells with a face neighbor 2+ levels finer
            changed = False
            index = {k: True for k in cells}

            def leaf_at(point, max_lvl):
                """leaf containing lattice cell `point`, or None."""
                if any(p < 0 or p >= r for p, r in zip(point, res)):
                    return None
                for lv in range(max_lvl, -1, -1):
                    s = size_at(lv)
                    org = tuple((p // s) * s for p in point)
                    if (lv, org) in index:
                        return (lv, org)
                return None

            max_lvl_present = max(l for (l, _) in cells)
            for (lvl, org) in list(cells.keys()):
                if cells[(lvl, org)]:
                    continue
                s = size_at(lvl)
                for d in range(self.dim):
                    for side in (-1, 1):
                        probe = list(org)
                        probe[d] += -1 if side == -1 else s
                        nb = leaf_at(tuple(probe), max_lvl_present)
                        if nb is not None and nb[0] > lvl + 1:
                            cells[(lvl, org)] = True
                            changed = True
                            break
                    if cells[(lvl, org)]:
                        break

        levels = np.array([l for (l, _) in cells], dtype=np.int64)
        origins = np.array([o for (_, o) in cells], dtype=np.int64)
        order = np.lexsort(tuple(origins[:, d]
                                 for d in range(self.dim - 1, -1, -1)))
        return AdaptiveMesh(self.lower, self.upper, self.coarse_cells,
                            levels=levels[order], origins=origins[order],
                            max_level=new_max)

    def coarsen(self, marks) -> "AdaptiveMesh":
        """Merge sibling groups back into their parent (the coarsen
        direction of the reference's mark_grid/adapt_grid, reference:
        dune/pdelab/adaptivity/adaptivity.hh:1029,632).

        Conservative semantics matching dune-grid: a parent is un-refined
        only when ALL 2^dim children are leaves and ALL are marked; merges
        that would break 2:1 face balance (leaving a neighbor 2+ levels
        finer) are cancelled."""
        marks = np.asarray(marks, dtype=bool)
        assert marks.shape == (self.nelements,)
        leaf_marked = {
            (int(self.levels[e]), tuple(self.origins[e])): bool(marks[e])
            for e in range(self.nelements)
        }
        # candidate parents: all 2^dim children present + marked
        merges = set()
        for (lvl, org), m in leaf_marked.items():
            if not m or lvl == 0:
                continue
            s = self.cell_size(lvl)
            porg = tuple((o // (2 * s)) * (2 * s) for o in org)
            if all(
                leaf_marked.get(
                    (lvl, tuple(p + s * b for p, b in zip(porg, bits))),
                    False)
                for bits in itertools.product((0, 1), repeat=self.dim)
            ):
                merges.add((lvl - 1, porg))

        def children_of(lvl, org):
            s = self.cell_size(lvl + 1)
            return [(lvl + 1, tuple(o + s * b for o, b in zip(org, bits)))
                    for bits in itertools.product((0, 1), repeat=self.dim)]

        # apply merges, then cancel any that break 2:1 balance (a cancel
        # only makes neighbors finer-side happy, so iterate to fixpoint)
        while True:
            leaves = dict(leaf_marked)
            for p in merges:
                for c in children_of(*p):
                    leaves.pop(c, None)
                leaves[p] = False
            index = set(leaves)

            def leaf_level_at(point):
                if any(q < 0 or q >= r for q, r in zip(point, self.res)):
                    return None
                for lv in range(self.max_level, -1, -1):
                    s = self.cell_size(lv)
                    org = tuple((q // s) * s for q in point)
                    if (lv, org) in index:
                        return lv
                return None

            cancelled = set()
            for (lvl, org) in merges:
                s = self.cell_size(lvl)
                bad = False
                for d in range(self.dim):
                    for side in (-1, 1):
                        # probe a line of fine cells along the face
                        for bits in itertools.product(
                                (0, 1), repeat=self.dim):
                            probe = [o + (s // 2) * b
                                     for o, b in zip(org, bits)]
                            probe[d] = org[d] - 1 if side == -1 \
                                else org[d] + s
                            nb = leaf_level_at(tuple(probe))
                            if nb is not None and nb > lvl + 1:
                                bad = True
                                break
                        if bad:
                            break
                    if bad:
                        break
                if bad:
                    cancelled.add((lvl, org))
            if not cancelled:
                break
            merges -= cancelled

        levels = np.array([l for (l, _) in leaves], dtype=np.int64)
        origins = np.array([o for (_, o) in leaves], dtype=np.int64)
        order = np.lexsort(tuple(origins[:, d]
                                 for d in range(self.dim - 1, -1, -1)))
        new_max = int(levels.max()) if len(levels) else 0
        scale = 2 ** (self.max_level - new_max)
        return AdaptiveMesh(self.lower, self.upper, self.coarse_cells,
                            levels=levels[order],
                            origins=origins[order] // scale,
                            max_level=new_max)

    def __repr__(self):
        lv, ct = np.unique(self.levels, return_counts=True)
        dist = ", ".join(f"L{int(l)}:{int(c)}" for l, c in zip(lv, ct))
        return (f"AdaptiveMesh(dim={self.dim}, coarse={self.coarse_cells}, "
                f"E={self.nelements} [{dist}])")
