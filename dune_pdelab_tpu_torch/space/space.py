"""Discrete function spaces: DOF maps as lattice arithmetic.

PyTorch port of dune_pdelab_tpu/space/space.py. Leaves: continuous (C0)
Qk on the DOF lattice of a structured cube mesh (a periodic axis wraps its
last DOF plane onto the first), Q1 on the vertices of an AdaptiveMesh
(hanging vertices are DOFs, constrained by affine rows), discontinuous (DG) Qk
numbered element-major, DOF e*nb + j for local basis function j of element
e, and continuous Pk on a simplex mesh, numbered [vertices | edge
interiors | face interiors | cell interiors] (`_build_simplex_c0_map`).
H(div) and H(curl) layouts wait for ROADMAP slice 13.

Composite spaces (reference: powergridfunctionspace.hh /
compositegridfunctionspace.hh, e.g. Taylor-Hood = Composite(Power<dim>(Q2),
Q1)) are trees of leaf spaces over one flat DOF vector. Children are placed
by an ordering: 'lexicographic' (child-major, reference:
ordering/lexicographicordering.hh:105), 'interleaved' or 'entity_blocked'
(per DOF, equal-size children, interleavedordering.hh:28), a permutation
(PermutedSpace, permutedordering.hh) or the heterogeneous entity blocking
of `entity_blocked` (entityblockedlocalordering.hh:33).

Setup stays numpy on the host, as in the reference. The (E, nlocal)
`element_dofs` map is built lazily: the structured fast paths
(SlicedDofMap, ReshapeDofMap, compiled stencils) never touch it, and at
512^3 DOFs it would cost about 8.5 GB of host memory.
"""
from __future__ import annotations

import numpy as np
import torch

from dune_pdelab_tpu_torch.fe.basis import (
    FiniteElement, geometry_element, lagrange_nodes_1d,
)
from dune_pdelab_tpu_torch.mesh.structured import StructuredMesh
from dune_pdelab_tpu_torch.utils.common import default_float, device_key, resolve_device


def to_numpy(v) -> np.ndarray:
    """numpy view of a user callback result (tensor, array or scalar)."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


class FunctionSpace:
    """Leaf discrete space: mesh x finite element -> DOF map.

    Attributes:
      mesh, fem
      ndofs:         global number of DOFs
      element_dofs:  (E, nlocal) int64 numpy, local->global DOF map (lazy)
    """

    is_leaf = True

    def __init__(self, mesh: StructuredMesh, fem: FiniteElement, name: str = ""):
        if fem.geometry != mesh.geometry_type:
            raise ValueError(f"{fem} does not fit mesh geometry {mesh.geometry_type}")
        if fem.continuity not in ("C0", "DG"):
            raise NotImplementedError(
                f"{fem.continuity} spaces are not ported yet (H(div)/H(curl): "
                "ROADMAP slice 13)")
        self.mesh = mesh
        self.fem = fem
        self.name = name
        self._element_dofs = None
        if hasattr(mesh, "hanging_constraints"):          # AdaptiveMesh
            if fem.continuity != "C0" or fem.degree != 1:
                raise NotImplementedError(
                    "adaptive meshes support Q1 spaces (the reference's "
                    "hanging-node constraint assemblers are likewise Q1/P1 "
                    "only, dune/pdelab/constraints/hangingnode.hh:24)")
            self._element_dofs = np.asarray(mesh.element_vertex_indices(), np.int64)
            self._dof_grid_dims = None
            self.ndofs = mesh.nvertices
        elif fem.continuity == "DG":
            self._dof_grid_dims = None
            self.ndofs = mesh.nelements * fem.nbasis
        elif mesh.geometry_type == "simplex":
            self._element_dofs = self._build_simplex_c0_map()
            self._dof_grid_dims = None
            self.ndofs = int(self._element_dofs.max()) + 1
        else:
            self._dof_grid_dims = self._c0_dims()
            self.ndofs = int(np.prod(self._dof_grid_dims))

    @property
    def element_dofs(self) -> np.ndarray:
        """(E, nlocal) local->global DOF map (built on first use)."""
        if self._element_dofs is None:
            if self.fem.continuity == "DG":
                nb = self.fem.nbasis
                self._element_dofs = (
                    np.arange(self.mesh.nelements, dtype=np.int64)[:, None] * nb
                    + np.arange(nb, dtype=np.int64)[None, :])
            else:
                self._element_dofs = self._build_c0_map()[0]
        return self._element_dofs

    def _c0_dims(self):
        """Per-axis DOF-grid sizes of the tensor C0 layout."""
        if not hasattr(self.fem, "_mi"):
            raise NotImplementedError(
                f"C0 DOF layout requires a tensor nodal element, got {self.fem}")
        k = self.fem.degree
        # a periodic axis identifies its last DOF plane with the first
        return tuple(k * c if p else k * c + 1
                     for c, p in zip(self.mesh.cells, self.mesh.periodic))

    def _build_c0_map(self):
        mesh, fem = self.mesh, self.fem
        k = fem.degree
        dims = self._c0_dims()
        strides = np.ones(mesh.dim, dtype=np.int64)
        for d in range(1, mesh.dim):
            strides[d] = strides[d - 1] * dims[d - 1]
        emi = mesh.element_multi_index()           # (E, dim)
        g = k * emi[:, None, :] + fem._mi[None, :, :]  # (E, nloc, dim)
        g = np.mod(g, np.array(dims))              # wraps on periodic axes only
        return g @ strides, dims

    def _build_simplex_c0_map(self):
        """Conforming Pk DOF map on a simplex mesh, any k (reference:
        dune/pdelab/finiteelementmap/pkfem.hh).

        Each PkFEM lattice node is classified by its integer barycentric
        coordinates n_i = k*lambda_i (sum n_i = k):
          * one n_i = k          -> vertex DOF (mesh vertex id);
          * two nonzero          -> edge DOF; the k-1 interior nodes of each
            unique edge are ordered along the GLOBAL edge direction
            (ascending global vertex id), so both adjacent elements agree;
          * three nonzero in 3D  -> face DOF, indexed by its barycentric
            weights w.r.t. the face's SORTED global vertex triple;
          * all nonzero          -> cell-interior DOF (element-private).

        Global numbering: [vertices | edge interiors | face interiors (3D) |
        cell interiors]."""
        mesh, fem = self.mesh, self.fem
        k = fem.degree
        dim = mesh.dim
        cells = mesh.cells
        E = mesh.nelements
        nv = mesh.nvertices
        # integer barycentrics of the Pk lattice nodes; geometry corner
        # convention (PkFEM(1, dim).nodes): lambda_0 = 1 - sum x,
        # lambda_j = x[dim - j] for j = 1..dim
        bary = np.zeros((fem.nbasis, dim + 1))
        bary[:, 0] = 1.0 - fem.nodes.sum(axis=1)
        for j in range(1, dim + 1):
            bary[:, j] = fem.nodes[:, dim - j]
        n_int = np.rint(k * bary).astype(np.int64)        # (nb, dim+1)
        assert np.all(n_int.sum(axis=1) == k)

        ne_per = k - 1
        edge_base = nv
        face_base = edge_base
        if ne_per:                       # P1 has no edge DOFs: skip the edge list
            uniq_edges, cell_edges = mesh.edges()
            pairs = mesh._edge_pairs
            face_base += len(uniq_edges) * ne_per
        nfi = (k - 1) * (k - 2) // 2 if dim == 3 else 0
        if nfi:
            uniq_faces, face_of, _ = mesh.faces()
            # rank of an interior face node by (m0, m1), its barycentric
            # weights w.r.t. the two smallest global vertex ids
            franks = np.full((k, k), -1, np.int64)
            c = 0
            for m0 in range(1, k):
                for m1 in range(1, k - m0):
                    franks[m0, m1] = c
                    c += 1
            cell_base = face_base + len(uniq_faces) * nfi
        else:
            cell_base = face_base
        n_cell = int(np.sum(np.all(n_int >= 1, axis=1)))  # interior per cell

        cols = []
        n_interior_seen = 0
        for b in range(fem.nbasis):
            n = n_int[b]
            nz = np.nonzero(n)[0]
            if len(nz) == 1:                              # vertex
                cols.append(cells[:, nz[0]])
            elif len(nz) == 2:                            # edge interior
                a, bb = int(nz[0]), int(nz[1])            # a < bb
                eloc = pairs.index((a, bb))
                j = int(n[bb])                            # parameter from a
                jg = np.where(cells[:, a] < cells[:, bb], j - 1, k - 1 - j)
                cols.append(edge_base + cell_edges[:, eloc] * ne_per + jg)
            elif dim == 3 and len(nz) == 3:               # face interior
                opp = int(np.setdiff1d(np.arange(4), nz)[0])
                order = np.argsort(cells[:, nz], axis=1)  # sorted positions
                w = n[nz][order]                          # weights, sorted-global order
                cols.append(face_base + face_of[:, opp] * nfi
                            + franks[w[:, 0], w[:, 1]])
            else:                                         # cell interior
                cols.append(cell_base + np.arange(E, dtype=np.int64) * n_cell
                            + n_interior_seen)
                n_interior_seen += 1
        return np.stack(cols, axis=1).astype(np.int64)

    def boundary_dof_mask(self) -> np.ndarray:
        """(ndofs,) bool mask of DOFs on the domain boundary."""
        return _leaf_boundary_dof_mask(self)

    # -- tree protocol shared with CompositeSpace (used by the assembler) ------
    @property
    def leaves(self):
        return (self,)

    @property
    def leaf_offsets(self):
        return (0,)

    def local_sizes(self):
        return (self.fem.nbasis,)

    def global_element_dofs(self):
        """(E, nlocal) global DOF indices, offsets applied (leaf: identity)."""
        return self.element_dofs

    # -- node coordinates & interpolation ------------------------------------
    def dof_coords(self) -> np.ndarray:
        """(ndofs, dim) nodal coordinates: lattice arithmetic for a C0
        lattice space on a uniform non-periodic mesh, else the element node
        positions scattered through the DOF map (conforming elements agree
        on shared entities; on a periodic axis the wrap elements write the
        identified plane last, with their unwrapped positions, as in the
        reference)."""
        if (self._dof_grid_dims is not None and self.mesh.uniform
                and not any(self.mesh.periodic)):
            return self.dof_coords_at(np.arange(self.ndofs, dtype=np.int64))
        pts = self._geometry_at(np.atleast_2d(self.fem.interpolation_points))
        coords = np.empty((self.ndofs, self.mesh.dim))
        coords[self.element_dofs.reshape(-1)] = pts.reshape(-1, self.mesh.dim)
        return coords

    def dof_coords_at(self, idx: np.ndarray) -> np.ndarray:
        """(len(idx), dim) nodal coordinates of selected DOFs, by lattice
        arithmetic on a C0 lattice space of a uniform mesh (no per-element
        geometry sweep)."""
        if self._dof_grid_dims is None or not self.mesh.uniform:
            return self.dof_coords()[np.asarray(idx)]
        k = self.fem.degree
        nodes1d = lagrange_nodes_1d(k)
        dims = self._dof_grid_dims
        g = np.asarray(idx, dtype=np.int64)
        out = np.empty((len(g), self.mesh.dim))
        for d in range(self.mesh.dim):
            gd = g % dims[d]
            g = g // dims[d]
            out[:, d] = self.mesh.lower[d] + self.mesh.h[d] * (
                gd // k + nodes1d[gd % k])
        return out

    def _geometry_at(self, ref_points: np.ndarray) -> np.ndarray:
        """Map reference points into every element: (E, npts, dim)."""
        corners = self.mesh.element_corner_coords()    # (E, C, dim)
        vals, _ = geometry_element(self.mesh.geometry_type,
                                   self.mesh.dim).tabulate(ref_points)
        return np.einsum("pc,ecd->epd", vals, corners)

    def interpolate(self, f, dtype=None, device=None):
        """Interpolate a callable f(x) -> scalar into a DOF vector.

        f receives a float64 CPU tensor of points (npts, dim) and returns
        a tensor, array or scalar; a complex f gives a complex vector (dtype
        promoted with the values', as in the reference). Analog of `Dune::PDELab::interpolate`
        (reference: dune/pdelab/gridfunctionspace/interpolate.hh:177).
        """
        pts = self._geometry_at(np.atleast_2d(self.fem.interpolation_points))
        flat = pts.reshape(-1, pts.shape[-1])
        v = to_numpy(f(torch.from_numpy(flat)))
        fvals = np.broadcast_to(v, (flat.shape[0],)).reshape(pts.shape[:-1])
        coeffs = np.einsum("bi,ei->eb", self.fem.interpolation_matrix, fvals)
        dtype = dtype or default_float()
        if np.iscomplexobj(coeffs):                    # complex-valued f
            dtype = torch.promote_types(dtype, torch.from_numpy(coeffs[:0, :0]).dtype)
        x = np.zeros(self.ndofs, dtype=coeffs.dtype)
        x[self.element_dofs.reshape(-1)] = coeffs.reshape(-1)
        return torch.as_tensor(x, dtype=dtype, device=resolve_device(device))

    def zero(self, dtype=None, device=None):
        """Zero DOF vector on `device` (default: utils/common.default_device)."""
        return torch.zeros(self.ndofs, dtype=dtype or default_float(),
                           device=resolve_device(device))

    def __repr__(self):
        return f"FunctionSpace({self.fem!r}, ndofs={self.ndofs}, name={self.name!r})"


def _embed(x, index, xc):
    """x with x[index] = xc, as a new tensor (the reference's functional
    `.at[index].set`)."""
    y = x.clone()
    y[index] = xc.to(y.dtype)
    return y


class CompositeSpace:
    """Heterogeneous product space (CompositeGridFunctionSpace analog).

    One flat DOF vector; children are mapped in by `ordering`:
      'lexicographic'  - children stacked child-major
      'interleaved'    - equal-size children interleaved per DOF
      'entity_blocked' - as 'interleaved', on one shared mesh (with equal
         children each lattice entity carries one DOF of every child)
    `chunk` declares a uniform block size over the flat index space
    (reference: ordering/chunkedblockordering.hh:112), read by `block_view`.
    """

    is_leaf = False

    def __init__(self, *children, ordering: str = "lexicographic",
                 name: str = "", chunk: int | None = None):
        if not children:
            raise ValueError("CompositeSpace needs at least one child")
        self.children = tuple(children)
        self.ordering = ordering
        self.name = name
        sizes = [c.ndofs for c in self.children]
        self.ndofs = sum(sizes)
        if ordering == "lexicographic":
            offs = np.concatenate([[0], np.cumsum(sizes)[:-1]])
            self._child_offset = offs.astype(np.int64)
        elif ordering in ("interleaved", "entity_blocked"):
            if len(set(sizes)) != 1:
                raise ValueError(f"{ordering} ordering needs equal-size children")
            if ordering == "entity_blocked":
                meshes = {id(lf.mesh) for c in self.children for lf in c.leaves}
                if len(meshes) != 1:
                    raise ValueError("entity_blocked needs one shared mesh")
            self._child_offset = None
        else:
            raise ValueError(f"unknown ordering {ordering!r}")
        self.chunk = chunk
        if chunk is not None:
            if self.ndofs % chunk:
                raise ValueError(f"chunk size {chunk} does not divide ndofs {self.ndofs}")
            self.nchunks = self.ndofs // chunk

    def block_view(self, x):
        """(nchunks, chunk) view of a flat vector (chunked descriptor)."""
        if self.chunk is None:
            raise ValueError("space has no chunked blocking descriptor")
        return x.reshape(self.nchunks, self.chunk)

    @property
    def nchildren(self):
        return len(self.children)

    def child_global(self, i: int, child_dofs: np.ndarray) -> np.ndarray:
        """Map child-i DOF indices to flat global indices."""
        if self.ordering == "lexicographic":
            return self._child_offset[i] + child_dofs
        return child_dofs * self.nchildren + i

    @property
    def leaves(self):
        return tuple(lf for c in self.children for lf in c.leaves)

    def leaf_element_dofs(self):
        """One (E, nlocal) global DOF map per leaf, offsets applied."""
        out = []
        for i, c in enumerate(self.children):
            maps = ([c.element_dofs.astype(np.int64)] if c.is_leaf
                    else c.leaf_element_dofs())
            out.extend(self.child_global(i, m) for m in maps)
        return out

    def local_sizes(self):
        return tuple(n for c in self.children for n in c.local_sizes())

    def _child_index(self, i: int):
        if self.ordering == "lexicographic":
            o = int(self._child_offset[i])
            return slice(o, o + self.children[i].ndofs)
        return slice(i, None, self.nchildren)

    def restrict(self, x, i: int):
        """Child i's DOF subvector of the flat vector (a view)."""
        return x[self._child_index(i)]

    def embed(self, x, i: int, xc):
        """x with child i's subvector replaced by xc (a new tensor)."""
        return _embed(x, self._child_index(i), xc)

    def interpolate(self, fs, dtype=None, device=None):
        """Interpolate a tuple of callables (one per child) into a flat vector."""
        parts = [c.interpolate(f, dtype=dtype, device=device)
                 for c, f in zip(self.children, fs)]
        x = torch.zeros(self.ndofs, dtype=parts[0].dtype, device=parts[0].device)
        for i, xc in enumerate(parts):
            x = self.embed(x, i, xc)
        return x

    def zero(self, dtype=None, device=None):
        return torch.zeros(self.ndofs, dtype=dtype or default_float(),
                           device=resolve_device(device))

    def __repr__(self):
        return (f"CompositeSpace({', '.join(map(repr, self.children))}, "
                f"ordering={self.ordering!r})")


class PermutedSpace(CompositeSpace):
    """Permuted ordering wrapper (reference: ordering/permutedordering.hh):
    global index = perm[inner index] for any bijection perm on [0, ndofs).
    Assembly, constraints and solves all see the permuted layout."""

    def __init__(self, child, perm, name: str = ""):
        super().__init__(child, ordering="lexicographic", name=name)
        perm = np.asarray(perm, dtype=np.int64)
        if perm.shape != (child.ndofs,):
            raise ValueError("perm must have one entry per dof")
        self.perm = perm
        inv = np.empty_like(perm)
        inv[perm] = np.arange(len(perm), dtype=np.int64)
        self.inv_perm = inv
        self._perms = {}

    def _perm_on(self, device):
        key = device_key(device)
        if key not in self._perms:
            self._perms[key] = torch.as_tensor(self.perm, device=device)
        return self._perms[key]

    def child_global(self, i: int, child_dofs):
        return self.perm[np.asarray(child_dofs, dtype=np.int64)]

    def restrict(self, x, i: int = 0):
        """Inner-ordered copy of the permuted flat vector."""
        return x[self._perm_on(x.device)]

    def embed(self, x, i: int, xc):
        return _embed(x, self._perm_on(x.device), xc)

    def interpolate(self, f, dtype=None, device=None):
        xc = self.children[0].interpolate(f, dtype=dtype, device=device)
        return self.embed(torch.zeros_like(xc), 0, xc)

    def __repr__(self):
        return f"PermutedSpace({self.children[0]!r})"


class PowerSpace(CompositeSpace):
    """k identical copies of a child space (PowerGridFunctionSpace analog,
    reference: gridfunctionspace/powergridfunctionspace.hh)."""

    def __init__(self, child, k: int, ordering: str = "lexicographic", name: str = ""):
        super().__init__(*([child] * k), ordering=ordering, name=name)
        self.child = child
        self.k = k

    def interpolate(self, f, dtype=None, device=None):
        """f: a tuple of callables, or one callable returning (npts, k)."""
        fs = ([(lambda pts, i=i: to_numpy(f(pts))[..., i]) for i in range(self.k)]
              if callable(f) else f)
        return super().interpolate(fs, dtype=dtype, device=device)


def VectorSpace(mesh, fem, ncomp=None, ordering="lexicographic", name=""):
    """Vector-valued space (VectorGridFunctionSpace analog, reference:
    gridfunctionspace/vectorgridfunctionspace.hh:33)."""
    return PowerSpace(FunctionSpace(mesh, fem), ncomp or mesh.dim,
                      ordering=ordering, name=name)


def entity_blocked(space: CompositeSpace, name: str = "") -> PermutedSpace:
    """Heterogeneous entity-blocked ordering (reference:
    ordering/entityblockedlocalordering.hh:33,155): per-entity blocks of all
    children's DOFs with a block size that varies by entity (Taylor-Hood:
    (vx, vy, p) at vertices, (vx, vy) at Q2-only nodes).

    Works for any composite tree of nodal C0 leaves on one shared mesh:
    DOFs are grouped by nodal coordinate (the entity's position), entity
    after entity, with the tree's leaf order inside each block. Returns a
    PermutedSpace carrying `entity_block_sizes` (one entry per entity, in
    layout order)."""

    def leaf_globals(s):
        if s.is_leaf:
            return [(np.arange(s.ndofs, dtype=np.int64), s)]
        return [(s.child_global(i, idx), lf)
                for i, c in enumerate(s.children) for idx, lf in leaf_globals(c)]

    pairs = leaf_globals(space)
    if len({id(lf.mesh) for _, lf in pairs}) != 1:
        raise ValueError("entity_blocked needs one shared mesh")
    coords = np.empty((space.ndofs, pairs[0][1].mesh.dim))
    rank = np.empty(space.ndofs, dtype=np.int64)
    for r, (gidx, lf) in enumerate(pairs):
        if lf.fem.nodes is None or lf.fem.continuity != "C0":
            raise NotImplementedError("entity_blocked permutation needs nodal C0 leaves")
        coords[gidx] = lf.dof_coords()
        rank[gidx] = r
    # quantize coordinates so shared-entity nodes compare equal
    h_min = np.min([np.min(lf.mesh.h) if lf.mesh.uniform else 1.0 for _, lf in pairs])
    q = np.round(coords / (1e-6 * h_min)).astype(np.int64)
    # entity-major (lexsort: the last key is primary), leaf rank fastest
    order = np.lexsort((rank,) + tuple(q[:, d] for d in range(q.shape[1])))
    perm = np.empty(space.ndofs, dtype=np.int64)
    perm[order] = np.arange(space.ndofs)
    out = PermutedSpace(space, perm, name=name or space.name)
    qs = q[order]
    newblock = np.any(qs[1:] != qs[:-1], axis=1)
    starts = np.concatenate([[0], np.nonzero(newblock)[0] + 1, [space.ndofs]])
    out.entity_block_sizes = np.diff(starts)
    return out


def _leaf_boundary_dof_mask(space: FunctionSpace) -> np.ndarray:
    """(ndofs,) bool mask of DOFs on the domain boundary.

    Face-slice writes on the nd view: O(surface) work, no O(N) index
    arithmetic.
    """
    if space.mesh.geometry_type == "simplex" and space.fem.continuity == "C0":
        return _simplex_boundary_dof_mask(space)
    if hasattr(space.mesh, "hanging_constraints"):      # AdaptiveMesh (Q1)
        return space.mesh.boundary_vertex_mask()
    dims = space._dof_grid_dims
    if dims is None:
        raise NotImplementedError(
            "boundary DOF masks exist for C0 lattice spaces only; DG boundary "
            "conditions are weak (face terms of the local operator)")
    dim = space.mesh.dim
    mask = np.zeros(tuple(reversed(dims)), dtype=bool)  # C-order, dim0 last
    for d in range(dim):
        if space.mesh.periodic[d]:
            continue
        ax = dim - 1 - d
        sl = [slice(None)] * dim
        sl[ax] = 0
        mask[tuple(sl)] = True
        sl[ax] = dims[d] - 1
        mask[tuple(sl)] = True
    return mask.reshape(-1)


def _simplex_boundary_dof_mask(space: FunctionSpace) -> np.ndarray:
    """Boundary DOFs of a Pk simplex space: boundary vertices, the interior
    nodes of boundary edges (k >= 2) and of boundary faces (3D, k >= 3), in
    the numbering of `_build_simplex_c0_map`."""
    mesh, k = space.mesh, space.fem.degree
    mask = np.zeros(space.ndofs, dtype=bool)
    nv = mesh.nvertices
    mask[:nv] = mesh.boundary_vertex_mask()[:min(nv, space.ndofs)]
    base = nv
    if k >= 2 and space.ndofs > nv:
        em = mesh.boundary_edge_mask()
        mask[base:base + len(em) * (k - 1)] = np.repeat(em, k - 1)
        base += len(em) * (k - 1)
    if mesh.dim == 3 and k >= 3:
        fm = mesh.boundary_face_mask()
        nfi = (k - 1) * (k - 2) // 2
        mask[base:base + len(fm) * nfi] = np.repeat(fm, nfi)
    return mask
