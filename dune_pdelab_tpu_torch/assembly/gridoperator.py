"""GridOperator: global residual / Jacobian-apply as batched kernels.

PyTorch port of dune_pdelab_tpu/assembly/gridoperator.py for leaf and
composite spaces on structured (uniform, periodic or mapped), locally
refined (AdaptiveMesh, hanging nodes) and simplex meshes (reference:
dune/pdelab/gridoperator/gridoperator.hh:35-240 facade,
gridoperator/default/assembler.hh:84-279 element and intersection sweep):

  * the element loop becomes one batched gather, one batched kernel call and
    one scatter-add over all elements; faces are grouped, one batched kernel
    call per group. On a structured mesh a group is the faces normal to one
    axis (and side, on the boundary): a slab of the element grid, so a DG
    leaf moves its face coefficients by slices (SlabFaceTransfer, rolled by
    one cell on a periodic axis), a C0 leaf by index arrays
    (IndexFaceTransfer). On a simplex mesh faces are grouped by their
    local-embedding configuration (`_build_simplex_face_groups`), so basis
    values are shared per group while normals, measures and physical
    gradients vary per face; a mapped cube mesh keeps the axis groups with
    per-face geometry (Nanson's formula, `_mapped_*_geometry`);
  * `jacobian_apply` is torch.func.jvp of the residual (the reference's
    jax.jvp), face terms included, not a finite difference;
  * constrained rows are zeroed in the residual and act as identity in J;
    hanging-node (affine) constraints prolong the arguments and restrict
    the result, r = P^T R(P x) (the reference's etadd triple product).

`element_jacobians`, `element_diagonal_blocks`, the assembled `jacobian` (a
sparse COO tensor; `jacobian_csr` hands it to host scipy) and
`jacobian_diagonal` probe the kernels with jvps, as the reference does, in
the concatenated local layout of the leaves. Every sum is in a fixed order:
the scatters gather through transpose maps or add slices, and the per-group
element sums (`index_add`) see distinct elements within a group (asserted
when a group is built), so two calls give the same bits.

On a simplex or mapped mesh the volume context carries per-element
geometry: `jac_inv_T` (E, nqp, d, d), physical gradients (E, nqp, nb, d)
and the physical quadrature points `qp_phys`; face contexts carry per-face
normals (F, 1 or nqp, d), factors (F, nqp) and h (F,).

H(div) and H(curl) leaves are tabulated through the Piola maps
(`_make_tabs`): contravariant (values J v / det J, divergence div / det J)
and covariant (values J^-T v, curl / det J in 2D, J curl / det J in 3D),
shared (nqp, nb, d) tensors on a uniform mesh, per element on a mapped cube
mesh (the Q1 map's Jacobians at each point) and on a simplex mesh (with the
space's orientation signs folded in).

There is no jit: PyTorch runs eagerly. Context tensors (tabulations,
factors, quadrature points) are built once per (dtype, device) and cached.
"""
from __future__ import annotations

import copy

import numpy as np
import torch
from torch.func import jvp, vmap

from dune_pdelab_tpu_torch.assembly.dofmaps import (
    IndexFaceTransfer, ReshapeDofMap, SlabFaceTransfer, make_leaf_dof_map,
)
from dune_pdelab_tpu_torch.assembly.geometry import (
    FaceGeometry, VolumeGeometry, embed_face_points,
)
from dune_pdelab_tpu_torch.fe.basis import geometry_element
from dune_pdelab_tpu_torch.fe.quadrature import quadrature_rule
from dune_pdelab_tpu_torch.ops.base import (
    FaceContext, LeafTab, SkeletonContext, VolumeContext,
)
from dune_pdelab_tpu_torch.utils.common import (
    default_float, device_key, full_fp32_on_cuda, resolve_device,
)

_KERNELS = ("alpha_volume", "lambda_volume", "alpha_boundary",
            "lambda_boundary", "alpha_skeleton", "lambda_skeleton")


class _FaceGroupData:
    """Static per-group data. On a structured mesh: faces normal to `axis`
    whose inside elements are the slab [lo, hi) of the element grid along
    that axis (the outside elements of a skeleton group: the slab shifted
    by one, or rolled by `roll` on a periodic axis); `elements`/`outside`
    are None. Elsewhere (simplex groups) they are explicit arrays. `x` is
    None where the physical points follow from the slab's element origins
    (uniform mesh), else an (F, nqp, dim) array. `trs_in` and `trs_out`
    hold one face transfer per leaf; `tr_in`/`tr_out` read the first
    leaf's (on a leaf space, the only one)."""
    __slots__ = ("axis", "side", "lo", "hi", "roll", "elements", "outside", "x",
                 "trs_in", "trs_out", "tabs_in", "tabs_out", "factor", "normal",
                 "h_in", "h_out", "pts", "weights")

    def __init__(self):
        self.axis = self.side = self.lo = self.hi = None
        self.roll = 0
        self.elements = self.outside = self.x = None

    @property
    def tr_in(self):
        return self.trs_in[0]

    @property
    def tr_out(self):
        return None if self.trs_out is None else self.trs_out[0]


def _cat_leaf_dofs(maps):
    """Concatenate per-leaf (B, nloc_i) global-DOF maps -> (B, sum nloc_i)."""
    return np.concatenate([np.asarray(m, dtype=np.int64) for m in maps], axis=1)


def _affine_expand(cg, rows, cols, data):
    """Expand COO entries through hanging-node parent maps: P^T A P.

    rows/cols are numpy; data is a tensor. Each entry (i, j, v) becomes
    {(p_r, p_c, w_r * w_c * v)} over the parents of i and j (identity for
    DOFs that are not hanging)."""
    indptr, pidx, pw = cg._parent_indptr, cg._parent_idx, cg._parent_w

    def expand(idx, other, src, mult):
        cnt = indptr[idx + 1] - indptr[idx]
        rep = np.repeat(np.arange(len(idx)), cnt)
        pos = np.arange(len(rep)) - np.repeat(
            np.concatenate([[0], np.cumsum(cnt)[:-1]]), cnt)
        flat = indptr[idx][rep] + pos
        return pidx[flat], other[rep], src[rep], mult[rep] * pw[flat]

    src = np.arange(len(rows))
    mult = np.ones(len(rows))
    new_rows, cols, src, mult = expand(rows, cols, src, mult)
    new_cols, new_rows, src, mult = expand(cols, new_rows, src, mult)
    data = data[torch.as_tensor(src, device=data.device)] * torch.as_tensor(
        mult, dtype=data.dtype, device=data.device)
    return new_rows, new_cols, data


class GridOperator:
    """Assembles the residual / Jacobian-apply of a LocalOperator over a
    leaf or composite function space (Galerkin: trial space == test space).

      residual(x)            -> r with constrained rows zeroed
      jacobian_apply(x, z)   -> J(x) z, identity on constrained rows
      jacobian(x)            -> sparse COO Jacobian
      jacobian_diagonal(x)   -> diag(J), every integration domain
      element_diagonal_blocks(x) -> (E, n, n) element blocks incl. faces
    """

    def __init__(self, space, lop, constraints=None, quad_order=None,
                 face_transfer: str = "auto", skip_boundary: bool = False):
        if face_transfer not in ("auto", "index"):
            raise ValueError(f"face_transfer={face_transfer!r}")
        self.space = space
        self.lop = lop
        self.cg = constraints
        self._fixed_qorder = quad_order is not None
        self.leaves = space.leaves
        self.mesh = self.leaves[0].mesh
        if any(lf.mesh is not self.mesh for lf in self.leaves):
            raise ValueError("all leaves must share one mesh")
        self.nleaves = len(self.leaves)
        self._face_transfer_mode = face_transfer   # 'auto' | 'index' (debug)
        self._leaf_maps_cache = None
        if space.is_leaf:
            # one leaf at offset 0: the transfer needs no index array
            self.dof_maps = [make_leaf_dof_map(space, None, offset=0)]
        else:
            self.dof_maps = []
            for lf, m in zip(self.leaves, self._leaf_maps()):
                own = np.asarray(lf.element_dofs, np.int64)
                off = int(m.flat[0]) - int(own.flat[0])
                contiguous = np.array_equal(m, off + own)
                self.dof_maps.append(make_leaf_dof_map(
                    lf, m, offset=off if contiguous else None))
        self.local_sizes = tuple(lf.fem.nbasis for lf in self.leaves)
        self.nlocal = sum(self.local_sizes)

        degree = max(lf.fem.degree for lf in self.leaves)
        self.qorder = quad_order if quad_order is not None else lop.quad_order(degree)
        qp, w = quadrature_rule(self.mesh.geometry_type, self.mesh.dim, self.qorder)
        self.vol_geo = VolumeGeometry(self.mesh, qp, w)
        self._vol_tabs = self._make_tabs(qp, self.vol_geo)

        self.has = {name: hasattr(lop, name) for name in _KERNELS}
        if skip_boundary:
            # pure-Dirichlet shortcut: the boundary terms vanish
            self.has["alpha_boundary"] = False
            self.has["lambda_boundary"] = False
        needs_faces = (self.has["alpha_boundary"] or self.has["lambda_boundary"]
                       or self.has["alpha_skeleton"])
        if needs_faces and not hasattr(self.mesh, "boundary_faces"):
            raise NotImplementedError(
                f"{type(self.mesh).__name__} provides no face lists; boundary/"
                "skeleton kernels need a structured or simplex mesh (for "
                "pure-Dirichlet problems pass skip_boundary=True)")
        if hasattr(lop, "skip_entity") or hasattr(lop, "skip_intersection"):
            raise NotImplementedError(
                "selective assembly (skip_entity/skip_intersection) is not "
                "ported yet")
        self.bnd_groups: list[_FaceGroupData] = []
        self.skel_groups: list[_FaceGroupData] = []
        if self.mesh.geometry_type == "simplex":
            if needs_faces:
                self._build_simplex_face_groups()
        else:
            if self.has["alpha_boundary"] or self.has["lambda_boundary"]:
                self._build_boundary_groups()
            if self.has["alpha_skeleton"]:
                self._build_skeleton_groups()
        for g in self.bnd_groups + self.skel_groups:
            # the per-group element sums (index_add) need distinct elements
            for el in (g.elements, g.outside):
                if el is not None and len(np.unique(el)) != len(el):
                    raise AssertionError("a face group repeats an element")
        self._ctx_cache = {}

    def with_operator(self, lop):
        """This GridOperator for another local operator with the same
        kernels and quadrature order, on the same space and constraints: the
        copy shares the index maps, face groups and the context cache
        (geometry and tabulations only: every coefficient is evaluated from
        `lop` inside the kernels, at each call)."""
        degree = max(lf.fem.degree for lf in self.leaves)
        if not (all(hasattr(lop, n) == hasattr(self.lop, n) for n in _KERNELS)
                and (self._fixed_qorder or lop.quad_order(degree) == self.qorder)):
            raise ValueError("with_operator: the local operator's kernels or quadrature "
                             "order differ from this GridOperator's")
        new = copy.copy(self)
        new.lop = lop
        return new

    # ------------------------------------------------------------------
    # setup of face groups
    # ------------------------------------------------------------------
    def _make_tabs(self, pts_ref, geo=None):
        """Per leaf: (values, physical gradients, reference gradients,
        degree, vector values, divergence, curl) at reference points. Scalar
        leaves: one shared gradient transform on a uniform mesh, the
        per-element one of `geo` else. H(div)/H(curl) leaves: the Piola
        maps, shared on a uniform mesh (h / det J contravariant, 1 / h
        covariant), per element on a mapped or simplex mesh."""
        return [self._vector_tab(lf, pts_ref) if lf.fem.continuity in ("Hdiv", "Hcurl")
                else self._scalar_tab(lf, pts_ref, geo) for lf in self.leaves]

    def _scalar_tab(self, lf, pts_ref, geo):
        vals, grads = lf.fem.tabulate(pts_ref)
        gphys = (geo.transform_grad(grads) if geo is not None
                 else (grads / self.mesh.h)[None])
        return (vals, gphys, grads, lf.fem.degree, None, None, None)

    def _vector_tab(self, lf, pts_ref, elements=None):
        """Piola-mapped tab of an H(div) or H(curl) leaf at reference points
        (of `elements`, default all, on a mapped or simplex mesh)."""
        fem, mesh = lf.fem, self.mesh
        hdiv = fem.continuity == "Hdiv"
        if not mesh.uniform:
            if mesh.geometry_type == "simplex":
                vec, dc = (self._simplex_piola(lf, pts_ref, elements) if hdiv
                           else self._simplex_covariant(lf, pts_ref, elements))
            else:
                vec, dc = (self._mapped_cube_piola(fem, pts_ref, elements) if hdiv
                           else self._mapped_cube_covariant(fem, pts_ref, elements))
        else:
            h = mesh.h
            detJ = float(np.prod(h))
            if hdiv:
                vec = fem.tabulate_vector(pts_ref) * (h / detJ)     # contravariant
                dc = fem.tabulate_div(pts_ref) / detJ
            else:
                vec = fem.tabulate_vector(pts_ref) / h              # covariant
                c = fem.tabulate_curl(pts_ref)
                dc = c / detJ if c.ndim == 2 else c * (h / detJ)    # 2D scalar / 3D
        return ((None, None, None, fem.degree, vec, dc, None) if hdiv
                else (None, None, None, fem.degree, vec, None, dc))

    # ------------------------------------------------------------------
    # lazy index arrays
    # ------------------------------------------------------------------
    def _leaf_maps(self):
        """Per-leaf (E, nloc) global int64 numpy DOF maps (built on first
        use; the structured fast paths never touch them)."""
        if self._leaf_maps_cache is None:
            if self.space.is_leaf:
                self._leaf_maps_cache = [np.asarray(self.space.element_dofs, np.int64)]
            else:
                self._leaf_maps_cache = [np.asarray(m, np.int64)
                                         for m in self.space.leaf_element_dofs()]
        return self._leaf_maps_cache

    @property
    def elem_gdofs_cat(self):
        """(E, nlocal) global DOF map of the concatenated local layout."""
        return _cat_leaf_dofs(self._leaf_maps())

    def _face_rule(self):
        return quadrature_rule("cube", self.mesh.dim - 1, self.qorder)

    def _slab_elements(self, axis, lo, hi, roll=0):
        """Element indices of the slab [lo, hi) along `axis`, in the order
        of the mesh's face lists (ascending element index); roll = 1 reads
        the grid shifted by one cell along a periodic axis (the outside
        elements of its wrap-closed skeleton group)."""
        cells = self.mesh.cells
        dim = self.mesh.dim
        grid = np.arange(self.mesh.nelements, dtype=np.int64).reshape(
            tuple(reversed(cells)))
        if roll:
            grid = np.roll(grid, -roll, axis=dim - 1 - axis)
        sl = [slice(None)] * dim
        sl[dim - 1 - axis] = slice(lo, hi)
        return grid[tuple(sl)].reshape(-1)

    def group_elements(self, g, outside=False):
        """(F,) inside (or outside) element of every face of group g."""
        if g.elements is not None:
            return g.outside if outside else g.elements
        if outside and g.roll:
            return self._slab_elements(g.axis, g.lo, g.hi, g.roll)
        shift = 1 if outside else 0
        return self._slab_elements(g.axis, g.lo + shift, g.hi + shift)

    def _face_transfers(self, axis, lo, hi, roll=0):
        """Per-leaf face transfers of the slab [lo, hi) (rolled by `roll`):
        slices for a DG (reshape) leaf, index arrays else."""
        out = []
        for li, dm in enumerate(self.dof_maps):
            if isinstance(dm, ReshapeDofMap) and self._face_transfer_mode == "auto":
                out.append(SlabFaceTransfer(dm.offset, self.mesh.cells, dm.nb, axis,
                                            lo, hi - self.mesh.cells[axis], roll))
            else:
                out.append(IndexFaceTransfer(
                    self._leaf_maps()[li][self._slab_elements(axis, lo, hi, roll)]))
        return out

    def _build_boundary_groups(self):
        mesh = self.mesh
        qpf, wf = self._face_rule()
        for a in range(mesh.dim):
            if mesh.periodic[a]:
                continue
            c_a = mesh.cells[a]
            fgeo = FaceGeometry(mesh, a, qpf, wf) if mesh.uniform else None
            for s in (0, 1):
                g = _FaceGroupData()
                g.axis, g.side = a, s
                g.lo, g.hi = (0, 1) if s == 0 else (c_a - 1, c_a)
                g.trs_in = self._face_transfers(a, g.lo, g.hi)
                g.trs_out = None
                g.pts = embed_face_points(qpf, a, s, mesh.dim)
                g.weights = wf
                g.tabs_out = None
                g.h_out = None
                if mesh.uniform:
                    g.tabs_in = self._make_tabs(g.pts)
                    g.factor = fgeo.factor
                    n = np.zeros(mesh.dim)
                    n[a] = 2.0 * s - 1.0
                    g.normal = n
                    g.h_in = fgeo.h_normal
                else:
                    self._mapped_boundary_geometry(g, self._slab_elements(a, g.lo, g.hi))
                self.bnd_groups.append(g)

    def _build_skeleton_groups(self):
        mesh = self.mesh
        qpf, wf = self._face_rule()
        for a in range(mesh.dim):
            c_a = mesh.cells[a]
            if c_a < 2:
                continue
            g = _FaceGroupData()
            g.axis, g.side = a, None
            if mesh.periodic[a]:
                # every cell owns its upper face; the outside slab wraps
                g.lo, g.hi, g.roll = 0, c_a, 1
                g.trs_in = self._face_transfers(a, 0, c_a)
                g.trs_out = self._face_transfers(a, 0, c_a, roll=1)
            else:
                g.lo, g.hi = 0, c_a - 1
                g.trs_in = self._face_transfers(a, 0, c_a - 1)
                g.trs_out = self._face_transfers(a, 1, c_a)
            g.pts = embed_face_points(qpf, a, 1, mesh.dim)    # upper face of inside
            pts_out = embed_face_points(qpf, a, 0, mesh.dim)  # lower face of outside
            g.weights = wf
            if mesh.uniform:
                fgeo = FaceGeometry(mesh, a, qpf, wf)
                g.tabs_in = self._make_tabs(g.pts)
                g.tabs_out = self._make_tabs(pts_out)
                g.factor = fgeo.factor
                n = np.zeros(mesh.dim)
                n[a] = 1.0                                    # inside -> outside
                g.normal = n
                g.h_in = fgeo.h_normal
                g.h_out = fgeo.h_normal
            else:
                self._mapped_skeleton_geometry(g, pts_out, self.group_elements(g),
                                               self.group_elements(g, True))
            self.skel_groups.append(g)

    # -- mapped (multilinear) cube meshes ------------------------------------
    def _mapped_cube_geometry(self, pts_ref, elements=None):
        """Per-element Q1-map Jacobians at reference points on a mapped cube
        mesh: J (F, q, d, d), detJ (F, q), for the given elements (default:
        all)."""
        corners = self.mesh.element_corner_coords()
        if elements is not None:
            corners = corners[elements]                         # (F, C, d)
        _, dN = geometry_element("cube", self.mesh.dim).tabulate(pts_ref)
        J = np.einsum("eci,qcj->eqij", corners, dN)
        detJ = np.linalg.det(J)
        if np.any(detJ <= 0):
            raise ValueError("mapped cube mesh has non-positive Jacobians "
                             "(flipped/degenerate elements)")
        return J, detJ

    def _mapped_face_tabs(self, pts, invT, elements):
        """Per-leaf per-face tabulations at embedded face points of a mapped
        cube mesh (gradients, or the Piola maps, by the adjacent element's
        Jacobians at those points)."""
        tabs = []
        for lf in self.leaves:
            if lf.fem.continuity in ("Hdiv", "Hcurl"):
                tabs.append(self._vector_tab(lf, pts, elements))
                continue
            vals, gref = lf.fem.tabulate(pts)
            tabs.append((vals, np.einsum("fqij,qbj->fqbi", invT, gref), gref,
                         lf.fem.degree, None, None, None))
        return tabs

    def _mapped_cube_piola(self, fem, pts_ref, elements=None):
        """Contravariant Piola on multilinear cube elements: vec = J v_ref /
        det J, div = div_ref / det J, exact for non-affine maps, so the
        per-point Jacobians are all it needs. Orientation is the logical
        lattice's, consistent without per-face signs because the map is
        continuous and orientation preserving (det J > 0 is checked).
        reference: raviartthomasfem.hh + common/geometrywrapper.hh."""
        J, detJ = self._mapped_cube_geometry(pts_ref, elements)
        vec = (np.einsum("eqij,qbj->eqbi", J, fem.tabulate_vector(pts_ref))
               / detJ[:, :, None, None])
        return vec, fem.tabulate_div(pts_ref)[None] / detJ[:, :, None]

    def _mapped_cube_covariant(self, fem, pts_ref, elements=None):
        """Covariant Piola (H(curl)) on multilinear cube elements: vec =
        J^-T v_ref; curl = curl_ref / det J (2D scalar) or J curl_ref /
        det J (3D vector), exact for general maps. reference:
        edges0.5fem.hh + geometry wrappers."""
        J, detJ = self._mapped_cube_geometry(pts_ref, elements)
        invT = np.linalg.inv(J).transpose(0, 1, 3, 2)
        vec = np.einsum("eqij,qbj->eqbi", invT, fem.tabulate_vector(pts_ref))
        c_ref = fem.tabulate_curl(pts_ref)
        if c_ref.ndim == 2:
            return vec, c_ref[None] / detJ[:, :, None]
        return vec, np.einsum("eqij,qbj->eqbi", J, c_ref) / detJ[:, :, None, None]

    # -- affine simplices: Piola maps with the space's orientation signs -----
    def _simplex_jacobians(self, elements):
        """Affine Jacobians (E, d, d) in the P1 node order (node dim - i
        moves xi_i) of `elements` (default: all)."""
        cc = self.mesh.element_corner_coords()
        if elements is not None:
            cc = cc[elements]
        dim = self.mesh.dim
        return np.stack([cc[:, dim - i] - cc[:, 0] for i in range(dim)], axis=-1)

    def _simplex_piola(self, lf, pts_ref, elements=None):
        """Per-element contravariant Piola on affine simplices: vec (E, nqp,
        nb, d) = sign J v_ref / det J, div = sign div_ref / det J, with the
        global-normal signs of space._build_hdiv_map_simplex."""
        fem = lf.fem
        J = self._simplex_jacobians(elements)
        detJ = np.linalg.det(J)
        signs = lf._hdiv_signs if elements is None else lf._hdiv_signs[elements]
        vec = (np.einsum("eij,qbj->eqbi", J, fem.tabulate_vector(pts_ref))
               / detJ[:, None, None, None] * signs[:, None, :, None])
        div = fem.tabulate_div(pts_ref)[None] / detJ[:, None, None] * signs[:, None, :]
        return vec, div

    def _simplex_covariant(self, lf, pts_ref, elements=None):
        """Per-element covariant Piola on affine simplices (H(curl)): vec =
        sign J^-T v_ref; curl = sign curl_ref / det J (2D) or sign J
        curl_ref / det J (3D), with the global edge directions of
        space._build_hcurl_map_simplex."""
        fem = lf.fem
        J = self._simplex_jacobians(elements)
        detJ = np.linalg.det(J)
        invT = np.swapaxes(np.linalg.inv(J), -1, -2)
        signs = lf._hcurl_signs if elements is None else lf._hcurl_signs[elements]
        vec = (np.einsum("eij,qbj->eqbi", invT, fem.tabulate_vector(pts_ref))
               * signs[:, None, :, None])
        c_ref = fem.tabulate_curl(pts_ref)
        if c_ref.ndim == 2:
            return vec, c_ref[None] / detJ[:, None, None] * signs[:, None, :]
        return vec, (np.einsum("eij,qbj->eqbi", J, c_ref) / detJ[:, None, None, None]
                     * signs[:, None, :, None])

    def _face_frame(self, g, pts, elements, n_ref):
        """Nanson's formula n dS = det J J^{-T} N dS_ref on the faces of
        `elements` at embedded points: sets g.normal (F, q, d), g.factor
        (F, q) and g.x (F, q, d); returns (invT, face areas (F,))."""
        J, detJ = self._mapped_cube_geometry(pts, elements)
        invT = np.linalg.inv(J).transpose(0, 1, 3, 2)
        nvec = np.einsum("fqij,j->fqi", invT, n_ref)
        scale = np.linalg.norm(nvec, axis=-1)                   # (F, q)
        g.normal = nvec / scale[..., None]
        g.factor = g.weights[None, :] * detJ * scale
        N, _ = geometry_element("cube", self.mesh.dim).tabulate(pts)
        g.x = np.einsum("qc,fcd->fqd", N, self.mesh.element_corner_coords()[elements])
        return invT, g.factor.sum(axis=1)

    def _mapped_boundary_geometry(self, g, elements):
        """Per-face geometry and tabs of a boundary group on a mapped cube
        mesh (reference: IntersectionGeometry over general geometries,
        common/geometrywrapper.hh). h is cell volume over face area."""
        n_ref = np.zeros(self.mesh.dim)
        n_ref[g.axis] = 2.0 * g.side - 1.0
        invT, area = self._face_frame(g, g.pts, elements, n_ref)
        g.h_in = np.asarray(self.vol_geo.cell_volume)[elements] / np.maximum(area, 1e-300)
        g.tabs_in = self._mapped_face_tabs(g.pts, invT, elements)

    def _mapped_skeleton_geometry(self, g, pts_out, ei, eo):
        """Two-sided face geometry on a mapped cube mesh: the shared face is
        parametrized by the inside element's upper face (the same four
        corner nodes as the outside element's lower face, so normals,
        measures and x agree); each side's gradients are transformed by its
        own Jacobians at the same physical points (reference:
        common/geometrywrapper.hh:119 ff)."""
        n_ref = np.zeros(self.mesh.dim)
        n_ref[g.axis] = 1.0                                      # inside -> outside
        invT_in, area = self._face_frame(g, g.pts, ei, n_ref)
        cellvol = np.asarray(self.vol_geo.cell_volume)
        g.h_in = cellvol[ei] / np.maximum(area, 1e-300)
        g.h_out = cellvol[eo] / np.maximum(area, 1e-300)
        g.tabs_in = self._mapped_face_tabs(g.pts, invT_in, ei)
        J_out, _ = self._mapped_cube_geometry(pts_out, eo)
        g.tabs_out = self._mapped_face_tabs(
            pts_out, np.linalg.inv(J_out).transpose(0, 1, 3, 2), eo)

    # -- simplex meshes -------------------------------------------------------
    def _build_simplex_face_groups(self):
        """Face groups on a simplex mesh (reference: the intersection sweep
        of gridoperator/default/assembler.hh:156-252). Faces are grouped by
        their local-embedding configuration, the positions of the face's
        sorted global vertices inside each adjacent cell, so the basis
        values are shared per group while normals, measures and physical
        gradients vary per face (affine geometry). Within a group every
        inside (and every outside) element is distinct: the configuration
        fixes the local face."""
        mesh = self.mesh
        dim = mesh.dim
        if any(lf.fem.continuity == "Hcurl" for lf in self.leaves):
            raise NotImplementedError("simplex face integrals for H(curl) elements")
        qpf, wf = quadrature_rule("simplex", dim - 1, self.qorder)
        lam = np.concatenate([1.0 - qpf.sum(axis=1, keepdims=True), qpf], axis=1)
        # reference coordinates of local vertex v: the P1 geometry's node v
        ref_corners = geometry_element("simplex", dim).nodes        # (d+1, dim)
        verts, cells = mesh.vertices, mesh.cells
        jacT = np.asarray(self.vol_geo.jac_inv_T)[:, 0]           # (E, d, d)
        cellvol = np.asarray(self.vol_geo.cell_volume)
        d1 = dim + 1
        locs = np.array([[v for v in range(d1) if v != lf] for lf in range(d1)])
        ref_face_vol = float(wf.sum())
        leaf_maps = self._leaf_maps()

        def face_geometry(cellids, locfaces):
            canon = np.sort(cells[cellids[:, None], locs[locfaces]], axis=1)   # (F, d)
            pos = (cells[cellids][:, :, None] == canon[:, None, :]).argmax(axis=1)
            A = verts[canon]                                      # (F, d, dim)
            edges = A[:, 1:] - A[:, :1]
            G = np.einsum("fid,fjd->fij", edges, edges)
            dens = np.sqrt(np.abs(np.linalg.det(G)))              # (F,)
            if dim == 2:
                t = edges[:, 0]
                n = np.stack([t[:, 1], -t[:, 0]], axis=1)
            else:
                n = np.cross(edges[:, 0], edges[:, 1])
            n = n / np.linalg.norm(n, axis=1, keepdims=True)
            opp = verts[cells[cellids, locfaces]]
            flip = np.einsum("fd,fd->f", n, A[:, 0] - opp) < 0
            n[flip] *= -1.0
            return pos, dens, n, np.einsum("qj,fjd->fqd", lam, A)

        def tabs_for(pts_ref, cellids):
            out = []
            for lf in self.leaves:
                if lf.fem.continuity == "Hdiv":
                    out.append(self._vector_tab(lf, pts_ref, cellids))
                    continue
                vals, gref = lf.fem.tabulate(pts_ref)
                out.append((vals, np.einsum("fij,qbj->fqbi", jacT[cellids], gref),
                            gref, lf.fem.degree, None, None, None))
            return out

        def transfers(el):
            return [IndexFaceTransfer(m[el]) for m in leaf_maps]

        def group(sel, ei, dens, n, x, pts_in):
            g = _FaceGroupData()
            g.elements = ei
            g.pts = pts_in
            g.weights = wf
            g.trs_in = transfers(ei)
            g.tabs_in = tabs_for(pts_in, ei)
            g.factor = wf[None, :] * dens[sel][:, None]
            g.normal = n[sel][:, None, :]                         # (F, 1, d)
            g.h_in = cellvol[ei] / (dens[sel] * ref_face_vol)
            g.x = x[sel]
            g.trs_out = g.tabs_out = g.h_out = None
            return g

        if self.has["alpha_boundary"] or self.has["lambda_boundary"]:
            bf = mesh.boundary_faces()
            cellids = bf["element"]
            pos, dens, n, x = face_geometry(cellids, bf["local_face"])
            if len(cellids):
                _, inv = np.unique(pos, axis=0, return_inverse=True)
                inv = inv.reshape(-1)
                for ci in range(inv.max() + 1):
                    sel = np.nonzero(inv == ci)[0]
                    self.bnd_groups.append(group(sel, cellids[sel], dens, n, x,
                                                 lam @ ref_corners[pos[sel[0]]]))

        if self.has["alpha_skeleton"]:
            itf = mesh.interior_faces()
            cin, cout = itf["inside"], itf["outside"]
            pos_i, dens, n, x = face_geometry(cin, itf["face_in"])
            pos_o = face_geometry(cout, itf["face_out"])[0]
            if len(cin):
                _, inv = np.unique(np.concatenate([pos_i, pos_o], axis=1), axis=0,
                                   return_inverse=True)
                inv = inv.reshape(-1)
                for ci in range(inv.max() + 1):
                    sel = np.nonzero(inv == ci)[0]
                    ei, eo = cin[sel], cout[sel]
                    g = group(sel, ei, dens, n, x, lam @ ref_corners[pos_i[sel[0]]])
                    g.outside = eo
                    g.trs_out = transfers(eo)
                    g.tabs_out = tabs_for(lam @ ref_corners[pos_o[sel[0]]], eo)
                    g.h_out = cellvol[eo] / (dens[sel] * ref_face_vol)
                    self.skel_groups.append(g)

    # ------------------------------------------------------------------
    # context construction (cached per dtype and device)
    # ------------------------------------------------------------------
    def _cached(self, key, build, dtype, device):
        key = key + (dtype, device_key(device))
        if key not in self._ctx_cache:
            if torch.device(device).type == "cuda":
                full_fp32_on_cuda()
            self._ctx_cache[key] = build()
        return self._ctx_cache[key]

    @staticmethod
    def _leaf_tab(raws, t):
        def tn(a):
            return None if a is None else t(a)

        return tuple(LeafTab(phi=tn(phi), grad=tn(gphys), ref_grad=tn(gref), degree=deg,
                             vec_phi=tn(vec), div=tn(dv), curl=tn(cl))
                     for phi, gphys, gref, deg, vec, dv, cl in raws)

    def _volume_ctx(self, time, dtype, device) -> VolumeContext:
        vg = self.vol_geo

        def build():
            def t(a):
                return torch.as_tensor(a, dtype=dtype, device=device)

            return dict(weights=t(vg.weights), x=vg.x_tensor(dtype, device),
                        factor=t(vg.factor),
                        tabs=self._leaf_tab(self._vol_tabs, t),
                        jac_inv_T=vg.jac_inv_T_tensor(dtype, device),
                        cell_volume=t(vg.cell_volume))
        return VolumeContext(time=time, **self._cached(("vol",), build, dtype, device))

    def _face_x(self, g, dtype, device):
        """(F, nqp, dim) physical face quadrature points: the group's own
        array, or (uniform mesh) the slab's element origins (float64 on the
        device, as VolumeGeometry) plus the embedded points scaled by h."""
        if g.x is not None:
            return torch.as_tensor(g.x, dtype=dtype, device=device)
        mesh = self.mesh
        dim = mesh.dim
        org = self.vol_geo.origins_tensor(torch.float64, device).reshape(
            tuple(reversed(mesh.cells)) + (dim,))
        sl = [slice(None)] * dim
        sl[dim - 1 - g.axis] = slice(g.lo, g.hi)
        org = org[tuple(sl)].reshape(-1, dim)
        off = torch.as_tensor(g.pts * mesh.h, device=device)
        return (org[:, None, :] + off[None]).to(dtype)

    def _face_ctx(self, g, time, dtype, device) -> FaceContext:
        def build():
            def t(a):
                return torch.as_tensor(a, dtype=dtype, device=device)
            return dict(weights=t(g.weights), x=self._face_x(g, dtype, device),
                        factor=t(g.factor), normal=t(g.normal),
                        tabs=self._leaf_tab(g.tabs_in, t), h_inside=t(g.h_in))
        return FaceContext(time=time, **self._cached(("bnd", id(g)), build, dtype, device))

    def _skel_ctx(self, g, time, dtype, device) -> SkeletonContext:
        def build():
            def t(a):
                return torch.as_tensor(a, dtype=dtype, device=device)
            return dict(weights=t(g.weights), x=self._face_x(g, dtype, device),
                        factor=t(g.factor), normal=t(g.normal),
                        tabs_in=self._leaf_tab(g.tabs_in, t),
                        tabs_out=self._leaf_tab(g.tabs_out, t),
                        h_inside=t(g.h_in), h_outside=t(g.h_out))
        return SkeletonContext(time=time,
                               **self._cached(("skel", id(g)), build, dtype, device))

    # ------------------------------------------------------------------
    # residual
    # ------------------------------------------------------------------
    def _pack(self, r_loc):
        """A kernel's output as a per-leaf tuple."""
        return (r_loc,) if self.nleaves == 1 else tuple(r_loc)

    def _uarg(self, u_leaf):
        """Per-leaf inputs as a kernel argument: the tensor of a leaf
        space, a tuple on a composite one."""
        return u_leaf[0] if self.nleaves == 1 else tuple(u_leaf)

    @staticmethod
    def _scatter(r, transfers, r_loc):
        for tr, rl in zip(transfers, r_loc):
            r = tr.scatter_add(r, rl)
        return r

    def residual_unconstrained(self, x, time=0.0, lambdas=True):
        """Assembled residual WITHOUT the constrained-row zeroing.
        lambdas=False leaves out the lambda_* terms, which do not depend
        on x (what a Jacobian-vector product differentiates)."""
        lop = self.lop.set_time(time)
        dtype, device = x.dtype, x.device
        r = torch.zeros_like(x)
        vctx = self._volume_ctx(time, dtype, device)
        if self.has["alpha_volume"]:
            u = self._uarg([dm.gather(x) for dm in self.dof_maps])
            r = self._scatter(r, self.dof_maps, self._pack(lop.alpha_volume(vctx, u)))
        if lambdas and self.has["lambda_volume"]:
            r = self._scatter(r, self.dof_maps, self._pack(lop.lambda_volume(vctx)))
        for g in self.bnd_groups:
            if not (self.has["alpha_boundary"] or lambdas):
                continue
            fctx = self._face_ctx(g, time, dtype, device)
            if self.has["alpha_boundary"]:
                u = self._uarg([tr.gather(x) for tr in g.trs_in])
                r = self._scatter(r, g.trs_in, self._pack(lop.alpha_boundary(fctx, u)))
            if lambdas and self.has["lambda_boundary"]:
                r = self._scatter(r, g.trs_in, self._pack(lop.lambda_boundary(fctx)))
        for g in self.skel_groups:
            sctx = self._skel_ctx(g, time, dtype, device)
            r_in, r_out = lop.alpha_skeleton(
                sctx, self._uarg([tr.gather(x) for tr in g.trs_in]),
                self._uarg([tr.gather(x) for tr in g.trs_out]))
            r = self._scatter(r, g.trs_in, self._pack(r_in))
            r = self._scatter(r, g.trs_out, self._pack(r_out))
        return r

    def residual(self, x, time=0.0):
        """r(x) with constrained rows zeroed (so the correction problem
        J z = r has z = 0 on Dirichlet DOFs; reference convention:
        gridoperator residual + set_trivial_rows). Hanging nodes:
        r = P^T R(P x) (the etadd triple product as vector ops, reference:
        gridoperator/common/assemblerutilities.hh:501-586)."""
        affine = self.cg is not None and self.cg.has_affine
        if affine:
            x = self.cg.prolong(x)
        r = self.residual_unconstrained(x, time)
        if self.cg is not None:
            if affine:
                r = self.cg.restrict_transpose(r)
            r = torch.where(self.cg.mask_on(x.device), 0.0, r)
        return r

    def weighted_element_residuals(self, x, w, time=0.0):
        """Per-element signed weighted residuals eta_K = r_K(x) . w_K.

        The localization step of dual-weighted-residual error estimation:
        each element's volume/boundary/skeleton contribution is dotted with
        w gathered on the same DOFs instead of being scattered, so
        sum_K eta_K == w^T r(x) up to rounding. w is zeroed on constrained
        rows; hanging-node constraints prolong both arguments. The face
        terms add into their elements by `index_add` with distinct
        elements per group (no float atomics). Returns an (nelements,)
        tensor."""
        dtype, device = x.dtype, x.device
        if self.cg is not None:
            w = torch.where(self.cg.mask_on(device), 0.0, w)
            if self.cg.has_affine:
                x = self.cg.prolong(x)
                w = self.cg.prolong(w)
        lop = self.lop.set_time(time)
        eta = torch.zeros(self.mesh.nelements, dtype=dtype, device=device)

        def dots(r_loc, w_list):
            return sum(torch.sum(rl.to(dtype) * wl, dim=tuple(range(1, rl.ndim)))
                       for rl, wl in zip(self._pack(r_loc), w_list))

        def add(eta, g, vals, outside=False):
            el = torch.as_tensor(self.group_elements(g, outside), device=device)
            return eta.index_add(0, el, vals)

        vctx = self._volume_ctx(time, dtype, device)
        u = self._uarg([dm.gather(x) for dm in self.dof_maps])
        wv = [dm.gather(w) for dm in self.dof_maps]
        if self.has["alpha_volume"]:
            eta = eta + dots(lop.alpha_volume(vctx, u), wv)
        if self.has["lambda_volume"]:
            eta = eta + dots(lop.lambda_volume(vctx), wv)
        for g in self.bnd_groups:
            fctx = self._face_ctx(g, time, dtype, device)
            wf = [tr.gather(w) for tr in g.trs_in]
            if self.has["alpha_boundary"]:
                uf = self._uarg([tr.gather(x) for tr in g.trs_in])
                eta = add(eta, g, dots(lop.alpha_boundary(fctx, uf), wf))
            if self.has["lambda_boundary"]:
                eta = add(eta, g, dots(lop.lambda_boundary(fctx), wf))
        for g in self.skel_groups:
            sctx = self._skel_ctx(g, time, dtype, device)
            r_in, r_out = lop.alpha_skeleton(
                sctx, self._uarg([tr.gather(x) for tr in g.trs_in]),
                self._uarg([tr.gather(x) for tr in g.trs_out]))
            eta = add(eta, g, dots(r_in, [tr.gather(w) for tr in g.trs_in]))
            eta = add(eta, g, dots(r_out, [tr.gather(w) for tr in g.trs_out]), True)
        return eta

    # ------------------------------------------------------------------
    # matrix-free Jacobian application (jacobianapplyengine analog)
    # ------------------------------------------------------------------
    def jacobian_apply(self, x, z, time=0.0):
        """y = J(x) z with symmetric constraint handling:
        y = mask*z + P J P z, P = projection onto unconstrained DOFs (and,
        with hanging nodes, J -> P_h^T J P_h)."""
        affine = self.cg is not None and self.cg.has_affine
        if self.cg is not None:
            mask = self.cg.mask_on(z.device)
            zf = torch.where(mask, 0.0, z)
            if affine:
                x = self.cg.prolong(x)
                zf = self.cg.prolong(zf)
        else:
            zf = z
        _, jz = jvp(lambda y: self.residual_unconstrained(y, time, lambdas=False),
                    (x,), (zf,))
        if self.cg is not None:
            if affine:
                jz = self.cg.restrict_transpose(jz)
            jz = torch.where(mask, z, jz)
        return jz

    def linear_operator(self, time=0.0, dtype=None, device=None):
        """For linear LOPs: the closure z -> J z (the linearization point
        is irrelevant; zeros of `dtype` on `device`, default: the default
        float on the constraint mask's device, else the default device)."""
        if device is None:
            device = self.cg.mask.device if self.cg is not None else None
        x0 = torch.zeros(self.space.ndofs, dtype=dtype or default_float(),
                         device=resolve_device(device))
        return lambda z: self.jacobian_apply(x0, z, time)

    # ------------------------------------------------------------------
    # probed blocks: element Jacobians, diagonal blocks, assembled Jacobian
    # ------------------------------------------------------------------
    @staticmethod
    def _probe(f, u):
        """Dense per-item Jacobian (B, n, n) of a batched kernel f(u (B, n))
        -> (B, n): one vmapped jvp over the n unit tangents (the
        reference's _probe; localoperator/blockdiagonal.hh:190 analog)."""
        B, n = u.shape
        eye = torch.eye(n, dtype=u.dtype, device=u.device)

        def column(sel):
            _, col = jvp(f, (u,), (sel.expand(B, n),))
            return col

        return vmap(column)(eye).permute(1, 2, 0)

    def _flat(self, kernel, sides=1):
        """A kernel of per-leaf inputs as a function of the concatenated
        local layout (B, sides * nlocal) -> (B, sides * nlocal); sides = 2
        takes and returns [inside leaves, outside leaves]."""
        sizes = self.local_sizes * sides

        def f(ucat):
            parts = list(torch.split(ucat, sizes, dim=1))
            n = self.nleaves
            args = [self._uarg(parts[i * n:(i + 1) * n]) for i in range(sides)]
            out = kernel(*args)
            outs = (out,) if sides == 1 else out
            return torch.cat([p for o in outs for p in self._pack(o)], dim=1)

        return f

    @staticmethod
    def _cat(transfers, x):
        return torch.cat([tr.gather(x) for tr in transfers], dim=1)

    def _skeleton_inputs(self, g, x, time):
        lop = self.lop.set_time(time)
        sctx = self._skel_ctx(g, time, x.dtype, x.device)
        return lop, sctx, self._cat(g.trs_in, x), self._cat(g.trs_out, x)

    def _skeleton_side(self, lop, sctx, ui, uo, side):
        """The skeleton kernel's side-`side` output as a function of that
        side's concatenated local values, the other side held fixed."""
        fixed = self._uarg(torch.split(uo if side == 0 else ui, self.local_sizes, dim=1))

        def kernel(u):
            r = (lop.alpha_skeleton(sctx, u, fixed) if side == 0
                 else lop.alpha_skeleton(sctx, fixed, u))
            return r[side]

        return self._flat(kernel)

    def element_jacobians(self, x, time=0.0):
        """Per-element dense volume Jacobian blocks (E, nlocal, nlocal)."""
        u = self._cat(self.dof_maps, x)                   # (E, nlocal)
        E, nloc = u.shape
        if not self.has["alpha_volume"]:
            return torch.zeros((E, nloc, nloc), dtype=x.dtype, device=x.device)
        lop = self.lop.set_time(time)
        vctx = self._volume_ctx(time, x.dtype, x.device)
        return self._probe(self._flat(lambda v: lop.alpha_volume(vctx, v)), u)

    def element_diagonal_blocks(self, x, time=0.0):
        """Per-element diagonal Jacobian blocks including the boundary and
        skeleton self-coupling (E, nlocal, nlocal): the full BlockDiagonal
        extraction (reference: localoperator/blockdiagonal.hh:190 wraps all
        alpha_* of the wrapped operator). The right block for DG
        block-Jacobi, where the penalty terms dominate the diagonal. Each
        group adds into distinct elements, so the sums are deterministic."""
        J = self.element_jacobians(x, time)
        lop = self.lop.set_time(time)
        dev = x.device
        if self.has["alpha_boundary"]:
            for g in self.bnd_groups:
                fctx = self._face_ctx(g, time, x.dtype, dev)
                Jb = self._probe(self._flat(lambda u: lop.alpha_boundary(fctx, u)),
                                 self._cat(g.trs_in, x))
                J = J.index_add(0, torch.as_tensor(self.group_elements(g), device=dev), Jb)
        for g in self.skel_groups:
            lop, sctx, ui, uo = self._skeleton_inputs(g, x, time)
            Jii = self._probe(self._skeleton_side(lop, sctx, ui, uo, 0), ui)
            Joo = self._probe(self._skeleton_side(lop, sctx, ui, uo, 1), uo)
            J = J.index_add(0, torch.as_tensor(self.group_elements(g), device=dev), Jii)
            J = J.index_add(0, torch.as_tensor(self.group_elements(g, True),
                                               device=dev), Joo)
        return J

    def _skeleton_blocks(self, g, x, time):
        """Two-sided (F, 2n, 2n) skeleton Jacobian blocks, rows and columns
        ordered [inside dofs, outside dofs]."""
        lop, sctx, ui, uo = self._skeleton_inputs(g, x, time)
        return self._probe(self._flat(lambda a, b: lop.alpha_skeleton(sctx, a, b), 2),
                           torch.cat([ui, uo], dim=1))

    def _all_jacobian_blocks(self, x, time):
        """[(global dofs (B, n), blocks (B, n, n))] of every integration
        domain contributing to the Jacobian."""
        ed = self.elem_gdofs_cat
        out = []
        if self.has["alpha_volume"]:
            out.append((ed, self.element_jacobians(x, time)))
        if self.has["alpha_boundary"]:
            lop = self.lop.set_time(time)
            for g in self.bnd_groups:
                fctx = self._face_ctx(g, time, x.dtype, x.device)
                Jb = self._probe(self._flat(lambda u: lop.alpha_boundary(fctx, u)),
                                 self._cat(g.trs_in, x))
                out.append((ed[self.group_elements(g)], Jb))
        for g in self.skel_groups:
            gd = np.concatenate([ed[self.group_elements(g)],
                                 ed[self.group_elements(g, True)]], axis=1)
            out.append((gd, self._skeleton_blocks(g, x, time)))
        return out

    def jacobian(self, x, time=0.0):
        """Assembled sparse Jacobian, a coalesced torch.sparse_coo_tensor
        with the reference's BCOO triples: symmetric constraint elimination
        (entries in a constrained row or column dropped) and unit rows on
        constrained DOFs. With hanging nodes every entry is expanded
        through the parent maps first (P^T J P at P x; host index work, the
        reference's `_affine_expand`)."""
        n = self.space.ndofs
        affine = self.cg is not None and self.cg.has_affine
        if affine:
            x = self.cg.prolong(x)
        rows, cols, datas = [], [], []
        for gd, J in self._all_jacobian_blocks(x, time):
            B, ni, nj = J.shape
            if affine:
                rows.append(np.broadcast_to(gd[:, :, None], (B, ni, nj)).reshape(-1))
                cols.append(np.broadcast_to(gd[:, None, :], (B, ni, nj)).reshape(-1))
            else:
                gdt = torch.as_tensor(gd, device=x.device)
                rows.append(gdt[:, :, None].expand(B, ni, nj).reshape(-1))
                cols.append(gdt[:, None, :].expand(B, ni, nj).reshape(-1))
            datas.append(J.reshape(-1))
        data = torch.cat(datas)
        if affine:
            rows, cols, data = _affine_expand(self.cg, np.concatenate(rows),
                                              np.concatenate(cols), data)
            rows = torch.as_tensor(rows, device=x.device)
            cols = torch.as_tensor(cols, device=x.device)
        else:
            rows, cols = torch.cat(rows), torch.cat(cols)
        if self.cg is not None:
            mask = self.cg.mask_on(x.device)
            keep = ~mask[rows] & ~mask[cols]
            rows, cols, data = rows[keep], cols[keep], data[keep]
            cidx = torch.nonzero(mask).reshape(-1)
            rows = torch.cat([rows, cidx])
            cols = torch.cat([cols, cidx])
            data = torch.cat([data, torch.ones(len(cidx), dtype=data.dtype,
                                               device=data.device)])
        with torch.sparse.check_sparse_tensor_invariants():
            return torch.sparse_coo_tensor(torch.stack([rows, cols]), data,
                                           (n, n)).coalesce()

    def jacobian_csr(self, x, time=0.0):
        """The assembled Jacobian as a host scipy CSR matrix (values in
        x's dtype; canonical: sorted indices, duplicates summed), as AMG,
        GenEO and the direct solvers take it."""
        return sparse_to_csr(self.jacobian(x, time))

    def jacobian_diagonal(self, x, time=0.0):
        """diag(J) including all integration domains; constrained rows -> 1.

        One jvp per local basis function and domain (J[:, b, b] of the b-th
        probe, in the concatenated local layout of the leaves), summed
        through each leaf's DOF map and face transfers: slices on a
        structured leaf, the transpose map else, so the result is the same
        from run to run. With hanging nodes the hanging rows' diagonals
        fold into their parents with weight w^2 (cross terms dropped, as in
        the reference: a Jacobi diagonal, not the exact P^T J P one)."""
        affine = self.cg is not None and self.cg.has_affine
        if affine:
            x = self.cg.prolong(x)
        d = torch.zeros(self.space.ndofs, dtype=x.dtype, device=x.device)
        lop = self.lop.set_time(time)

        def diag_of(f, u):
            B, n = u.shape
            out = torch.empty_like(u)
            for b in range(n):
                sel = torch.zeros(n, dtype=u.dtype, device=u.device)
                sel[b] = 1.0
                _, col = jvp(f, (u,), (sel.expand(B, n),))
                out[:, b] = col[:, b]
                del col
            return torch.split(out, self.local_sizes, dim=1)

        if self.has["alpha_volume"]:
            vctx = self._volume_ctx(time, x.dtype, x.device)
            d = self._scatter(d, self.dof_maps, diag_of(
                self._flat(lambda v: lop.alpha_volume(vctx, v)), self._cat(self.dof_maps, x)))
        if self.has["alpha_boundary"]:
            for g in self.bnd_groups:
                fctx = self._face_ctx(g, time, x.dtype, x.device)
                d = self._scatter(d, g.trs_in, diag_of(
                    self._flat(lambda u: lop.alpha_boundary(fctx, u)), self._cat(g.trs_in, x)))
        for g in self.skel_groups:
            lop, sctx, ui, uo = self._skeleton_inputs(g, x, time)
            d = self._scatter(d, g.trs_in, diag_of(
                self._skeleton_side(lop, sctx, ui, uo, 0), ui))
            d = self._scatter(d, g.trs_out, diag_of(
                self._skeleton_side(lop, sctx, ui, uo, 1), uo))
        if self.cg is not None:
            if affine:
                d = self.cg.fold_diagonal(d)
            d = torch.where(self.cg.mask_on(x.device), 1.0, d)
        return d


def sparse_to_csr(A):
    """A coalesced torch sparse COO matrix as a canonical host scipy CSR
    matrix (coalesced indices are sorted row-major with duplicates summed,
    which is the CSR order)."""
    import scipy.sparse as sp

    A = A.coalesce()
    ind = A.indices().cpu().numpy()
    return sp.csr_matrix((A.values().cpu().numpy(), (ind[0], ind[1])),
                         shape=tuple(A.shape))
