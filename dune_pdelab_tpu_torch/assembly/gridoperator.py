"""GridOperator: global residual / Jacobian-apply as batched kernels.

PyTorch port of dune_pdelab_tpu/assembly/gridoperator.py for leaf and
composite spaces on a uniform non-periodic structured mesh, and for
volume-only operators on a simplex mesh (reference:
dune/pdelab/gridoperator/gridoperator.hh:35-240 facade,
gridoperator/default/assembler.hh:84-279 element and intersection sweep):

  * the element loop becomes one batched gather, one batched kernel call and
    one scatter-add over all elements; faces are grouped by normal axis
    (and side, on the boundary): one batched kernel call per group. The
    faces of a group are a slab of the element grid, so a DG leaf moves
    its face coefficients by slices (SlabFaceTransfer), a C0 leaf by index
    arrays (IndexFaceTransfer);
  * `jacobian_apply` is torch.func.jvp of the residual (the reference's
    jax.jvp), face terms included, not a finite difference;
  * constrained rows are zeroed in the residual and act as identity in J.

`element_jacobians`, `element_diagonal_blocks`, the assembled `jacobian` (a
sparse COO tensor; `jacobian_csr` hands it to host scipy) and
`jacobian_diagonal` probe the kernels with jvps, as the reference does, in
the concatenated local layout of the leaves.

On a simplex mesh the volume context carries per-element geometry:
`jac_inv_T` (E, nqp, d, d), physical gradients (E, nqp, nb, d) and the
physical quadrature points `qp_phys`. Mapped-mesh and simplex face groups
wait for ROADMAP slice 11: a simplex operator with boundary or skeleton
kernels raises, unless a pure-Dirichlet problem drops its boundary terms
with skip_boundary=True (the reference's shortcut).

There is no jit: PyTorch runs eagerly. Context tensors (tabulations,
factors, quadrature points) are built once per (dtype, device) and cached.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.func import jvp, vmap

from dune_pdelab_tpu_torch.assembly.dofmaps import (
    IndexFaceTransfer, ReshapeDofMap, SlabFaceTransfer, make_leaf_dof_map,
)
from dune_pdelab_tpu_torch.assembly.geometry import (
    FaceGeometry, VolumeGeometry, embed_face_points,
)
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
    """Static per-group data: faces normal to `axis` whose inside elements
    are the slab [lo, hi) of the element grid along that axis (the outside
    elements of a skeleton group: the slab shifted by one). `trs_in` and
    `trs_out` hold one face transfer per leaf; `tr_in`/`tr_out` read the
    first leaf's (on a leaf space, the only one)."""
    __slots__ = ("axis", "side", "lo", "hi", "trs_in", "trs_out",
                 "tabs_in", "tabs_out", "factor", "normal", "h_in", "h_out", "pts",
                 "weights")

    @property
    def tr_in(self):
        return self.trs_in[0]

    @property
    def tr_out(self):
        return None if self.trs_out is None else self.trs_out[0]


def _cat_leaf_dofs(maps):
    """Concatenate per-leaf (B, nloc_i) global-DOF maps -> (B, sum nloc_i)."""
    return np.concatenate([np.asarray(m, dtype=np.int64) for m in maps], axis=1)


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
        if needs_faces and self.mesh.geometry_type != "cube":
            raise NotImplementedError(
                f"face integrals on a {self.mesh.geometry_type} mesh are not "
                "ported yet (ROADMAP slice 11); for a pure-Dirichlet problem "
                "pass skip_boundary=True")
        if hasattr(lop, "skip_entity") or hasattr(lop, "skip_intersection"):
            raise NotImplementedError(
                "selective assembly (skip_entity/skip_intersection) is not "
                "ported yet")
        self.bnd_groups: list[_FaceGroupData] = []
        self.skel_groups: list[_FaceGroupData] = []
        if self.has["alpha_boundary"] or self.has["lambda_boundary"]:
            self._build_boundary_groups()
        if self.has["alpha_skeleton"]:
            self._build_skeleton_groups()
        self._ctx_cache = {}

    # ------------------------------------------------------------------
    # setup of face groups (uniform structured mesh)
    # ------------------------------------------------------------------
    def _make_tabs(self, pts_ref, geo=None):
        """Per leaf: (values, physical gradients, reference gradients,
        degree) at reference points: one shared gradient transform on a
        uniform mesh, the per-element one of `geo` else."""
        out = []
        for lf in self.leaves:
            vals, grads = lf.fem.tabulate(pts_ref)
            gphys = (geo.transform_grad(grads) if geo is not None
                     else (grads / self.mesh.h)[None])
            out.append((vals, gphys, grads, lf.fem.degree))
        return out

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

    def _slab_elements(self, axis, lo, hi):
        """Element indices of the slab [lo, hi) along `axis`, in the order
        of the mesh's face lists (ascending element index)."""
        cells = self.mesh.cells
        dim = self.mesh.dim
        grid = np.arange(self.mesh.nelements, dtype=np.int64).reshape(
            tuple(reversed(cells)))
        sl = [slice(None)] * dim
        sl[dim - 1 - axis] = slice(lo, hi)
        return grid[tuple(sl)].reshape(-1)

    def group_elements(self, g, outside=False):
        """(F,) inside (or outside) element of every face of group g."""
        shift = 1 if outside else 0
        return self._slab_elements(g.axis, g.lo + shift, g.hi + shift)

    def _face_transfers(self, axis, lo, hi):
        """Per-leaf face transfers of the slab [lo, hi): slices for a DG
        (reshape) leaf, index arrays else."""
        out = []
        for li, dm in enumerate(self.dof_maps):
            if isinstance(dm, ReshapeDofMap) and self._face_transfer_mode == "auto":
                out.append(SlabFaceTransfer(dm.offset, self.mesh.cells, dm.nb, axis,
                                            lo, hi - self.mesh.cells[axis]))
            else:
                out.append(IndexFaceTransfer(
                    self._leaf_maps()[li][self._slab_elements(axis, lo, hi)]))
        return out

    def _build_boundary_groups(self):
        mesh = self.mesh
        qpf, wf = self._face_rule()
        for a in range(mesh.dim):
            c_a = mesh.cells[a]
            fgeo = FaceGeometry(mesh, a, qpf, wf)
            for s in (0, 1):
                g = _FaceGroupData()
                g.axis, g.side = a, s
                g.lo, g.hi = (0, 1) if s == 0 else (c_a - 1, c_a)
                g.trs_in = self._face_transfers(a, g.lo, g.hi)
                g.trs_out = None
                g.pts = embed_face_points(qpf, a, s, mesh.dim)
                g.weights = wf
                g.tabs_in = self._make_tabs(g.pts)
                g.tabs_out = None
                g.factor = fgeo.factor
                n = np.zeros(mesh.dim)
                n[a] = 2.0 * s - 1.0
                g.normal = n
                g.h_in = fgeo.h_normal
                g.h_out = None
                self.bnd_groups.append(g)

    def _build_skeleton_groups(self):
        mesh = self.mesh
        qpf, wf = self._face_rule()
        for a in range(mesh.dim):
            c_a = mesh.cells[a]
            if c_a < 2:
                continue
            fgeo = FaceGeometry(mesh, a, qpf, wf)
            g = _FaceGroupData()
            g.axis, g.side = a, None
            g.lo, g.hi = 0, c_a - 1
            g.trs_in = self._face_transfers(a, 0, c_a - 1)
            g.trs_out = self._face_transfers(a, 1, c_a)
            g.pts = embed_face_points(qpf, a, 1, mesh.dim)   # upper face of inside
            pts_out = embed_face_points(qpf, a, 0, mesh.dim)  # lower face of outside
            g.weights = wf
            g.tabs_in = self._make_tabs(g.pts)
            g.tabs_out = self._make_tabs(pts_out)
            g.factor = fgeo.factor
            n = np.zeros(mesh.dim)
            n[a] = 1.0                                        # inside -> outside
            g.normal = n
            g.h_in = fgeo.h_normal
            g.h_out = fgeo.h_normal
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
        return tuple(LeafTab(phi=t(phi), grad=t(gphys), ref_grad=t(gref), degree=deg)
                     for phi, gphys, gref, deg in raws)

    def _volume_ctx(self, time, dtype, device) -> VolumeContext:
        vg = self.vol_geo

        def build():
            def t(a):
                return torch.as_tensor(a, dtype=dtype, device=device)

            return dict(weights=t(vg.weights), x=vg.x_tensor(dtype, device),
                        factor=t(vg.factor),
                        tabs=self._leaf_tab(self._vol_tabs, t),
                        jac_inv_T=t(vg.jac_inv_T), cell_volume=t(vg.cell_volume))
        return VolumeContext(time=time, **self._cached(("vol",), build, dtype, device))

    def _face_x(self, g, dtype, device):
        """(F, nqp, dim) physical face quadrature points: the slab's element
        origins (float64 on the device, as VolumeGeometry) plus the
        embedded points scaled by h."""
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
        gridoperator residual + set_trivial_rows)."""
        r = self.residual_unconstrained(x, time)
        if self.cg is not None:
            r = torch.where(self.cg.mask_on(x.device), 0.0, r)
        return r

    # ------------------------------------------------------------------
    # matrix-free Jacobian application (jacobianapplyengine analog)
    # ------------------------------------------------------------------
    def jacobian_apply(self, x, z, time=0.0):
        """y = J(x) z with symmetric constraint handling:
        y = mask*z + P J P z, P = projection onto unconstrained DOFs."""
        if self.cg is not None:
            mask = self.cg.mask_on(z.device)
            zf = torch.where(mask, 0.0, z)
        else:
            zf = z
        _, jz = jvp(lambda y: self.residual_unconstrained(y, time, lambdas=False),
                    (x,), (zf,))
        if self.cg is not None:
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
        constrained DOFs."""
        n = self.space.ndofs
        rows, cols, datas = [], [], []
        for gd, J in self._all_jacobian_blocks(x, time):
            B, ni, nj = J.shape
            gdt = torch.as_tensor(gd, device=x.device)
            rows.append(gdt[:, :, None].expand(B, ni, nj).reshape(-1))
            cols.append(gdt[:, None, :].expand(B, ni, nj).reshape(-1))
            datas.append(J.reshape(-1))
        rows, cols, data = torch.cat(rows), torch.cat(cols), torch.cat(datas)
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
        from run to run."""
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
