"""GridOperator: global residual / Jacobian-apply as batched kernels.

PyTorch port of dune_pdelab_tpu/assembly/gridoperator.py for a single-leaf
space on a uniform non-periodic structured mesh (reference:
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
sparse COO tensor) and `jacobian_diagonal` probe the kernels with jvps, as
the reference does. Mapped-mesh and simplex face groups wait for ROADMAP
slice 11; composite spaces for slice 9.

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
    elements of a skeleton group: the slab shifted by one)."""
    __slots__ = ("axis", "side", "lo", "hi", "tr_in", "tr_out", "tabs_in",
                 "tabs_out", "factor", "normal", "h_in", "h_out", "pts",
                 "weights")


class GridOperator:
    """Assembles the residual / Jacobian-apply of a LocalOperator over a
    single-leaf function space (Galerkin: trial space == test space).

      residual(x)            -> r with constrained rows zeroed
      jacobian_apply(x, z)   -> J(x) z, identity on constrained rows
      jacobian(x)            -> sparse COO Jacobian
      jacobian_diagonal(x)   -> diag(J), every integration domain
      element_diagonal_blocks(x) -> (E, n, n) element blocks incl. faces
    """

    def __init__(self, space, lop, constraints=None, quad_order=None,
                 face_transfer: str = "auto", skip_boundary: bool = False):
        if not getattr(space, "is_leaf", False):
            raise NotImplementedError(
                "composite spaces are not ported yet (ROADMAP slice 9)")
        if face_transfer not in ("auto", "index"):
            raise ValueError(f"face_transfer={face_transfer!r}")
        self.space = space
        self.lop = lop
        self.cg = constraints
        self.mesh = space.mesh
        self._face_transfer_mode = face_transfer   # 'auto' | 'index' (debug)
        self.dof_maps = [make_leaf_dof_map(space, None, offset=0)]

        degree = space.fem.degree
        self.qorder = quad_order if quad_order is not None else lop.quad_order(degree)
        qp, w = quadrature_rule(self.mesh.geometry_type, self.mesh.dim, self.qorder)
        self.vol_geo = VolumeGeometry(self.mesh, qp, w)
        self._vol_tab = self._make_tab(qp)

        self.has = {name: hasattr(lop, name) for name in _KERNELS}
        if skip_boundary:
            # pure-Dirichlet shortcut: the boundary terms vanish
            self.has["alpha_boundary"] = False
            self.has["lambda_boundary"] = False
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
    def _make_tab(self, pts_ref):
        """(values, physical gradients, reference gradients, degree) of the
        leaf at reference points (uniform geometry: one shared gradient
        transform)."""
        fem = self.space.fem
        vals, grads = fem.tabulate(pts_ref)
        return vals, (grads / self.mesh.h)[None], grads, fem.degree

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

    def _face_transfer(self, axis, lo, hi):
        dm = self.dof_maps[0]
        if isinstance(dm, ReshapeDofMap) and self._face_transfer_mode == "auto":
            return SlabFaceTransfer(dm.offset, self.mesh.cells, dm.nb, axis,
                                    lo, hi - self.mesh.cells[axis])
        return IndexFaceTransfer(
            self.space.element_dofs[self._slab_elements(axis, lo, hi)])

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
                g.tr_in = self._face_transfer(a, g.lo, g.hi)
                g.tr_out = None
                g.pts = embed_face_points(qpf, a, s, mesh.dim)
                g.weights = wf
                g.tabs_in = self._make_tab(g.pts)
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
            g.tr_in = self._face_transfer(a, 0, c_a - 1)
            g.tr_out = self._face_transfer(a, 1, c_a)
            g.pts = embed_face_points(qpf, a, 1, mesh.dim)   # upper face of inside
            pts_out = embed_face_points(qpf, a, 0, mesh.dim)  # lower face of outside
            g.weights = wf
            g.tabs_in = self._make_tab(g.pts)
            g.tabs_out = self._make_tab(pts_out)
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
    def _leaf_tab(raw, t):
        phi, gphys, gref, deg = raw
        return (LeafTab(phi=t(phi), grad=t(gphys), ref_grad=t(gref), degree=deg),)

    def _volume_ctx(self, time, dtype, device) -> VolumeContext:
        vg = self.vol_geo

        def build():
            def t(a):
                return torch.as_tensor(a, dtype=dtype, device=device)

            x = (vg.origins_tensor(dtype, device)[:, None, :]
                 + t(vg.qp_phys_offset)[None])
            return dict(weights=t(vg.weights), x=x, factor=t(vg.factor),
                        tabs=self._leaf_tab(self._vol_tab, t),
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
    def residual_unconstrained(self, x, time=0.0):
        """Assembled residual WITHOUT the constrained-row zeroing."""
        lop = self.lop.set_time(time)
        dm = self.dof_maps[0]
        dtype, device = x.dtype, x.device
        r = torch.zeros_like(x)
        vctx = self._volume_ctx(time, dtype, device)
        if self.has["alpha_volume"]:
            r = dm.scatter_add(r, lop.alpha_volume(vctx, dm.gather(x)))
        if self.has["lambda_volume"]:
            r = dm.scatter_add(r, lop.lambda_volume(vctx))
        for g in self.bnd_groups:
            fctx = self._face_ctx(g, time, dtype, device)
            if self.has["alpha_boundary"]:
                r = g.tr_in.scatter_add(r, lop.alpha_boundary(fctx, g.tr_in.gather(x)))
            if self.has["lambda_boundary"]:
                r = g.tr_in.scatter_add(r, lop.lambda_boundary(fctx))
        for g in self.skel_groups:
            sctx = self._skel_ctx(g, time, dtype, device)
            r_in, r_out = lop.alpha_skeleton(sctx, g.tr_in.gather(x),
                                             g.tr_out.gather(x))
            r = g.tr_in.scatter_add(r, r_in)
            r = g.tr_out.scatter_add(r, r_out)
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
        _, jz = jvp(lambda y: self.residual_unconstrained(y, time), (x,), (zf,))
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

    def _skeleton_inputs(self, g, x, time):
        lop = self.lop.set_time(time)
        sctx = self._skel_ctx(g, time, x.dtype, x.device)
        return lop, sctx, g.tr_in.gather(x), g.tr_out.gather(x)

    def element_jacobians(self, x, time=0.0):
        """Per-element dense volume Jacobian blocks (E, nlocal, nlocal)."""
        dm = self.dof_maps[0]
        u = dm.gather(x)                                  # (E, nloc)
        E, nloc = u.shape
        if not self.has["alpha_volume"]:
            return torch.zeros((E, nloc, nloc), dtype=x.dtype, device=x.device)
        lop = self.lop.set_time(time)
        vctx = self._volume_ctx(time, x.dtype, x.device)
        return self._probe(lambda v: lop.alpha_volume(vctx, v), u)

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
                Jb = self._probe(lambda u: lop.alpha_boundary(fctx, u),
                                 g.tr_in.gather(x))
                J = J.index_add(0, torch.as_tensor(self.group_elements(g), device=dev), Jb)
        for g in self.skel_groups:
            lop, sctx, ui, uo = self._skeleton_inputs(g, x, time)
            Jii = self._probe(lambda u: lop.alpha_skeleton(sctx, u, uo)[0], ui)
            Joo = self._probe(lambda u: lop.alpha_skeleton(sctx, ui, u)[1], uo)
            J = J.index_add(0, torch.as_tensor(self.group_elements(g), device=dev), Jii)
            J = J.index_add(0, torch.as_tensor(self.group_elements(g, True),
                                               device=dev), Joo)
        return J

    def _skeleton_blocks(self, g, x, time):
        """Two-sided (F, 2n, 2n) skeleton Jacobian blocks, rows and columns
        ordered [inside dofs, outside dofs]."""
        lop, sctx, ui, uo = self._skeleton_inputs(g, x, time)
        F, n = ui.shape
        eye = torch.eye(2 * n, dtype=x.dtype, device=x.device)

        def column(sel):
            _, (ci, co) = jvp(lambda a, b: lop.alpha_skeleton(sctx, a, b), (ui, uo),
                              (sel[:n].expand(F, n), sel[n:].expand(F, n)))
            return torch.cat([ci, co], dim=1)

        return vmap(column)(eye).permute(1, 2, 0)

    def _all_jacobian_blocks(self, x, time):
        """[(global dofs (B, n), blocks (B, n, n))] of every integration
        domain contributing to the Jacobian."""
        ed = self.space.element_dofs
        out = []
        if self.has["alpha_volume"]:
            out.append((ed, self.element_jacobians(x, time)))
        if self.has["alpha_boundary"]:
            lop = self.lop.set_time(time)
            for g in self.bnd_groups:
                fctx = self._face_ctx(g, time, x.dtype, x.device)
                Jb = self._probe(lambda u: lop.alpha_boundary(fctx, u),
                                 g.tr_in.gather(x))
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

    def jacobian_diagonal(self, x, time=0.0):
        """diag(J) including all integration domains; constrained rows -> 1.

        One jvp per local basis function and domain (J[:, b, b] of the b-th
        probe), summed through the DOF map and the face transfers: slices
        on a structured space, so the result is the same from run to run."""
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
            return out

        if self.has["alpha_volume"]:
            dm = self.dof_maps[0]
            vctx = self._volume_ctx(time, x.dtype, x.device)
            d = dm.scatter_add(d, diag_of(lambda v: lop.alpha_volume(vctx, v),
                                          dm.gather(x)))
        if self.has["alpha_boundary"]:
            for g in self.bnd_groups:
                fctx = self._face_ctx(g, time, x.dtype, x.device)
                d = g.tr_in.scatter_add(d, diag_of(
                    lambda u: lop.alpha_boundary(fctx, u), g.tr_in.gather(x)))
        for g in self.skel_groups:
            lop, sctx, ui, uo = self._skeleton_inputs(g, x, time)
            d = g.tr_in.scatter_add(d, diag_of(
                lambda u: lop.alpha_skeleton(sctx, u, uo)[0], ui))
            d = g.tr_out.scatter_add(d, diag_of(
                lambda u: lop.alpha_skeleton(sctx, ui, u)[1], uo))
        if self.cg is not None:
            d = torch.where(self.cg.mask_on(x.device), 1.0, d)
        return d
