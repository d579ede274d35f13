"""GridOperator: global residual / Jacobian-apply as batched kernels.

PyTorch port of the volume path of dune_pdelab_tpu/assembly/gridoperator.py
(reference: dune/pdelab/gridoperator/gridoperator.hh:35-240 facade,
gridoperator/default/assembler.hh:84-279 element sweep):

  * the element loop becomes one batched gather, one batched kernel call and
    one scatter-add over all elements;
  * `jacobian_apply` is torch.func.jvp of the residual (the reference's
    jax.jvp), not a finite difference;
  * constrained rows are zeroed in the residual and act as identity in J.

Boundary and skeleton face groups wait for ROADMAP slice 7: a local
operator that has boundary or skeleton kernels is accepted only with
`skip_boundary=True` (the pure-Dirichlet shortcut, where those terms
vanish). `element_jacobians`, the assembled `jacobian` (a sparse COO
tensor) and `jacobian_diagonal` probe the element kernels with a vmapped
jvp, as the reference does.

There is no jit: PyTorch runs eagerly. Context tensors (tabulations,
factors, element origins) are built once per (dtype, device) and cached.
"""
from __future__ import annotations

import torch
from torch.func import jvp, vmap

from dune_pdelab_tpu_torch.assembly.dofmaps import make_leaf_dof_map
from dune_pdelab_tpu_torch.assembly.geometry import VolumeGeometry
from dune_pdelab_tpu_torch.fe.quadrature import quadrature_rule
from dune_pdelab_tpu_torch.ops.base import LeafTab, VolumeContext
from dune_pdelab_tpu_torch.utils.common import full_fp32_on_cuda

_KERNELS = ("alpha_volume", "lambda_volume", "alpha_boundary",
            "lambda_boundary", "alpha_skeleton", "lambda_skeleton")


class GridOperator:
    """Assembles the residual / Jacobian-apply of a LocalOperator over a
    single-leaf function space (Galerkin: trial space == test space).

      residual(x)            -> r with constrained rows zeroed
      jacobian_apply(x, z)   -> J(x) z, identity on constrained rows
    """

    def __init__(self, space, lop, constraints=None, quad_order=None,
                 skip_boundary: bool = False):
        if not getattr(space, "is_leaf", False):
            raise NotImplementedError(
                "composite spaces are not ported yet (ROADMAP slice 9)")
        self.space = space
        self.lop = lop
        self.cg = constraints
        self.mesh = space.mesh
        self.dof_maps = [make_leaf_dof_map(space, None, offset=0)]

        degree = space.fem.degree
        self.qorder = quad_order if quad_order is not None else lop.quad_order(degree)
        qp, w = quadrature_rule(self.mesh.geometry_type, self.mesh.dim, self.qorder)
        self.vol_geo = VolumeGeometry(self.mesh, qp, w)
        vals, grads = space.fem.tabulate(qp)
        self._vol_tab = (vals, self.vol_geo.transform_grad(grads), grads,
                         space.fem.degree)

        self.has = {name: hasattr(lop, name) for name in _KERNELS}
        if skip_boundary:
            # pure-Dirichlet shortcut: the boundary terms vanish
            self.has["alpha_boundary"] = False
            self.has["lambda_boundary"] = False
        faces = [n for n in _KERNELS[2:] if self.has[n]]
        if faces:
            raise NotImplementedError(
                f"{type(lop).__name__} has {', '.join(faces)}; boundary and "
                "skeleton face groups are not ported yet (ROADMAP slice 7). "
                "For a pure-Dirichlet problem pass skip_boundary=True.")
        if hasattr(lop, "skip_entity") or hasattr(lop, "skip_intersection"):
            raise NotImplementedError(
                "selective assembly (skip_entity/skip_intersection) is not "
                "ported yet")
        self._ctx_cache = {}

    # ------------------------------------------------------------------
    # context construction (cached per dtype and device)
    # ------------------------------------------------------------------
    def _volume_ctx(self, time, dtype, device) -> VolumeContext:
        key = (dtype, str(device))
        if key not in self._ctx_cache:
            if torch.device(device).type == "cuda":
                full_fp32_on_cuda()
            vg = self.vol_geo

            def t(a):
                return torch.as_tensor(a, dtype=dtype, device=device)

            phi, gphys, gref, deg = self._vol_tab
            x = (vg.origins_tensor(dtype, device)[:, None, :]
                 + t(vg.qp_phys_offset)[None])
            self._ctx_cache[key] = dict(
                weights=t(vg.weights), x=x, factor=t(vg.factor),
                tabs=(LeafTab(phi=t(phi), grad=t(gphys), ref_grad=t(gref),
                              degree=deg),),
                jac_inv_T=t(vg.jac_inv_T), cell_volume=t(vg.cell_volume))
        return VolumeContext(time=time, **self._ctx_cache[key])

    # ------------------------------------------------------------------
    # residual
    # ------------------------------------------------------------------
    def residual_unconstrained(self, x, time=0.0):
        """Assembled residual WITHOUT the constrained-row zeroing."""
        lop = self.lop.set_time(time)
        dm = self.dof_maps[0]
        r = torch.zeros_like(x)
        vctx = self._volume_ctx(time, x.dtype, x.device)
        if self.has["alpha_volume"]:
            r = dm.scatter_add(r, lop.alpha_volume(vctx, dm.gather(x)))
        if self.has["lambda_volume"]:
            r = dm.scatter_add(r, lop.lambda_volume(vctx))
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

    # ------------------------------------------------------------------
    # element Jacobians, assembled Jacobian, diagonal
    # ------------------------------------------------------------------
    def element_jacobians(self, x, time=0.0):
        """Per-element dense volume Jacobian blocks (E, nlocal, nlocal):
        one vmapped jvp over the nlocal unit tangents (the reference's
        _probe; localoperator/blockdiagonal.hh:190 analog)."""
        dm = self.dof_maps[0]
        u = dm.gather(x)                                  # (E, nloc)
        E, nloc = u.shape
        if not self.has["alpha_volume"]:
            return torch.zeros((E, nloc, nloc), dtype=x.dtype, device=x.device)
        lop = self.lop.set_time(time)
        vctx = self._volume_ctx(time, x.dtype, x.device)
        eye = torch.eye(nloc, dtype=x.dtype, device=x.device)

        def column(sel):
            _, col = jvp(lambda v: lop.alpha_volume(vctx, v), (u,),
                         (sel.expand(E, nloc),))
            return col                                    # (E, nloc)

        cols = vmap(column)(eye)                          # (nloc, E, nloc)
        return cols.permute(1, 2, 0)                      # (E, nloc, nloc)

    def _element_dofs_on(self, device):
        return torch.as_tensor(self.space.element_dofs, device=device)

    def jacobian(self, x, time=0.0):
        """Assembled sparse Jacobian, a coalesced torch.sparse_coo_tensor
        with the reference's BCOO triples: symmetric constraint elimination
        (entries in a constrained row or column dropped) and unit rows on
        constrained DOFs."""
        n = self.space.ndofs
        J = self.element_jacobians(x, time)
        B, ni, nj = J.shape
        gd = self._element_dofs_on(x.device)
        rows = gd[:, :, None].expand(B, ni, nj).reshape(-1)
        cols = gd[:, None, :].expand(B, ni, nj).reshape(-1)
        data = J.reshape(-1)
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
        """diag(J) of the volume terms; constrained rows -> 1."""
        J = self.element_jacobians(x, time)
        d = torch.zeros(self.space.ndofs, dtype=x.dtype, device=x.device)
        d = d.index_add(0, self._element_dofs_on(x.device).reshape(-1),
                        torch.diagonal(J, dim1=1, dim2=2).reshape(-1))
        if self.cg is not None:
            d = torch.where(self.cg.mask_on(x.device), 1.0, d)
        return d
