"""Slab-chunked residual assembly for very large structured grids.

PyTorch port of dune_pdelab_tpu/assembly/slabbed.py. The batched volume
sweep materializes (E, nqp, dim)-shaped intermediates; eager PyTorch keeps
every one of them (there is no fusion), so at 512^3 one sweep would need
hundreds of GB. The residual is therefore assembled in z-slabs: each slab is
a translated sub-mesh problem with the physical coordinate offset threaded
through the `time` channel, so one slab GridOperator serves every slab of
its thickness. The slab results are added into the output in place.

The analog of the reference's streaming element loop (reference:
dune/pdelab/gridoperator/default/assembler.hh:116).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from dune_pdelab_tpu_torch.assembly.gridoperator import GridOperator
from dune_pdelab_tpu_torch.mesh.structured import StructuredMesh
from dune_pdelab_tpu_torch.space.space import FunctionSpace


class _ShiftedLop:
    """Wraps a volume-only LOP; shifts ctx.x by an offset carried in the
    `time` argument as (t, offset)."""

    def __init__(self, lop):
        self._lop = lop
        self._t = None
        self._off = None
        self.is_linear = getattr(lop, "is_linear", False)
        if hasattr(lop, "alpha_volume"):
            self.alpha_volume = self._alpha_volume
        if hasattr(lop, "lambda_volume"):
            self.lambda_volume = self._lambda_volume

    def quad_order(self, degree):
        return self._lop.quad_order(degree)

    def set_time(self, t_off):
        t, off = t_off
        new = _ShiftedLop(self._lop.set_time(t))
        new._t = t
        new._off = off
        return new

    def _shift(self, ctx):
        return dataclasses.replace(ctx, x=ctx.x + self._off, time=self._t)

    def _alpha_volume(self, ctx, u):
        return self._lop.alpha_volume(self._shift(ctx), u)

    def _lambda_volume(self, ctx):
        return self._lop.lambda_volume(self._shift(ctx))


def residual_slabbed(space, lop, cg, x, nslabs=8, time=0.0):
    """Constrained residual assembled in z-slabs; equals go.residual(x).

    Requirements: single-leaf C0 space on a uniform non-periodic
    structured cube mesh, volume-only LOP (boundary terms must vanish:
    the pure-Dirichlet case).
    """
    if not (space.is_leaf and space.fem.continuity == "C0"):
        raise ValueError("residual_slabbed needs a single-leaf C0 space")
    if (space.mesh.geometry_type != "cube" or not space.mesh.uniform
            or any(space.mesh.periodic)):
        raise ValueError("residual_slabbed needs a uniform non-periodic "
                         f"structured cube mesh, got {space.mesh!r}")
    if hasattr(lop, "skip_entity") or hasattr(lop, "skip_intersection"):
        raise ValueError("residual_slabbed takes no selective local operator: "
                         "its masks are the whole mesh's, not a slab's")
    mesh = space.mesh
    k = space.fem.degree
    dims = space._dof_grid_dims
    cz = mesh.cells[-1]
    slab = -(-cz // nslabs)

    plane = int(np.prod(dims[:-1]))
    xg = x.reshape(dims[-1], plane)
    rg = torch.zeros_like(xg)
    shifted = _ShiftedLop(lop)
    slab_ops = {}

    for z0 in range(0, cz, slab):
        dzc = min(slab, cz - z0)
        if dzc not in slab_ops:
            cells_sub = tuple(mesh.cells[:-1]) + (dzc,)
            upper = mesh.lower + np.array(cells_sub) * mesh.h
            V_sub = FunctionSpace(StructuredMesh(mesh.lower, upper, cells_sub),
                                  space.fem)
            slab_ops[dzc] = GridOperator(V_sub, shifted, skip_boundary=True)
        x_sub = xg[k * z0: k * (z0 + dzc) + 1].reshape(-1)
        off = torch.zeros(mesh.dim, dtype=x.dtype, device=x.device)
        off[-1] = z0 * mesh.h[-1]
        r_sub = slab_ops[dzc].residual_unconstrained(x_sub, time=(time, off))
        rg[k * z0: k * (z0 + dzc) + 1] += r_sub.reshape(k * dzc + 1, plane)
    r = rg.reshape(-1)
    if cg is not None:
        r = torch.where(cg.mask_on(x.device), 0.0, r)
    return r
