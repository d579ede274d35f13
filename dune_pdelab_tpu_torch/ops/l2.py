"""L2 (mass) operator, the temporal operator of time stepping.

PyTorch port of dune_pdelab_tpu/ops/l2.py (reference:
dune/pdelab/localoperator/l2.hh:149 class L2, and
l2volumefunctional.hh): the scaled mass ∫ scale * u v dx and the
right-hand-side functional ∫ f v dx; the mass acts on every leaf of a
composite space.
"""
from __future__ import annotations

import torch

from dune_pdelab_tpu_torch.ops.base import LocalOperator, VolumeContext


class L2(LocalOperator):
    """alpha_volume = ∫ scale * u v dx (scale may be a callable of x)."""

    is_linear = True
    qp_separable = True
    quadrature_factor = 2

    def __init__(self, scale=1.0, quadrature_add: int = 0):
        self.scale = scale
        self.quadrature_add = quadrature_add
        # a constant scale is translation invariant (the stencil compilers'
        # proxy path, assembly/stencil.py)
        self.spatially_invariant = not callable(scale)

    def _scale(self, ctx):
        return self.scale(ctx.x) if callable(self.scale) else self.scale

    def alpha_volume(self, ctx: VolumeContext, u):
        s = self._scale(ctx)
        if isinstance(u, tuple):          # composite space: one mass per leaf
            return tuple(self.accumulate_value(t, ctx.factor, s * self.value_at_qp(t, ui))
                         for t, ui in zip(ctx.tabs, u))
        tab = ctx.tab
        return self.accumulate_value(tab, ctx.factor, s * self.value_at_qp(tab, u))


class L2VolumeFunctional(LocalOperator):
    """lambda-only right-hand side ∫ f v dx (reference:
    dune/pdelab/localoperator/l2volumefunctional.hh)."""

    is_linear = True

    def __init__(self, f, quadrature_add: int = 0):
        self.f = f
        self.quadrature_add = quadrature_add

    def lambda_volume(self, ctx: VolumeContext):
        fv = torch.broadcast_to(
            torch.as_tensor(self.f(ctx.x), dtype=ctx.factor.dtype,
                            device=ctx.factor.device), ctx.x.shape[:-1])
        return self.accumulate_value(ctx.tab, ctx.factor, -fv)
