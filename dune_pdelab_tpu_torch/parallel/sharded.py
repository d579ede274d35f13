"""Sharded assembly entry point and the shared context builders.

PyTorch port of dune_pdelab_tpu/parallel/sharded.py. `ShardedGridOperator`
is the window-sharded operator (parallel/windowed.py), whose communication
per apply is one halo-sized neighbour exchange each way; the name is kept
as the package's main sharded entry point, as in the reference.

`ShardedContextMixin` holds uniform-mesh context builders for sharded
assembly from element origins or face points owned by a rank; subclasses
provide `self.go`. The GridOperator's own cached context supplies every
field but the points.

Reference mapping: overlapping backends dune/pdelab/backend/istl/
ovlpistlsolverbackend.hh; border accumulation gridoperator/common/
borderdofexchanger.hh:498; data handles gridfunctionspace/
genericdatahandle.hh:130.
"""
from __future__ import annotations

import dataclasses

import torch

from dune_pdelab_tpu_torch.ops.base import FaceContext, SkeletonContext, VolumeContext
from dune_pdelab_tpu_torch.parallel.windowed import WindowShardedGridOperator


def _fields(ctx):
    return {f.name: getattr(ctx, f.name) for f in dataclasses.fields(ctx)
            if f.name != "time"}


class ShardedContextMixin:
    """Uniform-mesh context builders for sharded assembly. Subclasses
    provide `self.go`."""

    def _vol_ctx(self, origins_local, time, dtype):
        go = self.go
        fields = _fields(go._volume_ctx(time, dtype, origins_local.device))
        off = torch.as_tensor(go.vol_geo.qp_phys_offset, dtype=dtype,
                              device=origins_local.device)
        fields["x"] = origins_local.to(dtype)[:, None, :] + off[None]
        return VolumeContext(time=time, **fields)

    def _face_ctx(self, g, x_local, time, dtype):
        fields = _fields(self.go._face_ctx(g, time, dtype, x_local.device))
        fields["x"] = x_local.to(dtype)
        return FaceContext(time=time, **fields)

    def _skel_ctx(self, g, x_local, time, dtype):
        fields = _fields(self.go._skel_ctx(g, time, dtype, x_local.device))
        fields["x"] = x_local.to(dtype)
        return SkeletonContext(time=time, **fields)

    def jacobian_diagonal(self, x, time=0.0):
        """Delegates to the sequential operator (setup-phase probing)."""
        return self.go.jacobian_diagonal(x, time)

    @property
    def space(self):
        return self.go.space

    @property
    def lop(self):
        return self.go.lop


class ShardedGridOperator(WindowShardedGridOperator):
    """The package's default sharded GridOperator (window-sharded).

    API: residual / jacobian_apply on full flat (N,) vectors and the
    padded-block variants for Krylov loops; jacobian_diagonal delegates to
    the sequential operator (a setup-phase probing quantity)."""

    def jacobian_diagonal(self, x, time=0.0):
        return self.go.jacobian_diagonal(x, time)
