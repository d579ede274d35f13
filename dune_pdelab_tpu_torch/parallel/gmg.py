"""Distributed geometric multigrid: the level operators run sharded.

PyTorch port of dune_pdelab_tpu/parallel/gmg.py. The reference reaches
distributed multigrid through ISTL's parallel AMG (reference:
dune/pdelab/backend/istl/ovlpistlsolverbackend.hh AMG rows). Here the
geometric hierarchy of linalg/multigrid.py keeps its V-cycle and swaps
each level's operator (every level but the coarsest, whose dense LU stays
sequential on every rank) for the window-sharded one: each level apply
is one halo exchange each way plus the all-gather of the level's flat
vector that the flat API returns. The cycle's arithmetic is the
sequential one, so preconditioned-CG iteration counts match the
sequential GeometricMultigrid.
"""
from __future__ import annotations

from dune_pdelab_tpu_torch.linalg.multigrid import GeometricMultigrid
from dune_pdelab_tpu_torch.parallel.comm import group_of
from dune_pdelab_tpu_torch.parallel.novlp import NonoverlappingShardedGridOperator


class ShardedGeometricMultigrid(GeometricMultigrid):
    """GeometricMultigrid whose level operators run window-sharded.

    Drop-in for the sequential class (same preconditioner protocol).
    devices / group: the process group (default: the world group); the
    level vectors live on `device` (the rank's device for a sharded run).
    """

    def __init__(self, lop, mesh, fem, bctype=None, devices=None, group=None, **kw):
        super().__init__(lop, mesh, fem, bctype=bctype, **kw)
        grp = group_of(devices, group)
        sharded = []
        for l, go in enumerate(self.gos):
            if l == self.nlevels - 1:
                sharded.append(go)   # coarsest: the dense LU stays sequential
                continue
            try:
                sharded.append(NonoverlappingShardedGridOperator(
                    go, group=grp, device=self.device))
            except ValueError:
                sharded.append(go)   # level too coarse for this rank count
        self.gos = sharded
