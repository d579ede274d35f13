"""The nonoverlapping operator's name: it is the window-sharded operator.

PyTorch port of dune_pdelab_tpu/parallel/novlp.py. The reference retired
its slab-halo nonoverlapping operator (uniform meshes only, halo <= block)
for the window-sharded one (parallel/windowed.py), which covers every case
it could run and more; `NonoverlappingShardedGridOperator` remains as the
compatibility name. Reference analog: the nonoverlapping backends
(dune/pdelab/backend/istl/novlpistlsolverbackend.hh:330-1128), whose
owner-computes + border-exchange semantics the windowed operator
implements through ownership by renumbering.
"""
from dune_pdelab_tpu_torch.parallel.windowed import WindowShardedGridOperator


class NonoverlappingShardedGridOperator(WindowShardedGridOperator):
    """Compatibility name: the windowed operator under the novlp name."""

    def __init__(self, go, devices=None, axis_name="blk", **kw):
        super().__init__(go, devices=devices, axis_name=axis_name, **kw)
