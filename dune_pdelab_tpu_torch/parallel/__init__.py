"""Distributed assembly and solvers on torch.distributed.

PyTorch port of dune_pdelab_tpu/parallel/ (slice 12). The process model,
decided once for every module here:

  * Ranks replace devices. The reference is single-controller SPMD over
    `devices=jax.devices()[:n]`; the port runs one process per rank. A
    `devices=` or `group=` argument names a process group (default: the
    world group). With no initialised group an operator runs as one rank:
    its halo exchange is empty because it has no neighbours, not because a
    separate sequential branch runs.
  * Vectors are rank-local blocks. `device_put(x_flat)` cuts this rank's
    block out of a full vector; `gather(block)` all-gathers the full vector
    on every rank (the names of the reference).
  * Rank devices. Rank r works on cuda:(local rank % cards) unless the
    caller passes `device=` or chose the process's default device (the
    launcher sets each rank's: its card, or the CPU when asked for; the
    CPU tests pass "cpu"); on one card every rank shares cuda:0.
  * Backends. The caller initialises the group and so chooses its backend;
    nothing falls back from NCCL to gloo. One rank on the card uses NCCL;
    several ranks sharing one card use gloo (NCCL refuses two ranks on one
    device), and gloo moves host tensors, so comm.py stages each CUDA halo
    through a pinned host buffer with a stream synchronisation before gloo
    reads it. The CPU tests use gloo.
  * CUDA graphs. A sharded apply on a group of more than one rank
    synchronises the host at each exchange and cannot be captured; it
    raises at capture time (before any communication), so
    solvers/linear.GraphedApply runs it eagerly. On one rank nothing is
    exchanged and the apply can be captured.
  * Global dots are reproducible (comm.Comm.dot, the Krylov solvers' `dot=`
    hook): their bits depend neither on the rank nor on how the vectors are
    split, so every rank takes the same branch and every rank count the
    iterations of one rank (as long as the applies agree bit for bit).

`launch.py` starts ranks (a FileStore rendezvous in a temporary directory,
no TCP port) and runs a function on each. Modules: comm (halo exchange,
collectives, counters), partition, dofsharded (DofShardedStencil: the
stencil27 kernel per rank on the card), windowed (WindowShardedGridOperator,
any mesh and space), sharded (ShardedGridOperator, ShardedContextMixin),
novlp (the compatibility name), gmg (ShardedGeometricMultigrid),
gmg_sharded (ShardedLatticeGMG), shardedamg (ShardedAMG), loadbalance.
"""
from dune_pdelab_tpu_torch.parallel.sharded import (  # noqa: F401
    ShardedContextMixin, ShardedGridOperator,
)
from dune_pdelab_tpu_torch.parallel.windowed import (  # noqa: F401
    WindowShardedGridOperator, block_partition,
)
from dune_pdelab_tpu_torch.parallel.partition import pad_partition  # noqa: F401
from dune_pdelab_tpu_torch.parallel.dofsharded import (  # noqa: F401
    DofShardedStencil, sharded_cg_solve,
)
from dune_pdelab_tpu_torch.parallel.novlp import NonoverlappingShardedGridOperator  # noqa: F401
from dune_pdelab_tpu_torch.parallel.gmg import ShardedGeometricMultigrid  # noqa: F401
from dune_pdelab_tpu_torch.parallel.shardedamg import ShardedAMG  # noqa: F401
from dune_pdelab_tpu_torch.parallel.comm import (  # noqa: F401
    allreduce, exchange_planes, masked_dot,
)
from dune_pdelab_tpu_torch.parallel.loadbalance import (  # noqa: F401
    imbalance, partition_weighted, rebalance, redistribute,
)

__all__ = [
    "ShardedGridOperator", "ShardedContextMixin", "WindowShardedGridOperator",
    "block_partition", "pad_partition", "DofShardedStencil", "sharded_cg_solve",
    "NonoverlappingShardedGridOperator", "ShardedGeometricMultigrid", "ShardedAMG",
    "allreduce", "exchange_planes", "masked_dot", "partition_weighted", "imbalance",
    "rebalance", "redistribute",
]
