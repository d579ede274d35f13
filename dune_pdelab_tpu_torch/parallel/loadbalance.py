"""Load balancing and redistribution over ranks.

PyTorch port of dune_pdelab_tpu/parallel/loadbalance.py, the analog of the
reference's grid load balancing with attached DOF data (reference:
dune/pdelab/gridfunctionspace/loadbalance.hh:24-360, `loadBalance(grid,
gfs, x...)`):

  * `partition_weighted`: contiguous ranges balanced by a per-entity cost
    model (prefix-sum quantiles), the LoadBalancer policy analog; feed the
    ranges to the sharded operators when element costs are skewed;
  * `rebalance`: the same sharded operator on another process group or
    rank mesh (a group made with torch.distributed.new_group; moving from 4
    ranks to 8 takes the 8-rank group, every rank of the world calling
    new_group);
  * `redistribute`: a DOF vector from one operator's layout to another's.
    Ranks of the destination group that held no block in the source take
    theirs from the full vector; the full vector is gathered over the
    source group and sent (`broadcast`) to the destination's ranks.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from dune_pdelab_tpu_torch.parallel.dofsharded import DofShardedStencil
from dune_pdelab_tpu_torch.parallel.novlp import NonoverlappingShardedGridOperator


def partition_weighted(weights, ndev: int):
    """Contiguous ranges [(lo, hi), ...] of len ndev balancing sum(weights).

    Cut points sit at the total-cost quantiles (prefix-sum splitting), the
    static analog of the reference's load balancer for entity costs."""
    w = np.asarray(weights, dtype=np.float64)
    c = np.cumsum(w)
    total = float(c[-1]) if len(c) else 0.0
    cuts = np.searchsorted(c, total * (np.arange(1, ndev) / ndev), side="left") + 1
    bounds = np.concatenate([[0], np.clip(cuts, 0, len(w)), [len(w)]])
    bounds = np.maximum.accumulate(bounds)
    return [(int(bounds[i]), int(bounds[i + 1])) for i in range(ndev)]


def imbalance(ranges, weights):
    """max range cost / mean range cost (1.0 = perfectly balanced)."""
    w = np.asarray(weights, dtype=np.float64)
    costs = np.array([w[lo:hi].sum() for lo, hi in ranges])
    mean = costs.mean() if costs.size else 1.0
    return float(costs.max() / max(mean, 1e-300))


def rebalance(op, devices=None, mesh_shape=None, group=None, device=None):
    """The same sharded operator on another process group / rank mesh. Call
    it on the ranks of the new group."""
    if isinstance(op, DofShardedStencil):
        return DofShardedStencil(op.st, devices=devices, mesh_shape=mesh_shape,
                                 group=group, device=device or op.device)
    if isinstance(op, NonoverlappingShardedGridOperator):
        return NonoverlappingShardedGridOperator(op.go, devices=devices, group=group,
                                                 device=device or op.device)
    raise TypeError(f"cannot rebalance {type(op).__name__}")


def redistribute(x, src, dst):
    """A sharded DOF vector from src's layout to dst's layout.

    Every rank of dst's group calls it; a rank outside src's group passes
    x = None and src = None. When both layouts are the same (same group
    size, padding and rank mesh) the block is returned as it is."""
    if src is not None and type(src) is not type(dst):
        raise TypeError("redistribute needs two operators of the same kind")
    if not isinstance(dst, (DofShardedStencil, NonoverlappingShardedGridOperator)):
        raise TypeError(f"cannot redistribute to {type(dst).__name__}")
    if src is not None and _same_layout(src, dst):
        return x
    full = src.gather(x) if src is not None else None
    return dst.device_put(_share(full, dst))


def _same_layout(src, dst):
    if src.comm.size != dst.comm.size:
        return False
    if isinstance(src, DofShardedStencil):
        return src.padded_shape == dst.padded_shape and src.mesh_shape == dst.mesh_shape
    return src.B == dst.B and np.array_equal(src._pi, dst._pi)


def _share(full, dst):
    """The full flat vector on every rank of dst's group: broadcast from
    the lowest rank that holds it to those that do not."""
    comm = dst.comm
    if comm.size == 1:
        return full
    have = full is not None
    flag = torch.tensor([1.0 if have else 0.0,
                         1.0 if have and full.dtype == torch.float64 else 0.0],
                        dtype=torch.float64, device=dst.device)
    flags = comm.allgather(flag)
    if all(float(f[0]) == 1.0 for f in flags):
        return full
    root = next(i for i, f in enumerate(flags) if float(f[0]) == 1.0)
    n = dst.N if hasattr(dst, "N") else int(np.prod(dst.grid_shape))
    dtype = torch.float64 if float(flags[root][1]) == 1.0 else torch.float32
    host = full.to("cpu") if have else torch.empty(n, dtype=dtype)
    if comm.backend == "nccl":
        host = host.to(dst.device)
    dist.broadcast(host, src=root if dst.group is None
                   else dist.get_global_rank(dst.group, root), group=dst.group)
    return host.to(dst.device)
