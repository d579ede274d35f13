"""Launch counts of the hand-written kernels around a piece of an example
(the wrappers count CUDA launches only; on the CPU every count stays 0)."""
from __future__ import annotations

from dune_pdelab_tpu_torch.kernels import blockstencil as bk
from dune_pdelab_tpu_torch.kernels import ell27 as ek
from dune_pdelab_tpu_torch.kernels import fused_cg as fk
from dune_pdelab_tpu_torch.kernels import stencil27 as sk
from dune_pdelab_tpu_torch.kernels import structured_fused as sfk

COUNTERS = {"stencil27": (sk, "launches"), "fused_cg_k1": (fk, "launches_k1"),
            "fused_cg_k2": (fk, "launches_k2"), "structured_fused": (sfk, "launches"),
            "ell27": (ek, "launches"), "blockstencil_mm": (bk, "launches_mm"),
            "blockstencil_em": (bk, "launches_em")}


def snapshot():
    return {k: getattr(mod, attr) for k, (mod, attr) in COUNTERS.items()}


def since(before):
    """Launches of each kernel since `before` (a snapshot), nonzero only."""
    now = snapshot()
    return {k: now[k] - before[k] for k in now if now[k] != before[k]}


def summed(per_rank):
    """The launches of a multi-rank task: each rank's `since` dict summed."""
    total = {}
    for launches in per_rank:
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n
    return total
