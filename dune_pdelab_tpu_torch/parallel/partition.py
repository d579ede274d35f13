"""Element partitioning over ranks.

PyTorch port of dune_pdelab_tpu/parallel/partition.py (numpy only; the
port keeps its own copy). Analog of the reference's spatial domain
decomposition (PDELab's overlapping/nonoverlapping MPI partitions,
SURVEY.md section 2.8; dune/pdelab/backend/istl/parallelhelper.hh:50
rank ownership): a partition is a static reshape of the batched element or
face index arrays into (nranks, B_loc, ...) blocks, padded to equal size
with a mask.
"""
from __future__ import annotations

import numpy as np


def pad_partition(index_arrays, ndev: int):
    """Split the leading axis of each (B, ...) array into (ndev, Bloc, ...).

    Pads to equal block size with repeats of entry 0 and returns a float
    mask (ndev, Bloc) that is 0 on padded entries (scatter contributions
    multiply by the mask, so padding never double-counts).
    """
    B = index_arrays[0].shape[0]
    Bloc = -(-B // ndev) if B else 0
    total = Bloc * ndev
    mask = np.zeros(total, dtype=np.float64)
    mask[:B] = 1.0
    out = []
    for a in index_arrays:
        a = np.asarray(a)
        if B == 0:
            out.append(np.zeros((ndev, 0) + a.shape[1:], a.dtype))
            continue
        pad = np.concatenate([a, np.repeat(a[:1], total - B, axis=0)], axis=0)
        out.append(pad.reshape((ndev, Bloc) + a.shape[1:]))
    return out, mask.reshape(ndev, max(Bloc, 0))
