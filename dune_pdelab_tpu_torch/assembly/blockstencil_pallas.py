"""Element-major lowering of the DG block stencil (2D/3D).

PyTorch port of dune_pdelab_tpu/assembly/blockstencil_pallas.py: one pass
over the element-major DOF array (DOF e*nb + j) that applies every block
tap and the per-side boundary corrections, kernels/blockstencil.py
block_stencil_em (the CUDA kernel for a CUDA tensor, its plain version for
a CPU tensor). The TPU kernel's lane-roll layout (rows of nx*nb lanes, a
128-lane gate, lane-periodic weight vectors) and its correction for rows
that cross a z-slab have no counterpart: the kernel tests each neighbour
against the grid.
"""
from __future__ import annotations

import numpy as np


def try_pallas_block_stencil(block_op):
    """z -> A z on the element-major kernel for a 2D/3D
    BlockStencilOperator; None when it does not qualify (another
    dimension, or a tap beyond the face neighbours)."""
    if len(block_op.cells) not in (2, 3):
        return None
    if any(int(np.sum(np.abs(off))) > 1 for off in np.asarray(block_op.offsets)):
        return None
    return block_op.__call__
