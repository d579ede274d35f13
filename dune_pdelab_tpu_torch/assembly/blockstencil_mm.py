"""Mode-major lowering of the 3D DG block stencil.

PyTorch port of dune_pdelab_tpu/assembly/blockstencil_mm.py. The DOF array
is transposed to mode-major planes, (nz, nb, ny, nx): each DG mode becomes
its own scalar field on the element lattice, so consecutive threads of the
kernel read consecutive elements. The apply is kernels/blockstencil.py
block_stencil_mm (the CUDA kernel for a CUDA tensor, its plain version for
a CPU tensor), with the per-side boundary corrections dD inside the kernel
(the reference's `mxu2` fold_dd semantics). Its three TPU lowerings (K5a
`vpu`, K5b `mxu`/`mxu2`/`mxu3`, K5c `vreg`) are one kernel here; their
lane and sublane gates, the x64 refusal, the VMEM sizing and the plane
blocking have no counterpart.

Krylov loops can run entirely in the mode-major layout (one transpose at
solve entry and exit instead of two per apply): MMBlockStencil exposes
`apply_mm`, `to_mm` and `from_mm`.

Reference analog: the FastDG blocked apply (dune/pdelab/gridoperator/
fastdg/assembler.hh:25) over assembled BCRS blocks.
"""
from __future__ import annotations

import numpy as np

from dune_pdelab_tpu_torch.kernels.blockstencil import block_stencil_mm


class MMBlockStencil:
    """Solver-facing mode-major lowering of a 3D BlockStencilOperator:
    callable on flat element-major vectors (the to/from transposes
    included), with `apply_mm`/`to_mm`/`from_mm` for mode-major loops.
    `source` is the BlockStencilOperator it lowers (its tap data)."""

    def __init__(self, block_op):
        self.source = block_op
        self.cells = block_op.cells
        self.nb = block_op.nb
        nx, ny, nz = self.cells
        self.mm_shape = (nz, self.nb, ny, nx)

    @property
    def ndofs(self):
        return self.source.ndofs

    def to_mm(self, zflat):
        """Element-major flat (E*nb,) -> mode-major (nz, nb, ny, nx)."""
        nx, ny, nz = self.cells
        return zflat.reshape(nz, ny, nx, self.nb).permute(0, 3, 1, 2).contiguous()

    def from_mm(self, zmm, dtype=None):
        """Mode-major (nz, nb, ny, nx) -> element-major flat (E*nb,)."""
        out = zmm.permute(0, 2, 3, 1).reshape(-1)
        return out if dtype is None else out.to(dtype)

    def apply_mm(self, zmm):
        W, dD = self.source.taps(zmm.dtype, zmm.device)
        return block_stencil_mm(zmm, W, dD, self.cells)

    def apply_flat(self, z):
        return self.from_mm(self.apply_mm(self.to_mm(z)))

    def __call__(self, z):
        return self.apply_flat(z)

    def diagonal(self, dtype=None, device=None):
        """The element-major diagonal (BlockStencilOperator.diagonal)."""
        return self.source.diagonal(dtype=dtype, device=device)


def try_mm_block_stencil(block_op):
    """Lower a 3D BlockStencilOperator to the mode-major kernel; None when
    it does not qualify (not 3D, or a tap beyond the face neighbours)."""
    if len(block_op.cells) != 3:
        return None
    if any(int(np.sum(np.abs(off))) > 1 for off in np.asarray(block_op.offsets)):
        return None
    return MMBlockStencil(block_op)
