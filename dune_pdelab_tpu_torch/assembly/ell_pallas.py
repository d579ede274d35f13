"""The plane-streamed lattice-ELL SpMV entry point.

PyTorch port of dune_pdelab_tpu/assembly/ell_pallas.py. The TPU kernel
(`build_plane_ell_apply`, K4a) and the row-tiled one of assembly/ell.py
(K4b) are both replaced by the ell27 Hopper kernel (kernels/ell27.py,
csrc/ell27.cu), which keeps the (27, nz, ny, nx) value layout (no
(nz, 27, ny, nx) transpose), takes any dims in fp32 and fp64, and is exact
for any values (no reliance on zero couplings outside the domain).
"""
from __future__ import annotations

from dune_pdelab_tpu_torch.assembly.ell import try_pallas_tiled_ell


def try_plane_ell(ell):
    """The kernel-backed apply of a k = 1 3D EllMatrix; None otherwise
    (same function as `try_pallas_tiled_ell`: one kernel covers both)."""
    return try_pallas_tiled_ell(ell)
