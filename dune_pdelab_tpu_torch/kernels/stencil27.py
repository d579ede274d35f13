"""stencil27: the masked k = 1 27-tap lattice stencil.

Computes y = mask ? z : S(z * !mask), where S is the 27-tap stencil over the
(nz, ny, nx) DOF grid with zero reads outside the grid: exactly
`StencilOperator._apply_impl` (assembly/stencil.py) for one class, k = 1,
in 3D.

Source note.
  Replaces: dune_pdelab_tpu/assembly/stencil_pallas_tile.py
    build_tiled_stencil_apply (K2a) and dune_pdelab_tpu/assembly/
    stencil_pallas.py build_flat_stencil_apply (K2b); one kernel covers both.
  Kernel: csrc/stencil27.cu (CUDA C++, sm_90a), on the plane window of
    csrc/plane_window.cuh.
  Bound on the H100: device-memory bytes (one read of z and of the mask and
    one write of y per point, against 27 FMAs). The kernel fuses the two
    Dirichlet `where`s of the TPU wrapper and marches (x, y) tiles along z
    through a three-plane shared-memory ring, so each plane is read from
    device memory about once.

The wrapper takes the plain PyTorch version only for a tensor on the CPU;
for a CUDA tensor it launches the kernel or raises. `launches` counts the
kernel launches.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from dune_pdelab_tpu_torch.kernels import _build

launches = 0


def tap_tensor(offsets, weights) -> np.ndarray:
    """(3, 3, 3) float64 weights w[dz+1, dy+1, dx+1] of a k = 1 3D stencil
    from its (ntaps, 3) offsets (dim 0 first) and (ntaps,) weights."""
    w = np.zeros((3, 3, 3))
    for off, wt in zip(np.asarray(offsets), np.asarray(weights)):
        w[int(off[2]) + 1, int(off[1]) + 1, int(off[0]) + 1] = float(wt)
    return w


def stencil_sum(g, w27):
    """Plain 27-tap sum over an (nz, ny, nx) grid, zero reads outside."""
    nz, ny, nx = g.shape
    gp = F.pad(g, (1, 1, 1, 1, 1, 1))
    out = torch.zeros_like(g)
    for dz in range(3):
        for dy in range(3):
            for dx in range(3):
                wt = float(w27[dz, dy, dx])
                if wt != 0.0:
                    out = out + wt * gp[dz:dz + nz, dy:dy + ny, dx:dx + nx]
    return out


def stencil27_reference(z, mask, w27, dims):
    """Plain PyTorch version: y = mask ? z : S(z * !mask), flat (N,)."""
    nx, ny, nz = dims
    zf = z if mask is None else torch.where(mask, 0.0, z)
    y = stencil_sum(zf.reshape(nz, ny, nx), w27).reshape(-1)
    return y if mask is None else torch.where(mask, z, y)


def stencil27(z, mask, w27, dims):
    """Masked 27-tap stencil of the flat (N,) vector z on the (nx, ny, nz)
    grid. mask: (N,) bool tensor or None; w27: (3, 3, 3) weights."""
    global launches
    nx, ny, nz = (int(d) for d in dims)
    if min(nx, ny, nz) < 3:
        raise ValueError(f"stencil27 needs every grid dim >= 3, got {dims}")
    _build.check_tensor(z, "z", (nx * ny * nz,))
    if mask is not None:
        _build.check_tensor(mask, "mask", z.shape, torch.bool, z.device)
    if z.device.type == "cpu":
        return stencil27_reference(z, mask, w27, dims)
    if z.device.type != "cuda":
        raise ValueError(f"stencil27 runs on CPU or CUDA tensors, got {z.device}")
    fn = {torch.float32: "dpt_stencil27_f32",
          torch.float64: "dpt_stencil27_f64"}.get(z.dtype)
    if fn is None:
        raise TypeError(f"stencil27 takes float32 or float64, got {z.dtype}")
    lib = _build.library()
    w = np.ascontiguousarray(w27, dtype=np.float64).reshape(27)
    y = torch.empty_like(z)
    rc = getattr(lib, fn)(_build.ptr(z), _build.ptr(mask), _build.ptr(y),
                          nx, ny, nz, w.ctypes.data, _build.stream_ptr(z.device))
    _build.check(rc, "stencil27")
    launches += 1
    return y
