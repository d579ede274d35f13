"""ell27: the lattice-ELL SpMV of a k = 1 3D assembled matrix.

Computes y = mask ? z : A (mask ? 0 : z) with A stored as (27, nz, ny, nx)
per-row tap values, tap t = (dz+1)*9 + (dy+1)*3 + (dx+1) (dim 0 fastest),
and reads outside the grid equal to 0: exactly `EllMatrix._apply_impl`
(assembly/ell.py) for k = 1 in 3D, for any values.

Source note.
  Replaces: dune_pdelab_tpu/assembly/ell_pallas.py build_plane_ell_apply
    (K4a) and dune_pdelab_tpu/assembly/ell.py build_tiled_ell_apply (K4b);
    one kernel covers both.
  Kernel: csrc/ell27.cu (CUDA C++, sm_90a), fp32 and fp64, any dims >= 1.
  Bound on the H100: device-memory bytes (27 values, z, the mask and y per
    DOF: 117 B in fp32) against 27 multiply-adds. One thread per DOF with
    coalesced tap-major value streams; the taps are summed in this module's
    order without FMA contraction, so the kernel repeats the plain version.

The wrapper takes the plain PyTorch version only for a tensor on the CPU;
for a CUDA tensor it launches the kernel or raises. `launches` counts the
kernel launches.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from dune_pdelab_tpu_torch.kernels import _build

launches = 0


def ell27_reference(values, z, mask, dims):
    """Plain PyTorch version: 27 padded-slice multiply-adds, flat (N,)."""
    nx, ny, nz = (int(d) for d in dims)
    zf = z if mask is None else torch.where(mask, 0.0, z)
    gp = F.pad(zf.reshape(nz, ny, nx), (1, 1, 1, 1, 1, 1))
    out = None
    for t in range(27):
        dz, dy, dx = t // 9, (t // 3) % 3, t % 3
        term = values[t] * gp[dz:dz + nz, dy:dy + ny, dx:dx + nx]
        out = term if out is None else out + term
    y = out.reshape(-1)
    return y if mask is None else torch.where(mask, z, y)


def ell27(values, z, mask, dims):
    """Lattice-ELL SpMV of the flat (N,) vector z on the (nx, ny, nz) grid.
    values: (27, nz, ny, nx) of z's dtype; mask: (N,) bool tensor or None."""
    global launches
    nx, ny, nz = (int(d) for d in dims)
    if min(nx, ny, nz) < 1:
        raise ValueError(f"ell27 needs every grid dim >= 1, got {dims}")
    _build.check_tensor(z, "z", (nx * ny * nz,))
    _build.check_tensor(values, "values", (27, nz, ny, nx), z.dtype, z.device)
    if mask is not None:
        _build.check_tensor(mask, "mask", z.shape, torch.bool, z.device)
    if z.device.type == "cpu":
        return ell27_reference(values, z, mask, dims)
    if z.device.type != "cuda":
        raise ValueError(f"ell27 runs on CPU or CUDA tensors, got {z.device}")
    fn = {torch.float32: "dpt_ell27_f32", torch.float64: "dpt_ell27_f64"}.get(z.dtype)
    if fn is None:
        raise TypeError(f"ell27 takes float32 or float64, got {z.dtype}")
    lib = _build.library()
    y = torch.empty_like(z)
    rc = getattr(lib, fn)(_build.ptr(values), _build.ptr(z), _build.ptr(mask),
                          _build.ptr(y), nx, ny, nz, _build.stream_ptr(z.device))
    _build.check(rc, "ell27")
    launches += 1
    return y
