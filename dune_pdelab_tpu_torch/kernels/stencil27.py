"""stencil27: the masked k = 1 27-tap lattice stencil.

Computes y = mask ? z : S(z * !mask), where S is the 27-tap stencil over the
(nz, ny, nx) DOF grid with zero reads outside the grid: exactly
`StencilOperator._apply_impl` (assembly/stencil.py) for one class, k = 1,
in 3D.

Source note.
  Replaces: dune_pdelab_tpu/assembly/stencil_pallas_tile.py:65
    build_tiled_stencil_apply (K2a) and dune_pdelab_tpu/assembly/
    stencil_pallas.py:63 build_flat_stencil_apply (K2b); one kernel covers
    both.
  Kernel: csrc/stencil27.cu (CUDA C++, sm_90a), its own z march (the
    fused-CG kernels keep csrc/plane_window.cuh).
  Bound on the H100: device-memory bytes: one read of z and of the mask and
    one write of y per point (9 B in fp32, 0.361 ms at 512^3 DOFs) against
    27 FMAs (0.108 ms at 67 TFLOP/s). Measured at about 43% of it, limited
    by the rate of instruction dispatch (PERF.md).
  Design: a block marches a (32 XP) x 8 tile along a z chunk sized from
    the grid (launch_shape.cuh: small multigrid levels still fill the
    card); a thread owns XP consecutive x points of a row. XP = 4 from 128
    columns up (on nx = 128 k + 1, the multigrid lattices, the last tile's
    lane 31 takes a fifth point rather than leave a tile of one column);
    narrower grids take 2 or 1, whichever leaves fewer idle columns. Planes
    arrive through a shared ring of 4 stages in fp32 and 3 in fp64, filled
    by one-value cp.async copies (any nx: no row alignment needed), so 3
    (fp64: 2) planes load while one is computed; constrained entries are
    zeroed by the thread that copied them. Register blocking along z: each
    arriving plane is read once (one vector shared load per row of the
    thread's 3 x (XP + 2) neighbourhood, the two edge values by warp
    shuffle) into the layer sums W[-1]*p, W[0]*p, W[+1]*p, which complete
    output plane p - 1 and update two running sums: at most 3 shared reads
    per point instead of 27, one barrier per plane. Each output is
    (W[-1]*p[z-1] + W[0]*p[z]) + W[+1]*p[z+1] in fixed order: results
    repeat bit for bit. The earlier design (27 shared reads per point from a
    three-plane ring, one plane in flight) and its times are in PERF.md.

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
