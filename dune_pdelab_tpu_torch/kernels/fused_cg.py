"""fused_cg_k1 / fused_cg_k2: the two passes of one fused CG iteration.

On a k = 1 27-tap stencil A whose six grid faces are Dirichlet (q = 0 there),
over (nz, ny, nx) grids:

  fused_cg_k1(r, p, beta)     -> (p' = r + beta p, <p', A p'>)
  fused_cg_k2(x, r, p, alpha) -> (x + alpha p, r' = r - alpha A p, <r', r'>)

beta and alpha are 0-d tensors on the vectors' device; the dots come back
as 0-d tensors there, so a CG loop needs no host sync.

Source note.
  Replaces: dune_pdelab_tpu/assembly/fused_cg_pallas.py
    build_fused_cg_kernels, k1_kernel (K1a) and k2_kernel (K1b).
  Kernel: csrc/fused_cg.cu (CUDA C++, sm_90a), on the plane window of
    csrc/plane_window.cuh.
  Bound on the H100: device-memory bytes: K1 moves 3 vectors (reads r, p;
    writes p'), K2 moves 5 (reads x, r, p; writes x', r'), against 27 FMAs
    per point. K1 forms p' at the stencil neighbours on the fly from r and p
    as it loads the plane window and never reads p' back. The two dots need
    a grid-wide reduction: each block writes a partial sum accumulated in
    double and a second one-block pass adds the partials in a fixed order
    (deterministic, no atomics).

The wrappers take the plain PyTorch versions only for tensors on the CPU;
for CUDA tensors they launch the kernels or raise. `launches_k1` and
`launches_k2` count the kernel launches.
"""
from __future__ import annotations

import numpy as np
import torch

from dune_pdelab_tpu_torch.kernels import _build
from dune_pdelab_tpu_torch.kernels.stencil27 import stencil_sum

launches_k1 = 0
launches_k2 = 0


def _faces_zeroed(q):
    q[0] = 0
    q[-1] = 0
    q[:, 0] = 0
    q[:, -1] = 0
    q[:, :, 0] = 0
    q[:, :, -1] = 0
    return q


def _dot(a, b):
    """<a, b> accumulated in float64, returned in a's dtype."""
    return torch.sum(a.double() * b.double()).to(a.dtype)


def fused_cg_k1_reference(r, p, beta, w27):
    """Plain PyTorch version of K1: (p' = r + beta p, <p', A p'>)."""
    pn = r + beta * p
    q = _faces_zeroed(stencil_sum(pn, w27))
    return pn, _dot(pn, q)


def fused_cg_k2_reference(x, r, p, alpha, w27):
    """Plain PyTorch version of K2: (x + alpha p, r - alpha A p, <r', r'>)."""
    q = _faces_zeroed(stencil_sum(p, w27))
    rn = r - alpha * q
    return x + alpha * p, rn, _dot(rn, rn)


def _check_grids(names, grids, scalar):
    g0 = grids[0]
    if g0.ndim != 3 or min(g0.shape) < 3:
        raise ValueError(f"fused CG grids are (nz, ny, nx) with dims >= 3, "
                         f"got {tuple(g0.shape)}")
    for n, g in zip(names, grids):
        _build.check_tensor(g, n, g0.shape, g0.dtype, g0.device)
    if g0.device.type == "cuda":
        _build.check_tensor(scalar, "scalar", (), g0.dtype, g0.device)
    elif g0.device.type != "cpu":
        raise ValueError(f"fused CG runs on CPU or CUDA tensors, got {g0.device}")
    if g0.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"fused CG takes float32 or float64, got {g0.dtype}")


def _suffix(dtype):
    return "f32" if dtype == torch.float32 else "f64"


def _scratch(g):
    nz, ny, nx = g.shape
    nblocks = _build.library().dpt_window_nblocks(nx, ny, nz)
    partials = torch.empty(nblocks, dtype=torch.float64, device=g.device)
    dot = torch.empty((), dtype=g.dtype, device=g.device)
    return partials, dot


def fused_cg_k1(r, p, beta, w27):
    """K1 on (nz, ny, nx) grids; beta is a 0-d tensor (or a float on CPU)."""
    global launches_k1
    _check_grids(("r", "p"), (r, p), beta)
    if r.device.type == "cpu":
        return fused_cg_k1_reference(r, p, beta, w27)
    lib = _build.library()
    nz, ny, nx = r.shape
    w = np.ascontiguousarray(w27, dtype=np.float64).reshape(27)
    pn = torch.empty_like(r)
    partials, dot = _scratch(r)
    rc = getattr(lib, f"dpt_fused_cg_k1_{_suffix(r.dtype)}")(
        _build.ptr(r), _build.ptr(p), _build.ptr(beta), _build.ptr(pn),
        _build.ptr(partials), _build.ptr(dot), nx, ny, nz, w.ctypes.data,
        _build.stream_ptr(r.device))
    _build.check(rc, "fused_cg_k1")
    launches_k1 += 1
    return pn, dot


def fused_cg_k2(x, r, p, alpha, w27):
    """K2 on (nz, ny, nx) grids; alpha is a 0-d tensor (or a float on CPU)."""
    global launches_k2
    _check_grids(("x", "r", "p"), (x, r, p), alpha)
    if x.device.type == "cpu":
        return fused_cg_k2_reference(x, r, p, alpha, w27)
    lib = _build.library()
    nz, ny, nx = x.shape
    w = np.ascontiguousarray(w27, dtype=np.float64).reshape(27)
    xn = torch.empty_like(x)
    rn = torch.empty_like(r)
    partials, dot = _scratch(x)
    rc = getattr(lib, f"dpt_fused_cg_k2_{_suffix(x.dtype)}")(
        _build.ptr(x), _build.ptr(r), _build.ptr(p), _build.ptr(alpha),
        _build.ptr(xn), _build.ptr(rn), _build.ptr(partials), _build.ptr(dot),
        nx, ny, nz, w.ctypes.data, _build.stream_ptr(x.device))
    _build.check(rc, "fused_cg_k2")
    launches_k2 += 1
    return xn, rn, dot
