"""structured_fused: the fused structured Q1 ConvectionDiffusionFEM operator.

Computes, over the (nz, ny, nx) node lattice of a 3D uniform Q1 mesh,
  residual mode (japply=False):  y = mask ? 0 : R(x)
  Jacobian mode (japply=True):   y = mask ? x : R0(x * !mask)
where R(u)_i = sum_e sum_q [(A grad u - b u) . grad phi_i + (c u - f) phi_i]
w_q |J| (R0: the same without f), with A, b, c, f given at every element
quadrature point by `FusedCoefficients` and the basis by `tab`.

Source note.
  Replaces: dune_pdelab_tpu/assembly/structured_fused.py _build_core (K3,
    the pallas_call at :256), reached through make_fused_residual and
    make_fused_japply (assembly/structured_fused.py of this package).
  Kernel: csrc/structured_fused.cu (CUDA C++, sm_90a), instantiated for
    float32 and float64 and specialised on A's shape.
  Coefficients: the TPU kernel evaluated the problem's A/b/c/f closures
    inside its body. A CUDA kernel cannot run Python closures, so the
    operator evaluates them once (per operator, time, dtype and device) in
    torch on the device and passes (nqp, ncomp, nzc, nyc, nxc) arrays. That
    costs memory: at 512^3 cells with nqp = 8 a field A takes 8 * 134M * 4 B
    = 4.3 GB (fp32), a 3x3 tensor A + b + c + f takes 14 times that (60 GB);
    and each apply reads 4 * nqp * ncomp bytes of coefficients per element
    (32 B for a field A) instead of the ~2 floats of x and y. Evaluating
    the coefficients inside the kernel is later work.
  Bound on the H100: arithmetic (about 560 FMAs per element for the 8-point
    rule, x 297/256 for the tile halo) with a field A; coefficient bytes
    grow with ncomp. The kernel is deterministic: no floating-point atomics.

The wrapper takes the plain PyTorch version only for a tensor on the CPU;
for a CUDA tensor it launches the kernel or raises. `launches` counts the
kernel launches.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from dune_pdelab_tpu_torch.kernels import _build

launches = 0
TAB_WIDTH = 33     # phi[8], grad[8][3], factor per quadrature point
# the plain version works on z-slabs of about this many elements, so that
# its temporaries stay small at 512^3
PLAIN_SLAB_ELEMENTS = 1 << 24


class FusedCoefficients(NamedTuple):
    """Coefficient values at every element quadrature point.

    a_kind: 0 constant A (a_const), 1 scalar field, 3 full 3x3 tensor.
    A: (nqp, 1 or 9, nzc, nyc, nxc), component i*3+j = A_ij; b: (nqp, 3, ..);
    c, f: (nqp, 1, ..). None where absent (b = 0, c = 0, no source).
    """
    a_kind: int
    a_const: float
    A: Optional[torch.Tensor]
    b: Optional[torch.Tensor]
    c: Optional[torch.Tensor]
    f: Optional[torch.Tensor]


def _corners(g, z0, z1):
    """The 8 corner views (corner a = dx + 2 dy + 4 dz) of element planes
    [z0, z1) of the node grid g (nz, ny, nx)."""
    nyc, nxc = g.shape[1] - 1, g.shape[2] - 1
    return [g[z0 + (a >> 2):z1 + (a >> 2), ((a >> 1) & 1):((a >> 1) & 1) + nyc,
              (a & 1):(a & 1) + nxc] for a in range(8)]


def structured_fused_reference(x, mask, tab, coef, dims, japply):
    """Plain PyTorch version, in z-slabs of about PLAIN_SLAB_ELEMENTS elements."""
    nx, ny, nz = dims
    nxc, nyc, nzc = nx - 1, ny - 1, nz - 1
    u = x if (mask is None or not japply) else torch.where(mask, 0.0, x)
    g = u.reshape(nz, ny, nx)
    r = torch.zeros_like(g)
    tv = tab.tolist()
    nqp = len(tv)
    slab = max(1, PLAIN_SLAB_ELEMENTS // (nyc * nxc))
    for z0 in range(0, nzc, slab):
        z1 = min(nzc, z0 + slab)
        U = _corners(g, z0, z1)
        out = [torch.zeros_like(U[0]) for _ in range(8)]
        for q in range(nqp):
            t = tv[q]
            uq = sum(t[a] * U[a] for a in range(8))
            gu = [sum(t[8 + 3 * a + d] * U[a] for a in range(8)) for d in range(3)]
            if coef.a_kind == 0:
                fl = [coef.a_const * gd for gd in gu]
            elif coef.a_kind == 1:
                av = coef.A[q, 0, z0:z1]
                fl = [av * gd for gd in gu]
            else:
                Aq = coef.A[q, :, z0:z1]
                fl = [Aq[3 * i] * gu[0] + Aq[3 * i + 1] * gu[1] + Aq[3 * i + 2] * gu[2]
                      for i in range(3)]
            if coef.b is not None:
                fl = [fl[d] - uq * coef.b[q, d, z0:z1] for d in range(3)]
            s = None
            if coef.c is not None:
                s = coef.c[q, 0, z0:z1] * uq
            if coef.f is not None:
                s = -coef.f[q, 0, z0:z1] if s is None else s - coef.f[q, 0, z0:z1]
            m = t[32]
            fl = [fd * m for fd in fl]
            if s is not None:
                s = s * m
            for a in range(8):
                term = t[8 + 3 * a] * fl[0] + t[9 + 3 * a] * fl[1] + t[10 + 3 * a] * fl[2]
                if s is not None:
                    term = term + t[a] * s
                out[a] += term
        for a in range(8):
            dz, dy, dx = a >> 2, (a >> 1) & 1, a & 1
            r[z0 + dz:z1 + dz, dy:dy + nyc, dx:dx + nxc] += out[a]
    y = r.reshape(-1)
    if mask is None:
        return y
    return torch.where(mask, x if japply else 0.0, y)


def _check(x, mask, tab, coef, dims):
    nx, ny, nz = dims
    if min(nx, ny, nz) < 2:
        raise ValueError(f"structured_fused needs >= 2 nodes per axis, got {dims}")
    _build.check_tensor(x, "x", (nx * ny * nz,))
    if mask is not None:
        _build.check_tensor(mask, "mask", x.shape, torch.bool, x.device)
    if tab.ndim != 2:
        raise ValueError(f"tab must be (nqp, {TAB_WIDTH}), got {tuple(tab.shape)}")
    nqp = tab.shape[0]
    _build.check_tensor(tab, "tab", (nqp, TAB_WIDTH), x.dtype, x.device)
    if coef.a_kind not in (0, 1, 3):
        raise ValueError(f"a_kind must be 0, 1 or 3, got {coef.a_kind}")
    el = (nz - 1, ny - 1, nx - 1)
    ncomp = {"A": {0: None, 1: 1, 3: 9}[coef.a_kind], "b": 3, "c": 1, "f": 1}
    for name, nc in ncomp.items():
        t = getattr(coef, name)
        if name == "A" and nc is None:
            if t is not None:
                raise ValueError("a constant A (a_kind 0) takes no A array")
            continue
        if t is None:
            if name == "A":
                raise ValueError(f"a_kind {coef.a_kind} needs an A array")
            continue
        _build.check_tensor(t, name, (nqp, nc) + el, x.dtype, x.device)


def structured_fused(x, mask, tab, coef: FusedCoefficients, dims, japply: bool):
    """Fused Q1 operator of the flat (N,) vector x on the (nx, ny, nz) node
    grid. mask: (N,) bool or None; tab: (nqp, 33) of x's dtype."""
    global launches
    dims = tuple(int(d) for d in dims)
    _check(x, mask, tab, coef, dims)
    if x.device.type == "cpu":
        return structured_fused_reference(x, mask, tab, coef, dims, japply)
    if x.device.type != "cuda":
        raise ValueError(f"structured_fused runs on CPU or CUDA tensors, got {x.device}")
    fn = {torch.float32: "dpt_structured_fused_f32",
          torch.float64: "dpt_structured_fused_f64"}.get(x.dtype)
    if fn is None:
        raise TypeError(f"structured_fused takes float32 or float64, got {x.dtype}")
    lib = _build.library()
    nx, ny, nz = dims
    y = torch.empty_like(x)
    rc = getattr(lib, fn)(
        _build.ptr(x), _build.ptr(mask), _build.ptr(y), nx, ny, nz,
        _build.ptr(tab), int(tab.shape[0]), int(coef.a_kind), float(coef.a_const),
        _build.ptr(coef.A), _build.ptr(coef.b), _build.ptr(coef.c),
        _build.ptr(coef.f), int(bool(japply)), _build.stream_ptr(x.device))
    _build.check(rc, "structured_fused")
    launches += 1
    return y
