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
    float32 and float64, specialised on A's shape and on q = 2 Gauss points
    per axis (other tensor rules up to q = QMAX: a runtime-q instantiation).
  Coefficients: the TPU kernel evaluated the problem's A/b/c/f closures
    inside its body. A CUDA kernel cannot run Python closures, so the
    operator evaluates them once (per operator, time, dtype and device) in
    torch on the device and passes (nqp, ncomp, nzc, nyc, nxc) arrays. That
    costs memory: at 512^3 cells with nqp = 8 a field A takes 8 * 134M * 4 B
    = 4.3 GB (fp32), a 3x3 tensor A + b + c + f takes 14 times that (60 GB);
    and each apply reads 4 * nqp * ncomp bytes of coefficients per element
    (32 B for a field A) instead of the ~2 floats of x and y. Evaluating
    the coefficients inside the kernel is later work.
  Bound on the H100: device-memory bytes. A field-A J.v in fp32 moves 41 B
    per element (x, mask, y, 8 coefficient values): 1.645 ms at 512^3 cells
    against 1.03 ms for the 512 flop per element of a sum-factorised
    evaluation at 67 TFLOP/s. Measured at about 47% of it: ~115 registers
    per thread leave 16 warps per SM to hide latency (PERF.md).
  Design: sum factorisation on the tensor rule. `tensor_rule` factors `tab`
    into 1D tables (per axis: the Q1 basis and its derivative scaled by 1 /
    h at the Gauss points; the weights w_q |J|), in float64 on the host, and
    raises unless their tensor product gives `tab` back; the kernel takes
    them by value (constant-bank FMA operands) and evaluates u and grad u
    with 2 + 3 + 4 one-dimensional contractions, the test-function sweep
    with their transposes. A Q1 derivative is -+1/h at every point, so its
    contractions are differences taken once per line. A block of 256 threads
    computes the 32 x 32 elements around its 31 x 31 node tile once each per
    element plane (no ragged pass), shares x contractions between
    neighbouring element rows, combines a node's <= 8 element contributions
    in fixed order (warp shuffle, one shared row exchange, a register
    carried along z), keeps the node planes' mask bytes in shared memory (no
    global load on the store path) and loads a field A two elements ahead.
    Deterministic: no floating-point atomics. The earlier design (per-point
    sums over all 8 corners, the tabulation read from shared memory, a
    ragged second element pass) and its times are in PERF.md.

The wrapper takes the plain PyTorch version only for a tensor on the CPU;
for a CUDA tensor it launches the kernel or raises. `launches` counts the
kernel launches.
"""
from __future__ import annotations

import weakref
from typing import NamedTuple, Optional

import numpy as np
import torch

from dune_pdelab_tpu_torch.kernels import _build

launches = 0
TAB_WIDTH = 33     # phi[8], grad[8][3], factor per quadrature point
QMAX = 4           # Gauss points per axis the kernel takes
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


class TensorRule(NamedTuple):
    """The tabulation of a tensor-product rule on the uniform Q1 cube, as 1D
    tables (float64). Axis d (0 = x), point i, corner c in {0, 1}:
    phi[d, i, c] the Q1 basis, dphi[d, i, c] its derivative times 1 / h_d;
    w[iz, iy, ix] = w_q |J|. The point (ix, iy, iz) is row ix + q (iy + q iz)
    of `tab` and of the coefficient arrays."""
    q: int
    phi: np.ndarray
    dphi: np.ndarray
    w: np.ndarray


def _rebuild(rule: TensorRule) -> np.ndarray:
    """The (q^3, 33) tabulation the 1D tables give (corner a = dx + 2 dy + 4 dz)."""
    q = rule.q
    k = np.arange(q**3)
    i = [k % q, (k // q) % q, k // q**2]               # point index per axis
    a = np.arange(8)
    c = [a & 1, (a >> 1) & 1, a >> 2]                  # corner bit per axis
    f = [rule.phi[d][i[d][:, None], c[d][None, :]] for d in range(3)]
    df = [rule.dphi[d][i[d][:, None], c[d][None, :]] for d in range(3)]
    grad = np.stack([df[0] * f[1] * f[2], f[0] * df[1] * f[2], f[0] * f[1] * df[2]], -1)
    return np.concatenate([f[0] * f[1] * f[2], grad.reshape(q**3, 24),
                           rule.w.reshape(q**3, 1)], axis=1)


def tensor_rule(tab) -> TensorRule:
    """Factor a (nqp, 33) Q1 tabulation into the kernel's 1D tables.

    The Gauss point of axis d is the sum of the basis values of the corners
    on that axis' upper face; 1 / h_d the same sum of the d-derivatives; the
    weights are split into a rank-one product. Raises ValueError unless
    nqp = q^3 with q <= QMAX, the rows run x fastest, and the tables' tensor
    product gives `tab` back: to 1e-13 relative (per block of columns: basis,
    gradients, weights) for a float64 tab, 16 ulp of its dtype otherwise."""
    tt = torch.as_tensor(tab)
    t = tt.detach().to("cpu", torch.float64).numpy()
    nqp = t.shape[0]
    q = round(nqp ** (1 / 3))
    if t.shape != (nqp, TAB_WIDTH) or q**3 != nqp or not 1 <= q <= QMAX:
        raise ValueError(f"tab {t.shape} is not a tensor rule of q <= {QMAX} points per axis")
    phi, grad = t[:, :8], t[:, 8:32].reshape(nqp, 8, 3)
    upper = [((np.arange(8) >> d) & 1) == 1 for d in range(3)]
    first = [np.arange(q) * q**d for d in range(3)]    # rows of the points (i, 0, 0), ...
    xi = [phi[first[d]][:, upper[d]].sum(1) for d in range(3)]
    inv_h = [grad[0, upper[d], d].sum() for d in range(3)]
    P = np.stack([np.stack([1.0 - p, p], -1) for p in xi])
    dP = np.stack([np.tile([-h, h], (q, 1)) for h in inv_h])
    W = t[:, 32].reshape(q, q, q)                      # [iz, iy, ix]
    wx, wy, wz = W.sum((0, 1)), W.sum((0, 2)), W.sum((1, 2))
    W = wz[:, None, None] * wy[None, :, None] * wx[None, None, :] / W.sum() ** 2
    rule = TensorRule(q, P, dP, W)
    tol = 1e-13 if tt.dtype == torch.float64 else 16 * float(torch.finfo(tt.dtype).eps)
    back = _rebuild(rule)
    for cols in (slice(0, 8), slice(8, 32), slice(32, 33)):
        err = np.abs(back[:, cols] - t[:, cols]).max()
        if not err <= tol * np.abs(t[:, cols]).max():
            raise ValueError(f"tab is not the tensor product of 1D tables (columns "
                             f"{cols.start}:{cols.stop} differ by {err:.3e})")
    return rule


def _packed(rule: TensorRule) -> np.ndarray:
    """The kernel's float64 table block: phi[3][QMAX][2], inv_h[3] (a Q1
    derivative is -+inv_h at every point: dphi[d, i] = [-inv_h, inv_h]),
    w[QMAX^3] (w at ix + q (iy + q iz)), zero-padded."""
    q = rule.q
    phi = np.zeros((3, QMAX, 2))
    w = np.zeros(QMAX**3)
    phi[:, :q], w[:q**3] = rule.phi, rule.w.reshape(-1)
    return np.ascontiguousarray(np.concatenate([phi.ravel(), rule.dphi[:, 0, 1], w]))


# tables per tab tensor, held while it lives: id -> (weakref, version, tables)
_rules: dict = {}


def _rule_of(tab):
    """(TensorRule, packed tables) of `tab`, derived once per tab tensor (a
    device tab is read back to the host on its first use only)."""
    hit = _rules.get(id(tab))
    if hit is not None and hit[0]() is tab and hit[1] == tab._version:
        return hit[2]
    rule = tensor_rule(tab)
    for k in [k for k, v in _rules.items() if v[0]() is None]:
        del _rules[k]
    _rules[id(tab)] = (weakref.ref(tab), tab._version, (rule, _packed(rule)))
    return _rules[id(tab)][2]


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
    grid. mask: (N,) bool or None; tab: (nqp, 33) of x's dtype, a tensor
    rule (`tensor_rule` raises otherwise)."""
    global launches
    dims = tuple(int(d) for d in dims)
    _check(x, mask, tab, coef, dims)
    rule, packed = _rule_of(tab)
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
        packed.ctypes.data, rule.q, int(coef.a_kind), float(coef.a_const),
        _build.ptr(coef.A), _build.ptr(coef.b), _build.ptr(coef.c),
        _build.ptr(coef.f), int(bool(japply)), _build.stream_ptr(x.device))
    _build.check(rc, "structured_fused")
    launches += 1
    return y
