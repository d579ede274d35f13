"""blockstencil: the DG block stencil in two layouts.

Computes y[e] = sum_t W_t z[e + off_t] + the per-side corrections dD on
boundary elements, over the face taps t = (0, -x, +x, -y, +y, -z, +z),
reads outside the grid equal to 0: exactly `BlockStencilOperator`
(assembly/blockstencil.py). Two entry points:

  * block_stencil_mm(z, W, dD, cells): mode-major z (nz, nb, ny, nx), 3D;
  * block_stencil_em(z, W, dD, cells): element-major z, flat (E*nb,) with
    DOF e*nb + j, 2D or 3D.

W is (7, nb, nb) in the tap order above and dD (3, 2, nb, nb) (dD[d, 0] on
elements with coordinate d = 0, dD[d, 1] on coordinate d = n_d - 1), both
of z's dtype on z's device; `tap_tensors` builds them from a
BlockStencilOperator's arrays. In 2D the z taps and z sides are not read.

Source note.
  Replaces: dune_pdelab_tpu/assembly/blockstencil_mm.py build_mm_block_apply
    (K5a), build_mm_flat_apply (K5b, the production `mxu2` mode) and
    build_mm_vreg_apply (K5c), and dune_pdelab_tpu/assembly/
    blockstencil_pallas.py build_block_stencil_apply (K6).
  Kernel: csrc/blockstencil.cu (CUDA C++, sm_90a), fp32 and fp64.
  Bound on the H100: device-memory bytes (z read and y written once:
    8 B/DOF in fp32) against 7*nb multiply-adds per DOF; what limits the
    kernel is instruction issue and its memory pipeline, so no weight is
    loaded from global memory inside the tap loop where it can be avoided.
    `block_path(dtype, nb)` states the path:
      * "param" for nb in PARAM_NB = (4, 8, 9) (Q1/Q2 in 2D, Q1 in 3D), any
        dtype: the 13 weight blocks travel as a kernel parameter (at most
        13*81*8 = 8,424 B, within the 32,764 B sm_90 takes since CUDA 12.1)
        and reach the FMAs through uniform registers. `tap_tensors` packs
        the host copy (`pack_taps`) once per weight pair, from the numpy
        arrays, and keeps it on W; an apply copies nothing off the card and
        refuses a W that `tap_tensors` did not make or that changed since.
        Mode-major: one thread per element marching along z, the next plane
        loaded while this one is computed; element-major: rows staged
        through shared memory by 16-byte cp.async, marching along y;
      * "shared" for any other nb (27 = Q2 in 3D, 64 = Q3 in 3D, ...): CH
        outputs per pass (28 for nb = 27, else 8), the weights of each pass
        staged into shared memory as 13*nb rows of CH values, as many rows
        at a time as `shared_plan` says (all of them up to nb = 279 in fp64,
        558 in fp32), so every nb runs.
    There is no __constant__ path: the card's toolkit (CUDA 12.9) takes the
    parameter path's largest block set.

The wrapper takes the plain PyTorch version only for a tensor on the CPU;
for a CUDA tensor it launches the kernel or raises. A CUDA z must start on
a 16-byte boundary, as the element-major kernel copies rows in 16-byte
chunks: a fresh tensor does, a view at another offset is refused (not
copied). `launches_mm` and `launches_em` count the kernel launches of the
two entry points.
"""
from __future__ import annotations

import numpy as np
import torch

from dune_pdelab_tpu_torch.kernels import _build

launches_mm = 0
launches_em = 0

PARAM_NB = (4, 8, 9)            # nb compiled with the weights as a kernel parameter
_PATH_CODE = {"param": 0, "shared": 1}
SMEM_BYTES = 232448             # shared memory one block may use on the H100

# tap order of W: offset (dx, dy, dz) of tap t
TAP_ORDER = ((0, 0, 0), (-1, 0, 0), (1, 0, 0), (0, -1, 0), (0, 1, 0),
             (0, 0, -1), (0, 0, 1))


def tap_arrays(W_taps, offsets, dD_sides):
    """(W (7, nb, nb), dD (3, 2, nb, nb)) float64 in the kernel's order from
    a BlockStencilOperator's numpy arrays (taps absent in 2D are zero)."""
    W_taps = np.asarray(W_taps, np.float64)
    nb = W_taps.shape[-1]
    W = np.zeros((7, nb, nb))
    for t, off in enumerate(np.asarray(offsets)):
        o = tuple(int(v) for v in off) + (0,) * (3 - len(off))
        if o not in TAP_ORDER:
            raise ValueError(f"block stencil tap {o} is not a face tap")
        W[TAP_ORDER.index(o)] = W_taps[t]
    dD_sides = np.asarray(dD_sides, np.float64)
    dD = np.zeros((3, 2, nb, nb))
    dD[:dD_sides.shape[0]] = dD_sides
    return W, dD


def pack_taps(W, dD, dtype):
    """The parameter path's host copy of the weights: W (7, nb, nb) then dD
    (3, 2, nb, nb) as 13*nb*nb contiguous values of `dtype` (blocks in the
    order taps 0, -x, +x, -y, +y, -z, +z, sides x-, x+, y-, y+, z-, z+;
    each row-major [a][b])."""
    npdt = {torch.float32: np.float32, torch.float64: np.float64}[dtype]
    W, dD = np.asarray(W), np.asarray(dD)
    nb = W.shape[-1]
    return np.ascontiguousarray(
        np.concatenate([W.reshape(7, nb, nb), dD.reshape(6, nb, nb)]).reshape(-1),
        dtype=npdt)


def block_path(dtype, nb):
    """The kernel path for (dtype, nb): "param" for nb in PARAM_NB, else
    "shared"."""
    return "param" if nb in PARAM_NB else "shared"


def shared_plan(dtype, nb):
    """The shared path's (ch, rows): outputs per pass (28 for nb = 27, else
    8) and weight rows of ch values staged at a time: all 13*nb where they
    fit in the SMEM_BYTES of a block, else as many as fit."""
    ch = 28 if nb == 27 else 8
    return ch, min(13 * nb, SMEM_BYTES // (ch * torch.empty((), dtype=dtype).element_size()))


def _packed_for(W, dD):
    """The host weights that `tap_tensors` packed with W and dD."""
    hit = getattr(W, "_dpt_packed", None)
    if hit is None or hit[0] is not dD or hit[1:3] != (W._version, dD._version):
        raise ValueError("the block stencil's parameter path takes the (W, dD) of "
                         "tap_tensors, unchanged since: their host copy is packed there")
    return hit[3]


def tap_tensors(W_taps, offsets, dD_sides, dtype, device):
    """(W (7, nb, nb), dD (3, 2, nb, nb)) in the kernel's order, in `dtype`
    on `device`, from a BlockStencilOperator's numpy arrays. W keeps their
    host weights (pack_taps of the same arrays) with the versions of W and
    dD, so no apply copies them back."""
    W, dD = tap_arrays(W_taps, offsets, dD_sides)
    Wt = torch.as_tensor(W, dtype=dtype, device=device)
    dDt = torch.as_tensor(dD, dtype=dtype, device=device)
    Wt._dpt_packed = (dDt, Wt._version, dDt._version, pack_taps(W, dD, dtype))
    return Wt, dDt


def _plain(zg, W, dD, maxis, saxes):
    """Shifted slices with one contraction per tap on a grid view zg whose
    mode axis is `maxis` and whose x, y(, z) axes are `saxes`."""
    def apply(Wt, piece):
        return torch.movedim(torch.tensordot(Wt, piece, dims=([1], [maxis])), 0, maxis)

    def sl(ax, lo, hi):
        idx = [slice(None)] * zg.ndim
        idx[ax] = slice(lo, hi)
        return tuple(idx)

    y = apply(W[0], zg)
    for d, ax in enumerate(saxes):
        n = zg.shape[ax]
        y[sl(ax, 1, n)] += apply(W[1 + 2 * d], zg[sl(ax, 0, n - 1)])
        y[sl(ax, 0, n - 1)] += apply(W[2 + 2 * d], zg[sl(ax, 1, n)])
    for d, ax in enumerate(saxes):
        n = zg.shape[ax]
        for side, face in ((0, sl(ax, 0, 1)), (1, sl(ax, n - 1, n))):
            y[face] += apply(dD[d, side], zg[face])
    return y


def block_stencil_mm_reference(z, W, dD, cells):
    """Plain PyTorch version of the mode-major apply: (nz, nb, ny, nx)."""
    return _plain(z, W, dD, 1, (3, 2, 0)).contiguous()


def block_stencil_em_reference(z, W, dD, cells):
    """Plain PyTorch version of the element-major apply: flat (E*nb,)."""
    nb = W.shape[-1]
    grid = tuple(reversed([int(c) for c in cells])) + (nb,)
    dim = len(cells)
    saxes = tuple(range(dim - 1, -1, -1))
    return _plain(z.reshape(grid), W, dD, dim, saxes).reshape(-1)


def _launch(z, W, dD, cells, strides, name):
    fn = {torch.float32: "dpt_blockstencil_f32",
          torch.float64: "dpt_blockstencil_f64"}.get(z.dtype)
    if fn is None:
        raise TypeError(f"{name} takes float32 or float64, got {z.dtype}")
    if z.device.type != "cuda":
        raise ValueError(f"{name} runs on CPU or CUDA tensors, got {z.device}")
    if z.data_ptr() % 16:
        raise ValueError(f"{name}: z must start on a 16-byte boundary (rows are "
                         "copied in 16-byte chunks); pass a copy of this view")
    nb = W.shape[-1]
    path = block_path(z.dtype, nb)
    packed = _packed_for(W, dD) if path == "param" else None
    ch, rows = shared_plan(z.dtype, nb) if path == "shared" else (0, 0)
    nx, ny = int(cells[0]), int(cells[1])
    nz = int(cells[2]) if len(cells) == 3 else 1
    lib = _build.library()
    y = torch.empty_like(z)
    rc = getattr(lib, fn)(_build.ptr(z), _build.ptr(W), _build.ptr(dD), _build.ptr(y),
                          nx, ny, nz, nb, len(cells), *strides,
                          None if packed is None else packed.ctypes.data,
                          _PATH_CODE[path], ch, rows, _build.stream_ptr(z.device))
    _build.check(rc, name)
    return y


def _check(z, W, dD, cells, shape):
    if len(cells) not in (2, 3) or min(int(c) for c in cells) < 1:
        raise ValueError(f"block stencil needs 2 or 3 cell counts >= 1, got {cells}")
    nb = W.shape[-1]
    _build.check_tensor(z, "z", shape)
    _build.check_tensor(W, "W", (7, nb, nb), z.dtype, z.device)
    _build.check_tensor(dD, "dD", (3, 2, nb, nb), z.dtype, z.device)


def block_stencil_mm(z, W, dD, cells):
    """Mode-major block stencil of z (nz, nb, ny, nx) on the 3D lattice
    cells = (nx, ny, nz)."""
    if len(cells) != 3:
        raise ValueError(f"the mode-major layout is 3D, got cells {cells}")
    nx, ny, nz = (int(c) for c in cells)
    nb = W.shape[-1]
    _check(z, W, dD, cells, (nz, nb, ny, nx))
    if z.device.type == "cpu":
        return block_stencil_mm_reference(z, W, dD, cells)
    global launches_mm
    y = _launch(z, W, dD, cells, (1, nx, nb * ny * nx, ny * nx), "block_stencil_mm")
    launches_mm += 1
    return y


def block_stencil_em(z, W, dD, cells):
    """Element-major block stencil of the flat z (E*nb,) on the 2D or 3D
    lattice `cells` (dim 0 fastest)."""
    nb = W.shape[-1]
    nel = int(np.prod([int(c) for c in cells]))
    _check(z, W, dD, cells, (nel * nb,))
    if z.device.type == "cpu":
        return block_stencil_em_reference(z, W, dD, cells)
    nx, ny = int(cells[0]), int(cells[1])
    global launches_em
    y = _launch(z, W, dD, cells, (nb, nx * nb, ny * nx * nb, 1), "block_stencil_em")
    launches_em += 1
    return y
