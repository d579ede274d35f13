"""Fully fused CG on a compiled k = 1 stencil: two kernel passes per iteration.

PyTorch port of dune_pdelab_tpu/assembly/fused_cg_pallas.py (`qualifies`,
`make_fused_cg`, `FusedCGStats`). Vectors live as (nz, ny, nx) grids; the
Dirichlet boundary (all six faces, which `qualifies` demands) is enforced
inside the kernels, and each CG iteration is exactly

    K2(x, r, p, alpha) -> x + alpha p, r' = r - alpha A p, <r', r'>
    K1(r', p, beta)    -> p' = r' + beta p, <p', A p'>

(kernels/fused_cg.py: CUDA kernels for CUDA tensors, the plain versions
for CPU tensors). alpha = rr / pAp and beta = rr' / rr stay on the device as
0-d tensors. With tol == 0 (bench mode) the loop runs all maxiter iterations
and issues no host sync; with tol > 0 it reads rr once per iteration for the
stop test.

Unlike the TPU version this takes any grid of dims >= 3 and float32 or
float64; only the operator-shape gates remain.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from dune_pdelab_tpu_torch.kernels.fused_cg import fused_cg_k1, fused_cg_k2
from dune_pdelab_tpu_torch.kernels.stencil27 import tap_tensor


class FusedCGStats(NamedTuple):
    iterations: int
    defect: Any       # 0-d tensor
    converged: Any    # 0-d bool tensor


def _six_faces(nx, ny, nz, device):
    bnd = torch.zeros((nz, ny, nx), dtype=torch.bool, device=device)
    bnd[0] = bnd[-1] = True
    bnd[:, 0] = bnd[:, -1] = True
    bnd[:, :, 0] = bnd[:, :, -1] = True
    return bnd


def qualifies(stencil_op) -> bool:
    """Fused CG requires k = 1, a single class, 3D, and the constraint mask
    == exactly the six grid faces."""
    if stencil_op.k != 1 or stencil_op.weights.shape[0] != 1:
        return False
    dims = stencil_op.dims
    if len(dims) != 3 or min(dims) < 3 or stencil_op.mask is None:
        return False
    nx, ny, nz = (int(d) for d in dims)
    m = stencil_op.mask.reshape(nz, ny, nx)
    return bool(torch.equal(m, _six_faces(nx, ny, nz, m.device)))


def make_fused_cg(stencil_op, maxiter=100, tol=1e-8):
    """Fused-CG solver for a qualifying StencilOperator.

    Returns solve(b) -> (z, FusedCGStats) solving A z = b with z0 = 0,
    where A is the masked stencil. b must be zero on Dirichlet rows (the
    residual convention). Matches linalg.cg semantics: stop when
    ||r|| <= tol * ||b|| or at maxiter.
    """
    if not qualifies(stencil_op):
        raise ValueError("stencil does not qualify for fused CG")
    nx, ny, nz = (int(d) for d in stencil_op.dims)
    w27 = tap_tensor(stencil_op.offsets, stencil_op.weights[0])

    def solve(b):
        bg = b.reshape(nz, ny, nx)
        x = torch.zeros_like(bg)
        r = bg
        p, pap = fused_cg_k1(bg, bg, torch.zeros((), dtype=b.dtype,
                                                 device=b.device), w27)
        rr = torch.dot(b, b)
        stop2 = (tol * tol) * rr
        it = 0
        while it < maxiter and (tol == 0 or bool(rr > stop2)):
            alpha = rr / pap
            x, r, rr_new = fused_cg_k2(x, r, p, alpha, w27)
            beta = rr_new / rr
            p, pap = fused_cg_k1(r, p, beta, w27)
            rr = rr_new
            it += 1
        stats = FusedCGStats(iterations=it, defect=torch.sqrt(rr),
                             converged=rr <= stop2)
        return x.reshape(-1), stats

    return solve
