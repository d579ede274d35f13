"""Fused structured Q1 assembly: gather + quadrature + scatter in one kernel.

PyTorch port of dune_pdelab_tpu/assembly/structured_fused.py. The batched
general path streams (E, nqp, dim)-shaped intermediates through device
memory between passes; the fused operator computes the whole
ConvectionDiffusionFEM volume residual (with f) or Jacobian-apply (without
f) of a 3D uniform Q1 mesh in one pass of the structured_fused kernel
(kernels/structured_fused.py: CUDA on a CUDA tensor, its plain version on a
CPU tensor).

The problem's A/b/c/f are evaluated once per operator, time, dtype and
device at every element quadrature point, in torch on the device, in
z-slabs so that the evaluation's temporaries stay small; the arrays are
kept on the operator. The TPU tiling arguments of the reference
(`interpret`, `tz`, `cy`) have no counterpart.

Scope (checked by make_*; None returned otherwise, never because of the
device): single-leaf Q1 tensor C0 space, 3D uniform non-periodic cube mesh,
ConvectionDiffusionFEM volume kernels (A constant, a scalar field or a 3x3
tensor field; any b, c, f), no boundary or skeleton kernels, a quadrature
rule of at most QMAX Gauss points per axis (quad_order <= 7).

Reference analog: the element loop of the default assembler
(dune/pdelab/gridoperator/default/assembler.hh:84-279) jointly with
convectiondiffusionfem.hh:63-138.
"""
from __future__ import annotations

import numpy as np
import torch

from dune_pdelab_tpu_torch.kernels.structured_fused import (
    QMAX, TAB_WIDTH, FusedCoefficients, structured_fused,
)
from dune_pdelab_tpu_torch.space.space import to_numpy
from dune_pdelab_tpu_torch.utils.common import device_key

# coefficient evaluation works on z-slabs of about this many elements
_EVAL_SLAB_ELEMENTS = 1 << 22


def _qualifies(go, include_lambda):
    from dune_pdelab_tpu_torch.ops.convectiondiffusion import ConvectionDiffusionFEM
    space = go.space
    if not getattr(space, "is_leaf", False):
        return False
    fem, mesh = space.fem, space.mesh
    if mesh.geometry_type != "cube":
        return False         # a simplex mesh has no lattice to fuse over
    if (fem.continuity != "C0" or not hasattr(fem, "_mi")
            or fem.degree != 1 or mesh.dim != 3
            or mesh.geometry_type != "cube" or not mesh.uniform
            or any(mesh.periodic)):
        return False
    lop = go.lop
    if not isinstance(lop, ConvectionDiffusionFEM):
        return False
    # the kernel hard-codes the CD weak form; a subclass overriding the
    # volume terms would silently diverge
    if (type(lop).alpha_volume is not ConvectionDiffusionFEM.alpha_volume
            or type(lop).lambda_volume
            is not ConvectionDiffusionFEM.lambda_volume):
        return False
    if any(go.has.get(n) for n in ("alpha_boundary", "lambda_boundary",
                                   "alpha_skeleton", "lambda_skeleton")):
        return False
    if go._sel_elem is not None:
        return False         # selective assembly: the kernel has no element mask
    if go.cg is not None and go.cg.has_affine:
        return False         # hanging-node rows: the kernel has no P^T R(P x)
    if include_lambda and not go.has.get("lambda_volume"):
        return False
    # the kernel takes tensor rules of at most QMAX Gauss points per axis
    return go._vol_tabs[0][0].shape[0] <= QMAX**3


def _tabulation(go, dtype, device):
    """(nqp, 33) rows [phi, physical grad, w|J|] with the corners in the
    kernel's order a = dx + 2 dy + 4 dz."""
    mi = np.asarray(go.space.fem._mi)
    order = np.argsort(mi[:, 0] + 2 * mi[:, 1] + 4 * mi[:, 2])
    phi, gphys = go._vol_tabs[0][0], go._vol_tabs[0][1][0]
    nqp = phi.shape[0]
    tab = np.concatenate([phi[:, order], gphys[:, order, :].reshape(nqp, 24),
                          go.vol_geo.factor[0][:, None]], axis=1)
    assert tab.shape == (nqp, TAB_WIDTH)
    return torch.as_tensor(tab, dtype=dtype, device=device)


def _coefficients(go, time, include_lambda, dtype, device):
    """A/b/c(/f) at every element quadrature point, (nqp, ncomp, nzc, nyc,
    nxc) tensors; the points are the batched path's (element origin in
    float64, cast, plus the quadrature offset in `dtype`)."""
    problem = go.lop.set_time(time).problem
    mesh = go.mesh
    nxc, nyc, nzc = mesh.cells
    qoff = torch.as_tensor(go.vol_geo.qp_phys_offset, dtype=dtype, device=device)
    nqp = qoff.shape[0]

    xprobe = torch.linspace(0.1, 0.9, 6, dtype=torch.float64).reshape(2, 3)
    a_ndim = to_numpy(problem.A(xprobe)).ndim
    a_kind = 0 if a_ndim == 0 else (1 if a_ndim == 1 else 3)
    has_b = bool(np.any(to_numpy(problem.b(xprobe))))
    has_c = bool(np.any(to_numpy(problem.c(xprobe))))

    def alloc(ncomp):
        return torch.empty((nqp, ncomp, nzc, nyc, nxc), dtype=dtype, device=device)

    A = alloc(1 if a_kind == 1 else 9) if a_kind else None
    b = alloc(3) if has_b else None
    c = alloc(1) if has_c else None
    f = alloc(1) if include_lambda else None

    def axis(d, n):
        o = mesh.lower[d] + torch.arange(n, dtype=torch.float64, device=device) * mesh.h[d]
        return o.to(dtype)

    ox, oy, oz = axis(0, nxc), axis(1, nyc), axis(2, nzc)
    slab = max(1, _EVAL_SLAB_ELEMENTS // (nyc * nxc))

    def val(v, shape):
        return torch.broadcast_to(torch.as_tensor(v, dtype=dtype, device=device), shape)

    for q in range(nqp):
        for z0 in range(0, nzc, slab):
            z1 = min(nzc, z0 + slab)
            xs = torch.broadcast_tensors(
                (ox + qoff[q, 0])[None, None, :], (oy + qoff[q, 1])[None, :, None],
                (oz[z0:z1] + qoff[q, 2])[:, None, None])
            xq = torch.stack(xs, dim=-1)                      # (sz, nyc, nxc, 3)
            es = xq.shape[:-1]
            if a_kind == 1:
                A[q, 0, z0:z1] = val(problem.A(xq), es)
            elif a_kind == 3:
                A[q, :, z0:z1] = val(problem.A(xq), es + (3, 3)).reshape(
                    es + (9,)).permute(3, 0, 1, 2)
            if has_b:
                b[q, :, z0:z1] = val(problem.b(xq), es + (3,)).permute(3, 0, 1, 2)
            if has_c:
                c[q, 0, z0:z1] = val(problem.c(xq), es)
            if include_lambda:
                f[q, 0, z0:z1] = val(problem.f(xq), es)
    a_const = float(to_numpy(problem.A(xprobe))) if a_kind == 0 else 0.0
    return FusedCoefficients(a_kind, a_const, A, b, c, f)


class FusedOperator:
    """x -> the fused residual (include_lambda) or Jacobian-apply of `go`
    at `time`, through the structured_fused kernel. Tabulation and
    coefficient arrays are built on the first call per (dtype, device)."""

    def __init__(self, go, time, include_lambda):
        self.go = go
        self.time = time
        self.include_lambda = include_lambda
        self.dims = go.space._dof_grid_dims
        self._state = {}

    def state(self, dtype, device):
        device = device_key(device)
        key = (dtype, device)
        if key not in self._state:
            self._state[key] = (
                _tabulation(self.go, dtype, device),
                _coefficients(self.go, self.time, self.include_lambda, dtype, device))
        return self._state[key]

    def __call__(self, x):
        tab, coef = self.state(x.dtype, x.device)
        cg = self.go.cg
        mask = cg.mask_on(x.device) if cg is not None else None
        return structured_fused(x, mask, tab, coef, self.dims,
                                japply=not self.include_lambda)


def make_fused_residual(go, time=0.0):
    """Fused residual matching go.residual(x) (constrained rows zeroed).
    None when the operator does not qualify."""
    if not _qualifies(go, include_lambda=True):
        return None
    return FusedOperator(go, time, include_lambda=True)


def make_fused_japply(go, time=0.0):
    """Fused linear-operator apply matching go.jacobian_apply(0, z):
    y = mask ? z : A z with constrained columns zeroed. Linear LOPs only;
    None when the operator does not qualify. The variable-coefficient
    matrix-free level operator of linalg/gmg_varcoeff.py."""
    if not getattr(go.lop, "is_linear", False):
        return None
    if not _qualifies(go, include_lambda=False):
        return None
    return FusedOperator(go, time, include_lambda=False)
