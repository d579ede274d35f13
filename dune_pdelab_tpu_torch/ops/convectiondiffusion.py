"""Convection-diffusion(-reaction) operators: CG-FEM kernel + parameter protocol.

PyTorch port of dune_pdelab_tpu/ops/convectiondiffusion.py (reference:
dune/pdelab/localoperator/convectiondiffusionparameter.hh and
convectiondiffusionfem.hh:39-207). The boundary kernels (alpha_boundary:
outflow (b.n) u v; lambda_boundary: Neumann j v and outflow o v) run on the
GridOperator's boundary face groups; a pure-Dirichlet problem may skip them
with skip_boundary=True.

Weak form: find u with
  ∫ (A∇u)·∇v - u b·∇v + c u v dx = ∫ f v dx,
Dirichlet imposed strongly through constraints.
"""
from __future__ import annotations

import copy

import numpy as np
import torch

from dune_pdelab_tpu_torch.ops.base import FaceContext, LocalOperator, VolumeContext


class BCType:
    """Boundary condition codes (reference:
    convectiondiffusionparameter.hh ConvectionDiffusionBoundaryConditions)."""
    NEUMANN = 0
    DIRICHLET = 1
    OUTFLOW = 2
    NONE = 3


def apply_tensor(A, g):
    """A * g where A is scalar, (...,) field, or (..., d, d) tensor; g (..., d).
    A Python number multiplies directly (no tensor copied from the host, so
    the apply can be captured into a CUDA graph)."""
    if isinstance(A, (int, float)):
        return A * g
    A = torch.as_tensor(A, dtype=g.dtype, device=g.device)
    if A.ndim >= g.ndim + 1 and A.shape[-1] == g.shape[-1] == A.shape[-2]:
        return torch.einsum("...ij,...j->...i", A, g)
    return A[..., None] * g if A.ndim == g.ndim - 1 else A * g


class ConvectionDiffusionProblem:
    """Default parameter class: -Δu = 0 with homogeneous Dirichlet BCs.

    Subclass and override; every method takes batched physical points
    x (..., dim) as a torch tensor and returns a tensor or a scalar that
    broadcasts. `bctype` is evaluated on numpy points by `constraints`, as
    in the reference.
    """

    time = 0.0

    def A(self, x):
        """Diffusion tensor: scalar, (...,) field, or (..., d, d)."""
        return 1.0

    def b(self, x):
        """Velocity field (..., dim)."""
        return torch.zeros_like(x)

    def c(self, x):
        """Reaction coefficient."""
        return 0.0

    def f(self, x):
        """Source term."""
        return 0.0

    def bctype(self, x):
        """Boundary condition code at boundary points (BCType values)."""
        return BCType.DIRICHLET

    def g(self, x):
        """Dirichlet boundary value (also used as initial-guess extension)."""
        return 0.0

    def j(self, x):
        """Neumann flux."""
        return 0.0

    def o(self, x):
        """Outflow boundary term."""
        return 0.0

    def with_time(self, t):
        p = copy.copy(self)
        p.time = t
        return p

    def dirichlet_bctype(self):
        """bctype callable for `constraints()`: True where Dirichlet."""

        def bc(x):
            v = self.bctype(x)
            return np.broadcast_to(np.asarray(v) == BCType.DIRICHLET, x.shape[:-1])
        return bc


class ConvectionDiffusionFEM(LocalOperator):
    """Conforming FEM convection-diffusion kernel (reference:
    dune/pdelab/localoperator/convectiondiffusionfem.hh:39)."""

    is_linear = True

    def __init__(self, problem: ConvectionDiffusionProblem, quadrature_add: int = 0):
        self.problem = problem
        self.quadrature_add = quadrature_add

    def set_time(self, t):
        new = copy.copy(self)
        new.problem = self.problem.with_time(t)
        return new

    def alpha_volume(self, ctx: VolumeContext, u):
        p, tab = self.problem, ctx.tab
        uq = self.value_at_qp(tab, u)            # (E, nqp)
        gu = self.gradient_at_qp(tab, u)         # (E, nqp, d)
        flux = apply_tensor(p.A(ctx.x), gu)      # A grad u
        b = torch.as_tensor(p.b(ctx.x), dtype=gu.dtype, device=gu.device)
        flux = flux - uq[..., None] * b          # - u b (convective flux)
        r = self.accumulate_gradient(tab, ctx.factor, flux)
        c = p.c(ctx.x)
        if not _is_zero(c):
            r = r + self.accumulate_value(tab, ctx.factor, c * uq)
        return r

    def lambda_volume(self, ctx: VolumeContext):
        p, tab = self.problem, ctx.tab
        f = torch.broadcast_to(
            torch.as_tensor(p.f(ctx.x), dtype=ctx.factor.dtype,
                            device=ctx.factor.device),
            ctx.x.shape[:-1])
        return self.accumulate_value(tab, ctx.factor, -f)

    def alpha_boundary(self, ctx: FaceContext, u):
        p, tab = self.problem, ctx.tab
        bct = at_face_qp(p.bctype(ctx.x), ctx)
        uq = self.value_at_qp(tab, u)
        bn = normal_flux(p.b(ctx.x), ctx)
        w = torch.where(bct == BCType.OUTFLOW, bn * uq, 0.0)
        return self.accumulate_value(tab, ctx.factor, w)

    def lambda_boundary(self, ctx: FaceContext):
        p, tab = self.problem, ctx.tab
        bct = at_face_qp(p.bctype(ctx.x), ctx)
        jflux = at_face_qp(p.j(ctx.x), ctx, ctx.factor.dtype)
        o = at_face_qp(p.o(ctx.x), ctx, ctx.factor.dtype)
        w = torch.where(bct == BCType.NEUMANN, jflux,
                        torch.where(bct == BCType.OUTFLOW, o, 0.0))
        return self.accumulate_value(tab, ctx.factor, w)


def at_face_qp(v, ctx, dtype=None):
    """A callback's value (tensor, array or scalar) as a tensor of shape
    x.shape[:-1] on the context's device; a Python number is filled there
    (no copy from the host)."""
    if isinstance(v, (bool, int, float)):
        kind = torch.bool if isinstance(v, bool) else (
            torch.int64 if isinstance(v, int) else torch.get_default_dtype())
        return torch.full(ctx.x.shape[:-1], v, dtype=dtype or kind, device=ctx.x.device)
    t = torch.as_tensor(v, device=ctx.x.device)
    if dtype is not None:
        t = t.to(dtype)
    return torch.broadcast_to(t, ctx.x.shape[:-1])


def normal_flux(b, ctx):
    """b . n at the face quadrature points: (F, nqp)."""
    b = torch.as_tensor(b, dtype=ctx.x.dtype, device=ctx.x.device)
    return (torch.broadcast_to(b, ctx.x.shape) * ctx.normal).sum(-1)


def _is_zero(v) -> bool:
    """Static zero test for coefficient shortcuts."""
    if isinstance(v, torch.Tensor):
        return v.numel() == 1 and float(v) == 0.0
    try:
        return float(v) == 0.0
    except (TypeError, ValueError):
        return False
