"""Convection-diffusion(-reaction) operators: CG-FEM kernel + parameter protocol.

PyTorch port of dune_pdelab_tpu/ops/convectiondiffusion.py (reference:
dune/pdelab/localoperator/convectiondiffusionparameter.hh and
convectiondiffusionfem.hh:39-207). The boundary kernels (alpha_boundary,
lambda_boundary) keep their place in the protocol but need the face groups
of ROADMAP slice 7; the GridOperator refuses them unless
skip_boundary=True.

Weak form: find u with
  ∫ (A∇u)·∇v - u b·∇v + c u v dx = ∫ f v dx,
Dirichlet imposed strongly through constraints.
"""
from __future__ import annotations

import copy

import numpy as np
import torch

from dune_pdelab_tpu_torch.ops.base import LocalOperator, VolumeContext


class BCType:
    """Boundary condition codes (reference:
    convectiondiffusionparameter.hh ConvectionDiffusionBoundaryConditions)."""
    NEUMANN = 0
    DIRICHLET = 1
    OUTFLOW = 2
    NONE = 3


def apply_tensor(A, g):
    """A * g where A is scalar, (...,) field, or (..., d, d) tensor; g (..., d)."""
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

    def alpha_boundary(self, ctx, u):
        raise NotImplementedError(
            "boundary face groups are not ported yet (ROADMAP slice 7)")

    def lambda_boundary(self, ctx):
        raise NotImplementedError(
            "boundary face groups are not ported yet (ROADMAP slice 7)")


def _is_zero(v) -> bool:
    """Static zero test for coefficient shortcuts."""
    if isinstance(v, torch.Tensor):
        return v.numel() == 1 and float(v) == 0.0
    try:
        return float(v) == 0.0
    except (TypeError, ValueError):
        return False
