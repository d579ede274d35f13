"""Nonlinear convection-diffusion FEM kernel with the reference's
(f, w, v, D, q, j) parameter protocol.

PyTorch port of dune_pdelab_tpu/ops/nonlinearconvectiondiffusion.py
(reference: dune/pdelab/localoperator/nonlinearconvectiondiffusionfem.hh,
parameter interface :76-160, kernel :247-392). PDE solved:

    div( q(x,u) - D(x) v(u) grad w(u) ) = f(x,u)   in Omega
    u = g                                           on Gamma_D
    (q - D grad w(u)) . n = j                       on Gamma_N

The nonlinearity w is applied nodally (w_i = w(u_i), the Lagrange-basis
assumption of :272-275), so the kernel works with the interpolant
w_h = sum_i w(u_i) phi_i; the `u` handed to f, q and v at quadrature points
is w_h's value there. The Jacobian is torch.func.jvp of this residual (the
reference's hand-written finite differences are replaced by exact AD).
"""
from __future__ import annotations

import copy

import numpy as np
import torch

from dune_pdelab_tpu_torch.ops.base import FaceContext, LocalOperator, VolumeContext
from dune_pdelab_tpu_torch.ops.convectiondiffusion import (
    BCType, _is_zero, apply_tensor, at_face_qp,
)


class NonlinearConvectionDiffusionProblem:
    """Parameter protocol (nonlinearconvectiondiffusionfem.hh:76-160).

    Every method takes batched physical points x (..., dim) as a tensor;
    the state-dependent ones also take the (broadcast-compatible) scalar
    state. The defaults reduce the PDE to -Laplace(u) = 0.
    """

    time = 0.0

    def f(self, x, u):
        """Source term f(x,u)."""
        return 0.0

    def w(self, x, u):
        """Nonlinearity under the gradient (applied nodally)."""
        return u

    def v(self, x, u):
        """Scalar diffusion multiplier v(u)."""
        return 1.0

    def D(self, x):
        """Diffusion tensor: scalar, (...,) field, or (..., d, d)."""
        return 1.0

    def q(self, x, u):
        """Convective flux vector q(x,u): (..., dim)."""
        return torch.zeros_like(x)

    def j(self, x):
        """Neumann flux."""
        return 0.0

    def bctype(self, x):
        return BCType.DIRICHLET

    def g(self, x):
        """Dirichlet value / initial-guess extension."""
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


def _as(v, like):
    """v as a tensor of like's dtype and device; a Python number is filled
    there (no copy from the host, so the apply can be captured into a CUDA
    graph)."""
    if isinstance(v, (int, float)):
        return torch.full((), v, dtype=like.dtype, device=like.device)
    return torch.as_tensor(v, dtype=like.dtype, device=like.device)


class NonlinearConvectionDiffusionFEM(LocalOperator):
    """Conforming FEM kernel (nonlinearconvectiondiffusionfem.hh:247)."""

    is_linear = False

    def __init__(self, problem: NonlinearConvectionDiffusionProblem,
                 quadrature_add: int = 2):
        self.problem = problem
        self.quadrature_add = quadrature_add

    def set_time(self, t):
        new = copy.copy(self)
        new.problem = self.problem.with_time(t)
        return new

    def _nodal_w(self, ctx, u):
        """w applied at the nodes with the element-centre position (the
        reference evaluates w at the reference-element centre, :273-275)."""
        xc = torch.mean(ctx.x, dim=1)                    # (E, dim)
        return _as(self.problem.w(xc[:, None, :], u), u)

    def alpha_volume(self, ctx: VolumeContext, u):
        p, tab = self.problem, ctx.tab
        wn = self._nodal_w(ctx, u)                      # (E, nb)
        wq = self.value_at_qp(tab, wn)                  # (E, nqp)
        gw = self.gradient_at_qp(tab, wn)               # (E, nqp, d)
        flux = apply_tensor(_as(p.D(ctx.x), gw), _as(p.v(ctx.x, wq), gw)[..., None] * gw)
        q = torch.broadcast_to(_as(p.q(ctx.x, wq), flux), flux.shape)
        r = self.accumulate_gradient(tab, ctx.factor, flux - q)
        fv = p.f(ctx.x, wq)
        if not _is_zero(fv):
            r = r - self.accumulate_value(
                tab, ctx.factor, torch.broadcast_to(_as(fv, ctx.factor), ctx.x.shape[:-1]))
        return r

    def alpha_boundary(self, ctx: FaceContext, u):
        """Neumann faces: + j phi (reference :334-392; Dirichlet faces are
        strongly constrained and skipped)."""
        p, tab = self.problem, ctx.tab
        bct = at_face_qp(p.bctype(ctx.x), ctx)
        jq = at_face_qp(p.j(ctx.x), ctx, ctx.factor.dtype)
        return self.accumulate_value(tab, ctx.factor,
                                     torch.where(bct == BCType.NEUMANN, jq, 0.0))
