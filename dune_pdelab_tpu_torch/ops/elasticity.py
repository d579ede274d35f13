"""Linear elasticity operator on vector (Power) spaces.

PyTorch port of dune_pdelab_tpu/ops/elasticity.py (reference:
dune/pdelab/localoperator/linearelasticity.hh:38 and
linearelasticityparameter.hh). Weak form (residual convention):

  sum_c ∫ mu (∂u_c/∂x_j + ∂u_j/∂x_c) ∂φ_c/∂x_j
        + lambda (∇·u) ∂φ_c/∂x_c  -  f_c φ_c dx  -  ∮_ΓN t_c φ_c ds

with Lame parameters lambda/mu, body force f, surface traction t, and
strongly imposed Dirichlet displacements. A composite space, so its
solves take the general-jvp tier.
"""
from __future__ import annotations

import copy

import numpy as np
import torch

from dune_pdelab_tpu_torch.ops.base import FaceContext, LocalOperator, VolumeContext
from dune_pdelab_tpu_torch.space.space import to_numpy


class LinearElasticityParameters:
    """Lame coefficients + loads (linearelasticityparameter.hh analog).
    Callbacks receive tensors of points (..., dim)."""

    time = 0.0

    def __init__(self, lam=1.0, mu=1.0):
        self.lam = lam
        self.mu = mu

    def f(self, x):
        """Body force (..., dim)."""
        return torch.zeros_like(x)

    def g(self, x):
        """Dirichlet displacement (..., dim)."""
        return torch.zeros_like(x)

    def traction(self, x):
        """Neumann surface traction (..., dim) (zero = free surface)."""
        return torch.zeros_like(x)

    def is_neumann(self, x):
        """Boundary classification at face points: True -> traction BC."""
        return torch.zeros(x.shape[:-1], dtype=torch.bool, device=x.device)

    def with_time(self, t):
        p = copy.copy(self)
        p.time = t
        return p

    def dirichlet_bctype(self):
        """bctype callable for `constraints()` (numpy points): True where
        Dirichlet."""
        def bc(x):
            return ~np.asarray(to_numpy(self.is_neumann(torch.as_tensor(x))), bool)
        return bc


class LinearElasticity(LocalOperator):
    """Vector-valued kernel; u = (u_0, ..., u_{d-1}) leaf tuple."""

    is_linear = True

    def __init__(self, params: LinearElasticityParameters):
        self.params = params

    def set_time(self, t):
        new = copy.copy(self)
        new.params = self.params.with_time(t)
        return new

    def alpha_volume(self, ctx: VolumeContext, u):
        dim = ctx.x.shape[-1]
        if len(u) != dim:
            raise ValueError(f"LinearElasticity needs {dim} components, got {len(u)}")
        tab = ctx.tabs[0]
        lam, mu = self.params.lam, self.params.mu
        g = [self.gradient_at_qp(tab, u[c]) for c in range(dim)]  # (E, nqp, d)
        div = sum(g[c][..., c] for c in range(dim))
        eye = torch.eye(dim, dtype=div.dtype, device=div.device)
        r = []
        for c in range(dim):
            # w_j = mu (du_c/dx_j + du_j/dx_c) + lam div(u) delta_jc
            wvec = mu * (g[c] + torch.stack([g[j][..., c] for j in range(dim)], dim=-1))
            wvec = wvec + (lam * div)[..., None] * eye[c]
            r.append(self.accumulate_gradient(tab, ctx.factor, wvec))
        return tuple(r)

    def lambda_volume(self, ctx: VolumeContext):
        dim = ctx.x.shape[-1]
        tab = ctx.tabs[0]
        f = torch.broadcast_to(torch.as_tensor(self.params.f(ctx.x), dtype=ctx.factor.dtype,
                                               device=ctx.x.device), ctx.x.shape)
        return tuple(self.accumulate_value(tab, ctx.factor, -f[..., c])
                     for c in range(dim))

    def lambda_boundary(self, ctx: FaceContext):
        dim = ctx.x.shape[-1]
        tab = ctx.tabs[0]
        nm = torch.broadcast_to(torch.as_tensor(self.params.is_neumann(ctx.x),
                                                device=ctx.x.device), ctx.x.shape[:-1])
        t = torch.broadcast_to(torch.as_tensor(self.params.traction(ctx.x),
                                               dtype=ctx.factor.dtype,
                                               device=ctx.x.device), ctx.x.shape)
        return tuple(self.accumulate_value(tab, ctx.factor, torch.where(nm, -t[..., c], 0.0))
                     for c in range(dim))
