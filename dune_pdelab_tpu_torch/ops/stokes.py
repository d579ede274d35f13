"""Taylor-Hood (Navier-)Stokes operator on composite spaces.

PyTorch port of dune_pdelab_tpu/ops/stokes.py (reference:
dune/pdelab/localoperator/taylorhoodnavierstokes.hh:52 and the parameter
class stokesparameter.hh). Space layout: Composite(Power(Q_{k+1}, dim),
Q_k), velocity component leaves first, pressure last.

Weak form (residual convention r(u) = 0):
  sum_c ∫ mu ∇v_c·∇φ_c - p ∂φ_c/∂x_c + rho (v·∇)v_c φ_c - f_c φ_c dx
  - ∫ q ∇·v dx
with strongly imposed velocity Dirichlet values; do-nothing boundaries get
no boundary term.

Parameter callbacks (`f`, `g`, `j`, `bctype`, a callable `mu`) receive
batched physical points (..., dim) as a torch tensor and return a tensor
or a scalar that broadcasts; `velocity_bctype` hands `constraints` the
same tensor form of its numpy points. A problem's `time` is a float.
"""
from __future__ import annotations

import copy

import numpy as np
import torch

from dune_pdelab_tpu_torch.ops.base import LocalOperator, VolumeContext


class StokesBC:
    """Boundary-condition codes (reference: stokesparameter.hh:32
    StokesBoundaryCondition, same values)."""
    DO_NOTHING = 0
    VELOCITY_DIRICHLET = 1
    STRESS_NEUMANN = 2
    SLIP_VELOCITY = 3


def _field(v, like, shape):
    """A callback's value as a tensor of like's dtype and device, broadcast
    to `shape`."""
    return torch.broadcast_to(torch.as_tensor(v, dtype=like.dtype, device=like.device),
                              shape)


class NavierStokesParameters:
    """Coefficient functions (stokesparameter.hh analog). `mu` may be a
    constant or a callable mu(x) over batched physical points."""

    time = 0.0

    def __init__(self, mu=1.0, rho=0.0):
        self.mu = mu
        self.rho = rho

    def f(self, x):
        """Body force (..., dim)."""
        return torch.zeros_like(x)

    def g(self, x):
        """Dirichlet velocity (..., dim)."""
        return torch.zeros_like(x)

    def bctype(self, x):
        """StokesBC code at boundary points."""
        return StokesBC.VELOCITY_DIRICHLET

    def j(self, x, normal):
        """Stress flux on STRESS_NEUMANN faces (..., dim), accumulated as
        +j.phi (reference: taylorhoodnavierstokes.hh:300-364)."""
        return torch.zeros_like(x)

    def with_time(self, t):
        p = copy.copy(self)
        p.time = t
        return p

    def velocity_bctype(self):
        """Predicate for `constraints()`: True where velocity Dirichlet."""

        def bc(x):
            v = self.bctype(torch.as_tensor(x, dtype=torch.float64))
            v = v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
            return np.broadcast_to(v == StokesBC.VELOCITY_DIRICHLET, x.shape[:-1])
        return bc

    def mu_at(self, x, dtype):
        """(scalar-or-(...,) viscosity, gradient-axis-broadcast view)."""
        m = self.mu
        if callable(m):
            mu = torch.broadcast_to(torch.as_tensor(m(x), dtype=dtype, device=x.device),
                                    x.shape[:-1])
            return mu, mu[..., None]
        return m, m


class TaylorHoodNavierStokes(LocalOperator):
    """Velocity-pressure kernel; u = (v_0, ..., v_{d-1}, p) leaf tuple.

    tensor_form=True uses the full (symmetric-gradient) stress
    mu (grad v + grad v^T) : grad phi instead of mu grad v : grad phi (the
    reference's `full_tensor` switch, taylorhoodnavierstokes.hh:52)."""

    quadrature_factor = 2
    quadrature_add = 1

    def __init__(self, params: NavierStokesParameters,
                 navier: bool | None = None, tensor_form: bool = False):
        self.params = params
        self.navier = navier if navier is not None else (params.rho != 0.0)
        self.is_linear = not self.navier
        self.tensor_form = tensor_form

    def set_time(self, t):
        new = copy.copy(self)
        new.params = self.params.with_time(t)
        return new

    def alpha_volume(self, ctx: VolumeContext, u):
        dim = ctx.x.shape[-1]
        if len(u) != dim + 1:
            raise ValueError("expected velocity components + pressure")
        tab_v = ctx.tabs[0]
        tab_p = ctx.tabs[dim]
        rho = self.params.rho
        _, muv = self.params.mu_at(ctx.x, ctx.factor.dtype)

        vq = [self.value_at_qp(tab_v, u[c]) for c in range(dim)]        # (E,nqp)
        gv = [self.gradient_at_qp(tab_v, u[c]) for c in range(dim)]     # (E,nqp,d)
        pq = self.value_at_qp(tab_p, u[dim])
        unit = torch.eye(dim, dtype=pq.dtype, device=pq.device)

        r = []
        for c in range(dim):
            wvec = muv * gv[c]
            if self.tensor_form:
                # + mu (grad v)^T : row c is mu * d(v_d)/dx_c per column d
                wvec = wvec + muv * torch.stack([gv[d][..., c] for d in range(dim)], dim=-1)
            wvec = wvec - pq[..., None] * unit[c]          # -p * d(phi_c)/dx_c
            rc = self.accumulate_gradient(tab_v, ctx.factor, wvec)
            if self.navier:
                conv = sum(vq[d] * gv[c][..., d] for d in range(dim))
                rc = rc + self.accumulate_value(tab_v, ctx.factor, rho * conv)
            r.append(rc)
        div = sum(gv[c][..., c] for c in range(dim))
        r.append(self.accumulate_value(tab_p, ctx.factor, -div))
        return tuple(r)

    def lambda_volume(self, ctx: VolumeContext):
        dim = ctx.x.shape[-1]
        tab_v = ctx.tabs[0]
        fval = _field(self.params.f(ctx.x), ctx.factor, ctx.x.shape)
        r = [self.accumulate_value(tab_v, ctx.factor, -fval[..., c]) for c in range(dim)]
        r.append(torch.zeros((ctx.x.shape[0], ctx.tabs[dim].phi.shape[1]),
                             dtype=ctx.factor.dtype, device=ctx.factor.device))
        return tuple(r)

    def lambda_boundary(self, ctx):
        """STRESS_NEUMANN faces accumulate +j.phi on the velocity leaves
        (reference: taylorhoodnavierstokes.hh:300-364); VELOCITY_DIRICHLET
        and DO_NOTHING faces contribute nothing."""
        dim = ctx.x.shape[-1]
        tab_v = ctx.tabs[0]
        bct = torch.broadcast_to(torch.as_tensor(self.params.bctype(ctx.x),
                                                 device=ctx.x.device), ctx.x.shape[:-1])
        n = _field(ctx.normal, ctx.factor, ctx.x.shape)
        jv = _field(self.params.j(ctx.x, n), ctx.factor, ctx.x.shape)
        sel = bct == StokesBC.STRESS_NEUMANN
        r = [self.accumulate_value(tab_v, ctx.factor, torch.where(sel, jv[..., c], 0.0))
             for c in range(dim)]
        r.append(torch.zeros((ctx.x.shape[0], ctx.tabs[dim].phi.shape[1]),
                             dtype=ctx.factor.dtype, device=ctx.factor.device))
        return tuple(r)


class NavierStokesMass(LocalOperator):
    """Temporal operator rho * ∫ v·φ for instationary NSE (reference:
    dune/pdelab/localoperator/navierstokesmass.hh): mass on the velocity
    leaves only, zero on the pressure leaf."""

    is_linear = True

    def __init__(self, rho=1.0):
        self.rho = rho

    def alpha_volume(self, ctx: VolumeContext, u):
        dim = ctx.x.shape[-1]
        tab_v = ctx.tabs[0]
        r = [self.accumulate_value(tab_v, ctx.factor,
                                   self.rho * self.value_at_qp(tab_v, u[c]))
             for c in range(dim)]
        r.append(torch.zeros_like(u[dim]))
        return tuple(r)
