"""Interior-penalty DG discretization of (Navier-)Stokes.

PyTorch port of dune_pdelab_tpu/ops/dgnavierstokes.py (reference:
dune/pdelab/localoperator/dgnavierstokes.hh:32 and
dginteriorpenaltyparameter.hh): equal-order or mixed DG velocity/pressure
on PowerSpace(DG^dim) x DG with

  * componentwise SIPG/NIPG viscous terms (penalty sigma mu k(k+1)/h),
  * pressure-velocity coupling fluxes  +∫ {p} n·[v],  -∫ {q} n·[u]
    (symmetric saddle-point convention),
  * Dirichlet velocity via Nitsche terms with data g,
  * optional convection with upwinding on the face-mean velocity.

Space layout: (v_0, ..., v_{d-1}, p) leaf tuple like the Taylor-Hood
kernel. The skeleton and boundary kernels run on the GridOperator's face
groups of the composite DG leaves (slab transfers: each leaf is a
contiguous element-major block).
"""
from __future__ import annotations

import copy

import torch

from dune_pdelab_tpu_torch.ops.base import (
    FaceContext, LocalOperator, SkeletonContext, VolumeContext,
)
from dune_pdelab_tpu_torch.ops.stokes import NavierStokesParameters, StokesBC, _field


def _on_phi(tab, w, factor):
    """sum_q phi_b(q) * w(F, q) * factor -> (F, nb)."""
    return torch.einsum("qb,eq->eb", tab.phi, w * factor)


class DGNavierStokes(LocalOperator):
    quadrature_factor = 2
    quadrature_add = 1

    def __init__(self, params: NavierStokesParameters, penalty: float = 4.0,
                 theta: float = 1.0, navier: bool | None = None,
                 tensor_form: bool = False, incomp_scaling: float = 1.0):
        self.params = params
        self.penalty = penalty
        self.theta = theta
        self.navier = navier if navier is not None else (params.rho != 0.0)
        self.is_linear = not self.navier
        # full stress sigma = mu (grad u + grad u^T) instead of mu grad u
        # (the reference's full_tensor switch, dgnavierstokes.hh)
        self.tensor_form = tensor_form
        # rescaled continuity rows (dgnavierstokesparameter.hh:108
        # incompressibilityScaling)
        self.incomp_scaling = incomp_scaling

    def set_time(self, t):
        new = copy.copy(self)
        new.params = self.params.with_time(t)
        return new

    # -- volume (same terms as Taylor-Hood) ----------------------------------
    def alpha_volume(self, ctx: VolumeContext, u):
        dim = ctx.x.shape[-1]
        tab_v, tab_p = ctx.tabs[0], ctx.tabs[dim]
        mu, rho = self.params.mu, self.params.rho
        vq = [self.value_at_qp(tab_v, u[c]) for c in range(dim)]
        gv = [self.gradient_at_qp(tab_v, u[c]) for c in range(dim)]
        pq = self.value_at_qp(tab_p, u[dim])
        unit = torch.eye(dim, dtype=pq.dtype, device=pq.device)
        r = []
        for c in range(dim):
            wvec = mu * gv[c]
            if self.tensor_form:
                wvec = wvec + mu * torch.stack([gv[d][..., c] for d in range(dim)], dim=-1)
            wvec = wvec - pq[..., None] * unit[c]
            rc = self.accumulate_gradient(tab_v, ctx.factor, wvec)
            if self.navier:
                conv = sum(vq[d] * gv[c][..., d] for d in range(dim))
                rc = rc + self.accumulate_value(tab_v, ctx.factor, rho * conv)
            r.append(rc)
        div = sum(gv[c][..., c] for c in range(dim))
        r.append(-self.incomp_scaling * self.accumulate_value(tab_p, ctx.factor, div))
        return tuple(r)

    def lambda_volume(self, ctx: VolumeContext):
        dim = ctx.x.shape[-1]
        tab_v, tab_p = ctx.tabs[0], ctx.tabs[dim]
        f = _field(self.params.f(ctx.x), ctx.factor, ctx.x.shape)
        r = [self.accumulate_value(tab_v, ctx.factor, -f[..., c]) for c in range(dim)]
        r.append(torch.zeros((ctx.x.shape[0], tab_p.phi.shape[1]),
                             dtype=ctx.factor.dtype, device=ctx.factor.device))
        return tuple(r)

    def _gamma(self, tab_v, h, dim):
        k = max(1, tab_v.degree)
        return self.penalty * self.params.mu * k * (k + dim - 1.0) / h

    # -- interior faces ------------------------------------------------------
    def alpha_skeleton(self, ctx: SkeletonContext, u_in, u_out):
        dim = ctx.x.shape[-1]
        tin_v, tin_p = ctx.tabs_in[0], ctx.tabs_in[dim]
        tout_v, tout_p = ctx.tabs_out[0], ctx.tabs_out[dim]
        n = ctx.normal
        mu, rho = self.params.mu, self.params.rho
        h = ctx.h_inside[:, None]
        gamma = self._gamma(tin_v, h, dim)
        ndphi_i = torch.einsum("qbd,d->qb", tin_v.grad[0], n)
        ndphi_o = torch.einsum("qbd,d->qb", tout_v.grad[0], n)

        vi = [self.value_at_qp(tin_v, u_in[c]) for c in range(dim)]
        vo = [self.value_at_qp(tout_v, u_out[c]) for c in range(dim)]
        gi = [self.gradient_at_qp(tin_v, u_in[c]) for c in range(dim)]
        go_ = [self.gradient_at_qp(tout_v, u_out[c]) for c in range(dim)]
        pi = self.value_at_qp(tin_p, u_in[dim])
        po = self.value_at_qp(tout_p, u_out[dim])
        pavg = 0.5 * (pi + po)
        un_jump = sum((vi[c] - vo[c]) * n[c] for c in range(dim))
        r_in, r_out = [], []
        if self.navier:
            # upwind convection by the mean normal velocity
            ubar_n = 0.5 * sum((vi[c] + vo[c]) * n[c] for c in range(dim))
        jumps = [vi[c] - vo[c] for c in range(dim)]
        for c in range(dim):
            jump = jumps[c]
            avg_ngrad = 0.5 * (torch.einsum("fqd,d->fq", gi[c], n)
                               + torch.einsum("fqd,d->fq", go_[c], n))
            if self.tensor_form:
                # + {(grad u)^T n}_c = 0.5 sum_d n_d (d_c u_d)|_i,o
                avg_ngrad = avg_ngrad + 0.5 * sum(
                    n[d] * (gi[d][..., c] + go_[d][..., c]) for d in range(dim))
            w = -mu * avg_ngrad + gamma * jump + pavg * n[c]
            if self.navier:
                upw = torch.where(ubar_n >= 0, vi[c], vo[c])
                w = w + rho * ubar_n * upw
            ri = _on_phi(tin_v, w, ctx.factor)
            ro = _on_phi(tout_v, -w, ctx.factor)
            if self.tensor_form:
                # adjoint term -theta [u].{sigma(phi) n}: gradient-axis
                # weight W_c[..., e] = -theta mu 0.5 (n_e [u_c] + n_c [u_e])
                W = torch.stack([-self.theta * mu * 0.5 * (n[e] * jump + n[c] * jumps[e])
                                 for e in range(dim)], dim=-1)
                ri = ri + self.accumulate_gradient(tin_v, ctx.factor, W)
                ro = ro + self.accumulate_gradient(tout_v, ctx.factor, W)
            else:
                # symmetry term -theta mu {grad v}.n [u]
                wsym = -self.theta * mu * 0.5 * jump * ctx.factor
                ri = ri + torch.einsum("qb,eq->eb", ndphi_i, wsym)
                ro = ro + torch.einsum("qb,eq->eb", ndphi_o, wsym)
            r_in.append(ri)
            r_out.append(ro)
        # continuity coupling: b(u, q) face part +∫ {q} [u·n]
        wq = self.incomp_scaling * 0.5 * un_jump
        r_in.append(_on_phi(tin_p, wq, ctx.factor))
        r_out.append(_on_phi(tout_p, wq, ctx.factor))
        return tuple(r_in), tuple(r_out)

    # -- boundary: Nitsche-Dirichlet terms on VELOCITY_DIRICHLET faces only
    # (reference: dgnavierstokes.hh:879,1039; StressNeumann faces get no
    # solution-dependent boundary term)
    def _bctype(self, ctx):
        return torch.broadcast_to(torch.as_tensor(self.params.bctype(ctx.x),
                                                  device=ctx.x.device), ctx.x.shape[:-1])

    def alpha_boundary(self, ctx: FaceContext, u):
        dim = ctx.x.shape[-1]
        tab_v, tab_p = ctx.tabs[0], ctx.tabs[dim]
        n = ctx.normal
        mu, rho = self.params.mu, self.params.rho
        h = ctx.h_inside[:, None]
        gamma = self._gamma(tab_v, h, dim)
        ndphi = torch.einsum("qbd,d->qb", tab_v.grad[0], n)
        bct = self._bctype(ctx)
        sel = bct == StokesBC.VELOCITY_DIRICHLET
        slp = bct == StokesBC.SLIP_VELOCITY
        selp = sel | slp   # pressure coupling: Dirichlet AND slip faces
        vi = [self.value_at_qp(tab_v, u[c]) for c in range(dim)]
        gi = [self.gradient_at_qp(tab_v, u[c]) for c in range(dim)]
        pq = self.value_at_qp(tab_p, u[dim])
        un = sum(vi[c] * n[c] for c in range(dim))
        # slip (free tangential, weak u.n = 0; reference:
        # dgnavierstokes.hh:923-949): Nitsche on the normal trace only
        ten = 2.0 if self.tensor_form else 1.0
        ngrad_n = sum(n[c] * torch.einsum("fqd,d->fq", gi[c], n) for c in range(dim))
        w_slip = torch.where(slp, -ten * mu * ngrad_n + gamma * un, 0.0)
        w_slip_adj = torch.where(slp, -self.theta * ten * mu * un, 0.0)
        r = []
        for c in range(dim):
            ngrad = torch.einsum("fqd,d->fq", gi[c], n)
            if self.tensor_form:
                ngrad = ngrad + sum(n[d] * gi[d][..., c] for d in range(dim))
            w = -mu * ngrad + gamma * vi[c]
            if self.navier:
                w = w + rho * torch.where(un >= 0, un * vi[c], 0.0)
            w = (torch.where(sel, w, 0.0) + torch.where(selp, pq, 0.0) * n[c]
                 + w_slip * n[c])
            rc = _on_phi(tab_v, w, ctx.factor)
            if self.tensor_form:
                W = torch.stack([-self.theta * mu * (n[e] * vi[c] + n[c] * vi[e])
                                 for e in range(dim)], dim=-1)
                rc = rc + self.accumulate_gradient(tab_v, ctx.factor, W * sel[..., None])
                rc = rc + torch.einsum("qb,eq->eb", ndphi, w_slip_adj * n[c] * ctx.factor)
            else:
                rc = rc + torch.einsum(
                    "qb,eq->eb", ndphi,
                    (torch.where(sel, -self.theta * mu * vi[c], 0.0)
                     + w_slip_adj * n[c]) * ctx.factor)
            r.append(rc)
        r.append(_on_phi(tab_p, self.incomp_scaling * torch.where(selp, un, 0.0),
                         ctx.factor))
        return tuple(r)

    def lambda_boundary(self, ctx: FaceContext):
        dim = ctx.x.shape[-1]
        tab_v, tab_p = ctx.tabs[0], ctx.tabs[dim]
        n = ctx.normal
        mu, rho = self.params.mu, self.params.rho
        h = ctx.h_inside[:, None]
        gamma = self._gamma(tab_v, h, dim)
        ndphi = torch.einsum("qbd,d->qb", tab_v.grad[0], n)
        bct = self._bctype(ctx)
        sel = bct == StokesBC.VELOCITY_DIRICHLET
        neu = bct == StokesBC.STRESS_NEUMANN
        slp = bct == StokesBC.SLIP_VELOCITY
        selp = sel | slp
        g = _field(self.params.g(ctx.x), ctx.factor, ctx.x.shape)
        nb = _field(n, ctx.factor, ctx.x.shape)
        jv = _field(self.params.j(ctx.x, nb), ctx.factor, ctx.x.shape)
        gn = sum(g[..., c] * n[c] for c in range(dim))
        ten = 2.0 if self.tensor_form else 1.0
        w_slip = torch.where(slp, -gamma * gn, 0.0)
        w_slip_adj = torch.where(slp, self.theta * ten * mu * gn, 0.0)
        r = []
        for c in range(dim):
            w = -gamma * g[..., c]
            if self.navier:
                w = w + rho * torch.where(gn < 0, gn * g[..., c], 0.0)   # inflow data
            # prescribed stress on STRESS_NEUMANN faces: +j.phi
            # (reference: dgnavierstokes.hh:1346-1360)
            w = (torch.where(sel, w, 0.0) + torch.where(neu, jv[..., c], 0.0)
                 + w_slip * n[c])
            rc = _on_phi(tab_v, w, ctx.factor)
            if self.tensor_form:
                W = torch.stack([self.theta * mu * (n[e] * g[..., c] + n[c] * g[..., e])
                                 for e in range(dim)], dim=-1)
                rc = rc + self.accumulate_gradient(tab_v, ctx.factor, W * sel[..., None])
                rc = rc + torch.einsum("qb,eq->eb", ndphi, w_slip_adj * n[c] * ctx.factor)
            else:
                rc = rc + torch.einsum(
                    "qb,eq->eb", ndphi,
                    (torch.where(sel, self.theta * mu * g[..., c], 0.0)
                     + w_slip_adj * n[c]) * ctx.factor)
            r.append(rc)
        r.append(_on_phi(tab_p, self.incomp_scaling * torch.where(selp, -gn, 0.0),
                         ctx.factor))
        return tuple(r)
