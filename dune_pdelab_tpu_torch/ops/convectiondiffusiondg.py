"""Discontinuous Galerkin convection-diffusion: SIPG / NIPG / IIPG.

PyTorch port of dune_pdelab_tpu/ops/convectiondiffusiondg.py (reference:
dune/pdelab/localoperator/convectiondiffusiondg.hh:55 — scheme/weight enums
:31-36, harmonic-average weighting :319-331, alpha_skeleton :271,
alpha_boundary with Nitsche-type Dirichlet). Shares the parameter protocol
(A, b, c, f, bctype, g, j, o) with the CG kernel; callbacks take and return
torch tensors.

Weak form (interior face F, normal n from inside to outside,
jump [w] = w_in - w_out, weighted average {w} = w_in*om_in + w_out*om_out):

  - ∫_F {A∇u}·n [v]  - theta ∫_F {A∇v}·n [u]  + ∫_F gamma [u][v]
  + ∫_F (b·n) u_upwind [v]

theta = +1 SIPG (symmetric), -1 NIPG, 0 IIPG. Dirichlet boundary faces get
the Nitsche analog with u_out := g; Neumann faces ∫ j v; outflow
∫ ((b·n) u + o) v. Penalty gamma = alpha * k (k + d - 1) * delta / h_F with
delta the (harmonically averaged when weights on) normal diffusivity.
"""
from __future__ import annotations

import copy

import torch

from dune_pdelab_tpu_torch.ops.base import (
    FaceContext, LeafTab, LocalOperator, SkeletonContext, VolumeContext,
)
from dune_pdelab_tpu_torch.ops.convectiondiffusion import (
    BCType, ConvectionDiffusionProblem, _is_zero, apply_tensor, at_face_qp,
)


class DGMethod:
    SIPG = 1.0
    NIPG = -1.0
    IIPG = 0.0


def _dotn(X, normal):
    """X (..., d) · normal, the normal (d,) shared by a structured group or
    (F, 1|nqp, d) per face (simplex and mapped meshes)."""
    if normal.ndim == 1:
        return torch.einsum("...d,d->...", X, normal)
    return (X * normal).sum(-1)


def _A_normal_grad(tab: LeafTab, A, normal, x_shape):
    """(A grad phi_b)·n exactly for scalar/field/tensor A: (F, nqp, nb)
    (reference: convectiondiffusiondg.hh:319-331). A constant scalar A
    with a shared normal gives one (1, nqp, nb) array instead of a
    per-face one."""
    if isinstance(A, (int, float)) or (isinstance(A, torch.Tensor) and A.ndim == 0):
        n = normal if normal.ndim == 1 else normal[:, :, None, :]
        return (tab.grad * (A * n)).sum(-1)
    An = apply_tensor(A, torch.broadcast_to(normal, x_shape))   # A symmetric
    return (tab.grad * An[:, :, None, :]).sum(-1)


def _accumulate(tab: LeafTab, w):
    """sum_q w(E, nqp) * phi_i(q) -> (E, nloc)."""
    return torch.einsum("qb,eq->eb", tab.phi, w)


def _accumulate_nderiv(ndphi, w):
    """sum_q w(E, nqp) * dn_phi_i(Eb, nqp, nb) -> (E, nloc)."""
    if ndphi.shape[0] == 1:
        return torch.einsum("qb,eq->eb", ndphi[0], w)
    return torch.einsum("eqb,eq->eb", ndphi, w)


def _velocity(p, ctx):
    """b at the quadrature points, broadcast to x's shape."""
    b = torch.as_tensor(p.b(ctx.x), dtype=ctx.x.dtype, device=ctx.x.device)
    return torch.broadcast_to(b, ctx.x.shape)


class ConvectionDiffusionDG(LocalOperator):
    """SIPG/NIPG/IIPG DG kernel over QkDG spaces."""

    is_linear = True

    def __init__(self, problem: ConvectionDiffusionProblem,
                 method: float = DGMethod.SIPG, penalty: float = 2.0,
                 weights: bool = True, quadrature_add: int = 0):
        self.problem = problem
        self.theta = method
        self.penalty = penalty
        self.weights = weights
        self.quadrature_add = quadrature_add

    def set_time(self, t):
        new = copy.copy(self)
        new.problem = self.problem.with_time(t)
        return new

    # -- volume: same terms as the CG kernel --------------------------------
    def alpha_volume(self, ctx: VolumeContext, u):
        p, tab = self.problem, ctx.tab
        uq = self.value_at_qp(tab, u)
        gu = self.gradient_at_qp(tab, u)
        b = torch.as_tensor(p.b(ctx.x), dtype=gu.dtype, device=gu.device)
        flux = apply_tensor(p.A(ctx.x), gu) - uq[..., None] * b
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

    # -- penalty / weighting helpers ----------------------------------------
    @staticmethod
    def _delta(A, normal):
        """Normal diffusivity n·A n at face quadrature points (a Python
        number as it is)."""
        if isinstance(A, (int, float)):
            return A
        A = torch.as_tensor(A, dtype=normal.dtype, device=normal.device)
        if A.ndim >= 2 and A.shape[-1] == A.shape[-2] == normal.shape[-1]:
            if normal.ndim == 1:
                return torch.einsum("...i,i->...", torch.einsum("...ij,j->...i", A, normal),
                                    normal)
            return (torch.einsum("...ij,...j->...i", A, normal) * normal).sum(-1)
        return A  # scalar/isotropic

    def _gamma(self, delta, h, degree, dim):
        return self.penalty * degree * (degree + dim - 1.0) * delta / h

    # -- interior faces ------------------------------------------------------
    def alpha_skeleton(self, ctx: SkeletonContext, u_in, u_out):
        p = self.problem
        tin, tout = ctx.tab_in, ctx.tab_out
        n = ctx.normal
        dim = ctx.x.shape[-1]
        degree = max(1, tin.degree)

        ui = self.value_at_qp(tin, u_in)                  # (F, nqp)
        uo = self.value_at_qp(tout, u_out)
        gui = self.gradient_at_qp(tin, u_in)              # (F, nqp, d)
        guo = self.gradient_at_qp(tout, u_out)
        A = p.A(ctx.x)
        di = self._delta(A, n)                            # n·A n (same both sides
        do = di                                           # for cellwise-smooth A)
        if self.weights:
            om_i = do / (di + do + 1e-300)
            om_o = di / (di + do + 1e-300)
            delta_eff = 2.0 * di * do / (di + do + 1e-300)
        else:
            om_i = om_o = 0.5
            delta_eff = 0.5 * (di + do)
        h = ctx.h_inside[:, None]
        gamma = self._gamma(delta_eff, h, degree, dim)

        jump = ui - uo
        # {A grad u}·n with weights
        nAgu = (om_i * _dotn(apply_tensor(A, gui), n)
                + om_o * _dotn(apply_tensor(A, guo), n))
        # convection: upwind value
        bn = _dotn(_velocity(p, ctx), n)
        upw = torch.where(bn >= 0, ui, uo)

        w_common = (-nAgu + gamma * jump + bn * upw) * ctx.factor
        r_in = _accumulate(tin, w_common)
        r_out = _accumulate(tout, -w_common)
        # symmetrization term: -theta ∫ {A grad v}·n [u] (exact tensor form)
        if self.theta != 0.0:
            ndpi = _A_normal_grad(tin, A, n, ctx.x.shape)   # (Fb, nqp, nb)
            ndpo = _A_normal_grad(tout, A, n, ctx.x.shape)
            wi = -self.theta * om_i * jump * ctx.factor
            wo = -self.theta * om_o * jump * ctx.factor
            r_in = r_in + _accumulate_nderiv(ndpi, wi)
            r_out = r_out + _accumulate_nderiv(ndpo, wo)
        return r_in, r_out

    # -- boundary faces ------------------------------------------------------
    def _boundary_terms(self, ctx: FaceContext):
        """Shared Nitsche machinery: (A, gamma, n)."""
        A = self.problem.A(ctx.x)
        delta = self._delta(A, ctx.normal)
        h = ctx.h_inside[:, None]
        gamma = self._gamma(delta, h, max(1, ctx.tab.degree), ctx.x.shape[-1])
        return A, gamma, ctx.normal

    def alpha_boundary(self, ctx: FaceContext, u):
        p, tab = self.problem, ctx.tab
        bct = at_face_qp(p.bctype(ctx.x), ctx)
        uq = self.value_at_qp(tab, u)
        gu = self.gradient_at_qp(tab, u)
        A, gamma, n = self._boundary_terms(ctx)
        bn = _dotn(_velocity(p, ctx), n)

        is_d = bct == BCType.DIRICHLET
        is_o = bct == BCType.OUTFLOW
        # Dirichlet (Nitsche), u-dependent parts:
        nAgu = _dotn(apply_tensor(A, gu), n)
        w = torch.where(is_d, -nAgu + gamma * uq
                        + torch.where(bn >= 0, bn * uq, 0.0), 0.0)
        # outflow: (b·n) u v
        w = w + torch.where(is_o, bn * uq, 0.0)
        r = _accumulate(tab, w * ctx.factor)
        if self.theta != 0.0:
            ndphi = _A_normal_grad(tab, A, n, ctx.x.shape)
            wsym = torch.where(is_d, -self.theta * uq, 0.0) * ctx.factor
            r = r + _accumulate_nderiv(ndphi, wsym)
        return r

    def lambda_boundary(self, ctx: FaceContext):
        p, tab = self.problem, ctx.tab
        dt = ctx.factor.dtype
        bct = at_face_qp(p.bctype(ctx.x), ctx)
        gq = at_face_qp(p.g(ctx.x), ctx, dt)
        jq = at_face_qp(p.j(ctx.x), ctx, dt)
        oq = at_face_qp(p.o(ctx.x), ctx, dt)
        A, gamma, n = self._boundary_terms(ctx)
        bn = _dotn(_velocity(p, ctx), n)

        is_d = bct == BCType.DIRICHLET
        is_n = bct == BCType.NEUMANN
        is_o = bct == BCType.OUTFLOW
        # Dirichlet data: -gamma g v + inflow (b·n) g v ; Neumann: j v; outflow: o v
        w = (torch.where(is_d, -gamma * gq + torch.where(bn < 0, bn * gq, 0.0), 0.0)
             + torch.where(is_n, jq, 0.0) + torch.where(is_o, oq, 0.0))
        r = _accumulate(tab, w * ctx.factor)
        if self.theta != 0.0:
            ndphi = _A_normal_grad(tab, A, n, ctx.x.shape)
            wsym = torch.where(is_d, self.theta * gq, 0.0) * ctx.factor
            r = r + _accumulate_nderiv(ndphi, wsym)
        return r
