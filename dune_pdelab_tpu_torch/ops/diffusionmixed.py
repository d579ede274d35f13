"""Mixed (dual) formulation of diffusion: Darcy velocity and pressure.

PyTorch port of dune_pdelab_tpu/ops/diffusionmixed.py (reference:
dune/pdelab/localoperator/diffusionmixed.hh; Darcy variants darcyccfv.hh,
darcyfem.hh). The first-order system for -div(K grad p) = f,

    K^-1 u + grad p = 0,     div u = f,

on Composite(H(div) space, P0/DG space), leaves (u, p). Weak form:

  r_u(v) = int (K^-1 u).v - p div v dx + oint_GammaD g v.n ds
  r_p(q) = -int (div u) q dx + int f q dx

(signs chosen so that A = [[M, -B^T], [-B, 0]] is symmetric: MINRES).
Dirichlet data for p enters naturally through the boundary term; flux
(Neumann) conditions would constrain the normal DOFs of u and are not
wired, as in the reference.
"""
from __future__ import annotations

import copy

import torch

from dune_pdelab_tpu_torch.ops.base import FaceContext, LocalOperator, VolumeContext
from dune_pdelab_tpu_torch.ops.convectiondiffusion import (
    ConvectionDiffusionProblem, at_face_qp,
)


class DiffusionMixed(LocalOperator):
    is_linear = True
    quadrature_factor = 2

    def __init__(self, problem: ConvectionDiffusionProblem):
        self.problem = problem

    def set_time(self, t):
        new = copy.copy(self)
        new.problem = self.problem.with_time(t)
        return new

    def alpha_volume(self, ctx: VolumeContext, u):
        uu, pp = u
        tab_u, tab_p = ctx.tabs
        K = self.problem.A(ctx.x)
        uq = self.hdiv_value_at_qp(tab_u, uu)                 # (E, nqp, d)
        if isinstance(K, torch.Tensor) and K.ndim == uq.ndim - 1:
            K = K[..., None]
        pq = self.value_at_qp(tab_p, pp)
        divu = self.div_at_qp(tab_u, uu)
        r_u = (self.accumulate_hdiv(tab_u, ctx.factor, uq / K)
               - self.accumulate_div(tab_u, ctx.factor, pq))
        r_p = -self.accumulate_value(tab_p, ctx.factor, divu)
        return r_u, r_p

    def lambda_volume(self, ctx: VolumeContext):
        tab_u, tab_p = ctx.tabs
        f = at_face_qp(self.problem.f(ctx.x), ctx, ctx.factor.dtype)
        r_p = self.accumulate_value(tab_p, ctx.factor, f)
        r_u = ctx.factor.new_zeros((ctx.x.shape[0], tab_u.vec_phi.shape[-2]))
        return r_u, r_p

    def lambda_boundary(self, ctx: FaceContext):
        tab_u, tab_p = ctx.tabs
        g = at_face_qp(self.problem.g(ctx.x), ctx, ctx.factor.dtype)
        vp, n = tab_u.vec_phi, ctx.normal
        if vp.ndim == 4 or n.ndim > 1:                 # per-face Piola or normals
            vp = vp if vp.ndim == 4 else vp[None]
            n = n if n.ndim > 1 else n[None, None]
            vn = (vp * n[:, :, None, :]).sum(-1)       # (F, nqp, nb)
            r_u = torch.einsum("fqb,fq->fb", vn, g * ctx.factor)
        else:
            vn = torch.einsum("qbd,d->qb", vp, n)
            r_u = torch.einsum("qb,eq->eb", vn, g * ctx.factor)
        r_p = ctx.factor.new_zeros((ctx.x.shape[0], tab_p.phi.shape[-1]))
        return r_u, r_p
