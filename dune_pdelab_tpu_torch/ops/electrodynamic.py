"""Curl-curl operator on H(curl) edge-element spaces.

PyTorch port of dune_pdelab_tpu/ops/electrodynamic.py (reference:
dune/pdelab/localoperator/electrodynamic.hh, the curl-curl form used with
Nedelec elements): the E-field / eddy-current bilinear form

    a(u, v) = int nu (curl u).(curl v) + beta u.v dx,   rhs int f.v dx,

with essential n x u constraints on the boundary edges
(FunctionSpace.boundary_edge_mask).
"""
from __future__ import annotations

import copy

import torch

from dune_pdelab_tpu_torch.ops.base import LocalOperator, VolumeContext


class CurlCurlParameters:
    time = 0.0

    def __init__(self, nu=1.0, beta=1.0):
        self.nu = nu
        self.beta = beta

    def f(self, x):
        """Vector source (..., dim)."""
        return torch.zeros_like(x)

    def with_time(self, t):
        p = copy.copy(self)
        p.time = t
        return p


class CurlCurl(LocalOperator):
    is_linear = True
    quadrature_factor = 2

    def __init__(self, params: CurlCurlParameters):
        self.params = params

    def set_time(self, t):
        new = copy.copy(self)
        new.params = self.params.with_time(t)
        return new

    def alpha_volume(self, ctx: VolumeContext, u):
        tab, p = ctx.tab, self.params
        r = self.accumulate_curl(tab, ctx.factor, p.nu * self.curl_at_qp(tab, u))
        if p.beta != 0.0:
            # the mass term: the same vec_phi contraction as H(div)
            r = r + self.accumulate_hdiv(tab, ctx.factor,
                                         p.beta * self.hdiv_value_at_qp(tab, u))
        return r

    def lambda_volume(self, ctx: VolumeContext):
        f = torch.broadcast_to(torch.as_tensor(self.params.f(ctx.x), dtype=ctx.factor.dtype,
                                               device=ctx.factor.device), ctx.x.shape)
        return -self.accumulate_hdiv(ctx.tab, ctx.factor, f)
