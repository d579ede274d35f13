"""Linear acoustics DG operator (first-order wave system, upwind fluxes,
heterogeneous sound speed).

PyTorch port of dune_pdelab_tpu/ops/acoustics.py (reference:
dune/pdelab/localoperator/linearacousticsdg.hh:316, an eigendecomposed
upwind numerical flux with a per-cell sound speed, used with explicit RK
time stepping). System (sound speed c(x), sampled per cell like the
reference's `param.c(cell, localcenter)`):

    p_t + c div u = 0,    u_t + c grad p = 0

on a PowerSpace(DG, 1 + dim) with leaf order (p, u_1, ..., u_d). In these
symmetrized variables the characteristic impedance is 1 on every cell, so
the reference's flux-vector splitting F = A+(c_in) q_in + A-(c_out) q_out
(linearacousticsdg.hh:317-338) reads

    f_p   = (c_i/2) (p_i + un_i) - (c_o/2) (p_o - un_o)
    f_u,d = n_d [ (c_i/2)(p_i + un_i) + (c_o/2)(p_o - un_o) ]

Boundary conditions: 'reflect' (rigid wall: mirror the normal velocity) or
'absorb' (first-order outflow: zero exterior state). A composite space, so
the explicit stages' residuals run on the general assembly path.
"""
from __future__ import annotations

import torch

from dune_pdelab_tpu_torch.ops.base import (
    FaceContext, LocalOperator, SkeletonContext, VolumeContext,
)


class LinearAcousticsDG(LocalOperator):
    quadrature_factor = 2

    is_linear = True

    def __init__(self, c=1.0, bc: str = "reflect", cmax=None):
        self.c = c
        self.bc = bc
        self.cmax = cmax

    def max_speed(self, x=None):
        """For CFLTimeController (explicitonestep.hh:64 analog); pass
        `cmax` when c is a callable."""
        if self.cmax is not None:
            return self.cmax
        return self.c if not callable(self.c) else 1.0

    def _c_at(self, x):
        """Sound speed at points x (..., dim) -> (...)."""
        if callable(self.c):
            return torch.as_tensor(self.c(x), dtype=x.dtype, device=x.device)
        return torch.full(x.shape[:-1], self.c, dtype=x.dtype, device=x.device)

    # -- volume: -int sum_d (A_d q) . dv/dx_d -------------------------------
    def alpha_volume(self, ctx: VolumeContext, q):
        dim = ctx.x.shape[-1]
        tab = ctx.tabs[0]
        cv = self._c_at(ctx.x.mean(1))[:, None]               # (E, 1) per cell
        pq = self.value_at_qp(tab, q[0])                      # (E, nqp)
        uq = [self.value_at_qp(tab, q[1 + d]) for d in range(dim)]
        # p-equation flux: c*u ; u_c-equation flux: c*p e_c
        r = [-self.accumulate_gradient(
            tab, ctx.factor, torch.stack([cv * u for u in uq], dim=-1))]
        cp = (cv * pq)[..., None]
        eye = torch.eye(dim, dtype=pq.dtype, device=pq.device)
        for d in range(dim):
            r.append(-self.accumulate_gradient(tab, ctx.factor, cp * eye[d]))
        return tuple(r)

    # -- upwind flux (per-side speeds, flux-vector splitting) ---------------
    @staticmethod
    def _flux(n, p_i, u_i, p_o, u_o, c_i, c_o):
        un_i = sum(u_i[d] * n[d] for d in range(len(u_i)))
        un_o = sum(u_o[d] * n[d] for d in range(len(u_o)))
        wp = 0.5 * c_i * (p_i + un_i)        # outgoing (+c) wave, inside c
        wm = 0.5 * c_o * (p_o - un_o)        # incoming (-c) wave, outside c
        f_p = wp - wm
        f_u = [(wp + wm) * n[d] for d in range(len(u_i))]
        return f_p, f_u

    @staticmethod
    def _acc(tab, factor, w):
        return torch.einsum("qb,eq->eb", tab.phi, w * factor)

    def alpha_skeleton(self, ctx: SkeletonContext, q_in, q_out):
        dim = ctx.x.shape[-1]
        tin, tout = ctx.tab_in, ctx.tab_out
        n = ctx.normal
        p_i = self.value_at_qp(tin, q_in[0])
        p_o = self.value_at_qp(tout, q_out[0])
        u_i = [self.value_at_qp(tin, q_in[1 + d]) for d in range(dim)]
        u_o = [self.value_at_qp(tout, q_out[1 + d]) for d in range(dim)]
        c_i, c_o = self._side_speeds(ctx, skeleton=True)
        f_p, f_u = self._flux(n, p_i, u_i, p_o, u_o, c_i, c_o)
        r_in = [self._acc(tin, ctx.factor, f) for f in [f_p] + f_u]
        r_out = [self._acc(tout, ctx.factor, -f) for f in [f_p] + f_u]
        return tuple(r_in), tuple(r_out)

    def _side_speeds(self, ctx, skeleton):
        """Per-side cell speeds: face centers offset half a cell along the
        normal (cell-wise material sampling)."""
        if not callable(self.c):
            c = torch.as_tensor(self.c, dtype=ctx.x.dtype, device=ctx.x.device)
            return c, c
        xf = ctx.x.mean(1)
        n = torch.as_tensor(ctx.normal, dtype=xf.dtype, device=xf.device)
        nv = n[:, 0, :] if n.ndim == 3 else torch.broadcast_to(n, xf.shape)
        hi = torch.as_tensor(ctx.h_inside, dtype=xf.dtype, device=xf.device).reshape(-1)
        c_i = self._c_at(xf - 0.5 * hi[:, None] * nv)[:, None]
        if skeleton:
            ho = torch.as_tensor(ctx.h_outside, dtype=xf.dtype,
                                 device=xf.device).reshape(-1)
            c_o = self._c_at(xf + 0.5 * ho[:, None] * nv)[:, None]
        else:
            c_o = c_i
        return c_i, c_o

    def alpha_boundary(self, ctx: FaceContext, q):
        dim = ctx.x.shape[-1]
        tab = ctx.tab
        n = ctx.normal
        p_i = self.value_at_qp(tab, q[0])
        u_i = [self.value_at_qp(tab, q[1 + d]) for d in range(dim)]
        if self.bc == "reflect":
            p_o = p_i
            un = sum(u_i[d] * n[d] for d in range(dim))
            u_o = [u_i[d] - 2.0 * un * n[d] for d in range(dim)]
        elif self.bc == "absorb":
            p_o = torch.zeros_like(p_i)
            u_o = [torch.zeros_like(u) for u in u_i]
        else:
            raise ValueError(self.bc)
        c_i, _ = self._side_speeds(ctx, skeleton=False)
        f_p, f_u = self._flux(n, p_i, u_i, p_o, u_o, c_i, c_i)
        return tuple(self._acc(tab, ctx.factor, f) for f in [f_p] + f_u)
