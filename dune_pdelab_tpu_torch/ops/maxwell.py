"""Maxwell DG operator (first-order curl system, upwind fluxes,
heterogeneous materials).

PyTorch port of dune_pdelab_tpu/ops/maxwell.py (reference:
dune/pdelab/localoperator/maxwelldg.hh:316, an eigendecomposed numerical
flux over a 6-component DG system with per-cell eps/mu, used with
explicit RK). Unknowns (E, H) on PowerSpace(DG, 6), leaf order
(E_1, E_2, E_3, H_1, H_2, H_3); per-cell permittivity eps(x) and
permeability mu(x) (callables of position or scalars, sampled at cell
centers like the reference's `param.eps(cell, localcenter)`,
maxwelldg.hh:374-378):

    eps E_t =  curl H,     mu H_t = - curl E

The interface flux is the exact Riemann solution with per-side impedances
Z = sqrt(mu/eps), Y = 1/Z:

    H* = ( Z_i H_i + Z_o H_o + n x [E] ) / (Z_i + Z_o)
    E* = ( Y_i E_i + Y_o E_o - n x [H] ) / (Y_i + Y_o)

with jump [q] = q_in - q_out; each side's residual scales by its own 1/eps
(E rows) and 1/mu (H rows). Boundary: 'pec' (mirror tangential E, copy H)
or 'absorb' (Silver-Mueller via a zero exterior state).
"""
from __future__ import annotations

import torch

from dune_pdelab_tpu_torch.ops.base import (
    FaceContext, LocalOperator, SkeletonContext, VolumeContext,
)


def _cross(a, b):
    """Cross product of 3-lists of (E, nqp) tensors (or length-3 normals)."""
    return [a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0]]


def _eval_mat(fn, x):
    """Material callable/scalar at points x (..., dim) -> (...)."""
    if fn is None:
        return None
    if callable(fn):
        return torch.as_tensor(fn(x), dtype=x.dtype, device=x.device)
    return torch.full(x.shape[:-1], fn, dtype=x.dtype, device=x.device)


class MaxwellDG(LocalOperator):
    quadrature_factor = 2
    is_linear = True

    def __init__(self, bc: str = "pec", eps=None, mu=None, cmax=None):
        self.bc = bc
        self.eps = eps
        self.mu = mu
        self._hetero = eps is not None or mu is not None
        self.cmax = cmax

    def max_speed(self, x=None):
        """Fastest light speed 1/sqrt(eps*mu) for the CFL controller
        (explicitonestep.hh:64 analog); pass `cmax` for heterogeneous
        materials."""
        if self.cmax is not None:
            return self.cmax
        return 1.0

    def _values(self, tab, q, lo):
        return [self.value_at_qp(tab, q[lo + c]) for c in range(3)]

    def _cell_mats(self, xc):
        """(eps, mu) sampled at cell/side sample points xc (..., 3)."""
        e = _eval_mat(self.eps, xc)
        m = _eval_mat(self.mu, xc)
        one = torch.ones(xc.shape[:-1], dtype=xc.dtype, device=xc.device)
        return (one if e is None else e), (one if m is None else m)

    # -- volume --------------------------------------------------------------
    def alpha_volume(self, ctx: VolumeContext, q):
        tab = ctx.tabs[0]
        E = self._values(tab, q, 0)
        H = self._values(tab, q, 3)
        # alpha_E,c = -(1/eps) int (e_c x H) . grad phi ;
        # alpha_H,c = +(1/mu)  int (e_c x E) . grad phi
        basis = [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]]
        r = [-self.accumulate_gradient(tab, ctx.factor,
                                       torch.stack(_cross(basis[c], H), dim=-1))
             for c in range(3)]
        r += [self.accumulate_gradient(tab, ctx.factor,
                                       torch.stack(_cross(basis[c], E), dim=-1))
              for c in range(3)]
        if self._hetero:
            epsv, muv = self._cell_mats(ctx.x.mean(1))      # cell centers
            r = ([ri / epsv[:, None] for ri in r[:3]]
                 + [ri / muv[:, None] for ri in r[3:]])
        return tuple(r)

    # -- face machinery -------------------------------------------------------
    @staticmethod
    def _face_terms(n, Ei, Hi, Eo, Ho, Zi=None, Zo=None):
        """(n x H*, n x E*) with per-side impedances (None -> 1)."""
        nl = [n[0], n[1], n[2]]
        Ejmp = [a - b for a, b in zip(Ei, Eo)]
        Hjmp = [a - b for a, b in zip(Hi, Ho)]
        if Zi is None:
            Hstar = [0.5 * (a + b) + 0.5 * c
                     for a, b, c in zip(Hi, Ho, _cross(nl, Ejmp))]
            Estar = [0.5 * (a + b) - 0.5 * c
                     for a, b, c in zip(Ei, Eo, _cross(nl, Hjmp))]
        else:
            Yi, Yo = 1.0 / Zi, 1.0 / Zo
            sZ, sY = Zi + Zo, Yi + Yo
            Hstar = [(Zi * a + Zo * b + c) / sZ
                     for a, b, c in zip(Hi, Ho, _cross(nl, Ejmp))]
            Estar = [(Yi * a + Yo * b - c) / sY
                     for a, b, c in zip(Ei, Eo, _cross(nl, Hjmp))]
        return _cross(nl, Hstar), _cross(nl, Estar)

    @staticmethod
    def _side_samples(ctx, skeleton):
        """Per-side material sample points: face centers offset half a cell
        inward/outward along the normal."""
        xf = ctx.x.mean(1)                        # (F, 3)
        n = torch.as_tensor(ctx.normal, dtype=xf.dtype, device=xf.device)
        nv = n[:, 0, :] if n.ndim == 3 else torch.broadcast_to(n, xf.shape)
        hi = torch.as_tensor(ctx.h_inside, dtype=xf.dtype, device=xf.device).reshape(-1)
        xi = xf - 0.5 * hi[:, None] * nv
        xo = None
        if skeleton:
            ho = torch.as_tensor(ctx.h_outside, dtype=xf.dtype,
                                 device=xf.device).reshape(-1)
            xo = xf + 0.5 * ho[:, None] * nv
        return xi, xo

    @staticmethod
    def _acc(tab, factor, w):
        return torch.einsum("qb,eq->eb", tab.phi, w * factor)

    def alpha_skeleton(self, ctx: SkeletonContext, q_in, q_out):
        tin, tout = ctx.tab_in, ctx.tab_out
        n = ctx.normal
        Ei, Hi = self._values(tin, q_in, 0), self._values(tin, q_in, 3)
        Eo, Ho = self._values(tout, q_out, 0), self._values(tout, q_out, 3)
        if self._hetero:
            xi, xo = self._side_samples(ctx, skeleton=True)
            ei, mi = self._cell_mats(xi)
            eo, mo = self._cell_mats(xo)
            Zi = torch.sqrt(mi / ei)[:, None]
            Zo = torch.sqrt(mo / eo)[:, None]
            nxH, nxE = self._face_terms(n, Ei, Hi, Eo, Ho, Zi, Zo)
        else:
            nxH, nxE = self._face_terms(n, Ei, Hi, Eo, Ho)
        # r_E += -(1/eps) oint (n x H*) phi ; r_H += +(1/mu) oint (n x E*)
        # phi ; the outside flips n
        r_in = ([self._acc(tin, ctx.factor, -w) for w in nxH]
                + [self._acc(tin, ctx.factor, w) for w in nxE])
        r_out = ([self._acc(tout, ctx.factor, w) for w in nxH]
                 + [self._acc(tout, ctx.factor, -w) for w in nxE])
        if self._hetero:
            r_in = ([r / ei[:, None] for r in r_in[:3]]
                    + [r / mi[:, None] for r in r_in[3:]])
            r_out = ([r / eo[:, None] for r in r_out[:3]]
                     + [r / mo[:, None] for r in r_out[3:]])
        return tuple(r_in), tuple(r_out)

    def alpha_boundary(self, ctx: FaceContext, q):
        tab = ctx.tab
        n = ctx.normal
        Ei, Hi = self._values(tab, q, 0), self._values(tab, q, 3)
        if self.bc == "pec":
            nl = [n[0], n[1], n[2]]
            # mirror tangential E (ghost E = 2(E.n)n - E), copy H
            En = sum(Ei[c] * nl[c] for c in range(3))
            Eo = [2.0 * En * nl[c] - Ei[c] for c in range(3)]
            Ho = Hi
        elif self.bc == "absorb":
            Eo = [torch.zeros_like(e) for e in Ei]
            Ho = [torch.zeros_like(h) for h in Hi]
        else:
            raise ValueError(self.bc)
        if self._hetero:
            xi, _ = self._side_samples(ctx, skeleton=False)
            ei, mi = self._cell_mats(xi)
            Zi = torch.sqrt(mi / ei)[:, None]
            nxH, nxE = self._face_terms(n, Ei, Hi, Eo, Ho, Zi, Zi)
        else:
            nxH, nxE = self._face_terms(n, Ei, Hi, Eo, Ho)
        r = ([self._acc(tab, ctx.factor, -w) for w in nxH]
             + [self._acc(tab, ctx.factor, w) for w in nxE])
        if self._hetero:
            r = ([ri / ei[:, None] for ri in r[:3]]
                 + [ri / mi[:, None] for ri in r[3:]])
        return tuple(r)
