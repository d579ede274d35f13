"""DG error indicator and slope limiting.

PyTorch port of dune_pdelab_tpu/adaptivity/dgindicator.py (reference
analogs: dune/pdelab/localoperator/errorindicatordg.hh, the jump-based
indicator driving DG adaptivity, and the Limiter hook of the explicit
one-step method, dune/pdelab/instationary/explicitonestep.hh:704).
"""
from __future__ import annotations

import torch


def dg_jump_indicator(go, x, time=0.0):
    """eta_K^2 = sum_faces h_F ||[u_h]||_F^2 per element for a scalar DG
    space (the grid operator's skeleton groups; each group adds into
    distinct elements, `index_add`, so the sums are deterministic)."""
    space = go.space
    if not (space.is_leaf and space.fem.continuity == "DG"):
        raise ValueError("dg_jump_indicator needs a single-leaf DG space")
    eta2 = torch.zeros(go.mesh.nelements, dtype=x.dtype, device=x.device)
    for g in go.skel_groups:
        sctx = go._skel_ctx(g, time, x.dtype, x.device)
        vi = torch.einsum("qb,eb->eq", sctx.tab_in.phi, g.tr_in.gather(x))
        vo = torch.einsum("qb,eb->eq", sctx.tab_out.phi, g.tr_out.gather(x))
        w = sctx.h_inside[0] * torch.sum((vi - vo) ** 2 * sctx.factor, dim=-1)
        for outside in (False, True):
            el = torch.as_tensor(go.group_elements(g, outside), device=x.device)
            eta2 = eta2.index_add(0, el, w)
    return eta2


def _minmod(a, b, c):
    s = torch.sign(a)
    agree = (torch.sign(b) == s) & (torch.sign(c) == s)
    m = s * torch.minimum(torch.abs(a), torch.minimum(torch.abs(b), torch.abs(c)))
    return torch.where(agree, m, 0.0)


class MinmodSlopeLimiter:
    """Minmod slope limiter for Q1 DG scalar fields on structured meshes.

    Per element: keep the mean, replace each directional slope by
    minmod(slope, theta*(forward mean difference), theta*(backward mean
    difference)); rebuild the multilinear nodal values. Neighbours across
    non-periodic boundaries reuse the element's own mean (slopes flatten at
    boundaries). Usable as the `limiter` hook of ExplicitOneStepMethod
    (reference: explicitonestep.hh Limiter protocol)."""

    def __init__(self, space, theta: float = 1.0):
        if not (space.is_leaf and space.fem.continuity == "DG" and space.fem.degree == 1):
            raise ValueError("MinmodSlopeLimiter needs a Q1 DG leaf space")
        self.space = space
        self.theta = theta
        self.mesh = space.mesh
        self.dim = self.mesh.dim
        self.nb = space.fem.nbasis
        self._sign = 2.0 * space.fem._mi - 1.0       # (nb, dim): node sign pattern
        self.eshape = tuple(reversed(self.mesh.cells))

    def _neighbor_means(self, m_grid, axis, shift):
        ax = self.dim - 1 - axis
        if self.mesh.periodic[axis]:
            return torch.roll(m_grid, -shift, dims=ax)
        n = m_grid.shape[ax]
        if shift > 0:
            return torch.cat([m_grid.narrow(ax, 1, n - 1), m_grid.narrow(ax, n - 1, 1)], dim=ax)
        return torch.cat([m_grid.narrow(ax, 0, 1), m_grid.narrow(ax, 0, n - 1)], dim=ax)

    def __call__(self, x):
        u = x.reshape(-1, self.nb)                    # (E, nb)
        sign = torch.as_tensor(self._sign, dtype=x.dtype, device=x.device)
        mean = u.mean(dim=1)
        m_grid = mean.reshape(self.eshape)
        out = torch.broadcast_to(mean[:, None], u.shape)
        for a in range(self.dim):
            # current slope: mean of sign-weighted nodes
            s = torch.mean(u * sign[None, :, a], dim=1)
            dp = (self._neighbor_means(m_grid, a, +1) - m_grid).reshape(-1)
            dm = (m_grid - self._neighbor_means(m_grid, a, -1)).reshape(-1)
            s_lim = _minmod(s, self.theta * 0.5 * dp, self.theta * 0.5 * dm)
            out = out + s_lim[:, None] * sign[None, :, a]
        return out.reshape(x.shape)
