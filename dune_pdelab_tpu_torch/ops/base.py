"""Local operator protocol: PDE weak forms as batched element kernels.

PyTorch port of dune_pdelab_tpu/ops/base.py. A kernel processes all
elements (or faces) of a group at once; `do*` flags become method presence;
the Jacobian comes from torch.func.jvp of alpha in the assembler.

Kernel signatures:
  alpha_volume(ctx: VolumeContext, u (E, nloc))     -> r (E, nloc)
  lambda_volume(ctx: VolumeContext)                 -> r (E, nloc)
  alpha_boundary(ctx: FaceContext, u (F, nloc))     -> r (F, nloc)
  lambda_boundary(ctx: FaceContext)                 -> r (F, nloc)
  alpha_skeleton(ctx: SkeletonContext, u_in, u_out) -> (r_in, r_out)

The contractions run through torch.einsum in the working dtype; on the
card the assembler first switches TF32 off (utils/common.full_fp32_on_cuda)
so fp32 einsums stay full fp32.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch


@dataclass(frozen=True)
class LeafTab:
    """Per-leaf basis data at a set of reference points.

    On uniform meshes the element axis of `grad` is 1 (shared by every
    element). H(div) and H(curl) leaves carry Piola-mapped values instead of
    phi/grad: shared (nqp, nb, dim) tensors on a uniform mesh, per-element
    (E, nqp, nb, dim) ones on a mapped or simplex mesh.
    """

    phi: Any          # (nqp, nb)
    grad: Any         # (Eb, nqp, nb, dim) physical gradients
    ref_grad: Any     # (nqp, nb, dim) reference gradients
    degree: int = 1
    vec_phi: Any = None   # H(div)/H(curl): (nqp, nb, dim) mapped values
    div: Any = None       # H(div): (nqp, nb) physical divergence
    curl: Any = None      # H(curl): (nqp, nb) in 2D, (nqp, nb, 3) in 3D


@dataclass(frozen=True)
class VolumeContext:
    """Everything an alpha_volume/lambda_volume kernel may need
    (reference: localoperator/convectiondiffusionfem.hh:63-138)."""

    weights: Any      # (nqp,) quadrature weights
    x: Any            # (E, nqp, dim) physical quadrature points
    factor: Any       # (Eb, nqp) w_q * |det J|
    tabs: tuple       # per-leaf LeafTab
    jac_inv_T: Any    # (Eb, nqp, dim, dim)
    cell_volume: Any  # (Eb,) measure of each element
    time: Any = 0.0

    @property
    def tab(self) -> LeafTab:
        return self.tabs[0]

    @property
    def nqp(self) -> int:
        return len(self.weights)


@dataclass(frozen=True)
class FaceContext:
    """Boundary-face kernel context (alpha_boundary/lambda_boundary).

    `normal` is the outward unit normal (from the inside element). On the
    uniform structured mesh each face group shares one normal (a +/- unit
    vector), so it is a (dim,) constant.
    """

    weights: Any      # (nqp,)
    x: Any            # (F, nqp, dim)
    factor: Any       # (Fb, nqp) w_q * face measure
    normal: Any       # (dim,)
    tabs: tuple       # per-leaf LeafTab at face qps (inside embedding)
    h_inside: Any     # (Fb,) element length normal to the face
    time: Any = 0.0

    @property
    def tab(self) -> LeafTab:
        return self.tabs[0]


@dataclass(frozen=True)
class SkeletonContext:
    """Interior-face kernel context (alpha_skeleton).

    Tabulations for both embeddings: `inside` at the face seen from the
    lower element (its upper face), `outside` from the upper element. The
    normal points from inside to outside (reference convention:
    localoperator/convectiondiffusiondg.hh:271 two-sided accumulate).
    """

    weights: Any
    x: Any            # (F, nqp, dim)
    factor: Any       # (Fb, nqp)
    normal: Any       # (dim,)
    tabs_in: tuple    # per-leaf LeafTab, inside embedding
    tabs_out: tuple   # per-leaf LeafTab, outside embedding
    h_inside: Any     # (Fb,)
    h_outside: Any    # (Fb,)
    time: Any = 0.0

    @property
    def tab_in(self) -> LeafTab:
        return self.tabs_in[0]

    @property
    def tab_out(self) -> LeafTab:
        return self.tabs_out[0]


class LocalOperator:
    """Base class for PDE weak-form kernels.

      is_linear:      alpha terms are linear in u (isLinear flag analog)
      quadrature_factor, quadrature_add: default quad order =
                      quadrature_factor * max_degree + quadrature_add
    """

    is_linear = False
    quadrature_factor = 2
    quadrature_add = 0

    def quad_order(self, degree: int) -> int:
        return self.quadrature_factor * degree + self.quadrature_add

    def set_time(self, t):
        """Return a copy bound to time t; default: operators ignore time."""
        return self

    @staticmethod
    def value_at_qp(tab: LeafTab, u):
        """u_h at quadrature points: (E, nloc) -> (E, nqp)."""
        return torch.einsum("qb,eb->eq", tab.phi, u)

    @staticmethod
    def gradient_at_qp(tab: LeafTab, u):
        """grad u_h at quadrature points: (E, nloc) -> (E, nqp, dim)."""
        if tab.grad.shape[0] == 1:
            return torch.einsum("qbd,eb->eqd", tab.grad[0], u)
        return torch.einsum("eqbd,eb->eqd", tab.grad, u)

    @staticmethod
    def accumulate_value(tab: LeafTab, factor, w):
        """sum_q w(E,nqp) * phi_i * factor -> (E, nloc)."""
        return torch.einsum("qb,eq->eb", tab.phi, w * factor)

    @staticmethod
    def accumulate_gradient(tab: LeafTab, factor, wvec):
        """sum_q (wvec(E,nqp,dim) . grad phi_i) * factor -> (E, nloc)."""
        wv = wvec * factor[..., None]
        if tab.grad.shape[0] == 1:
            return torch.einsum("qbd,eqd->eb", tab.grad[0], wv)
        return torch.einsum("eqbd,eqd->eb", tab.grad, wv)

    # -- H(div) vector-element helpers: vec_phi/div carry a leading element
    #    axis on mapped and simplex meshes (per-element Piola) ---------------
    @staticmethod
    def hdiv_value_at_qp(tab: LeafTab, u):
        """Vector value of an H(div) (or H(curl)) field: (E, nloc) -> (E, nqp, dim)."""
        if tab.vec_phi.ndim == 4:
            return torch.einsum("eqbd,eb->eqd", tab.vec_phi, u)
        return torch.einsum("qbd,eb->eqd", tab.vec_phi, u)

    @staticmethod
    def div_at_qp(tab: LeafTab, u):
        """Divergence of an H(div) field: (E, nloc) -> (E, nqp)."""
        if tab.div.ndim == 3:
            return torch.einsum("eqb,eb->eq", tab.div, u)
        return torch.einsum("qb,eb->eq", tab.div, u)

    @staticmethod
    def accumulate_hdiv(tab: LeafTab, factor, wvec):
        """sum_q wvec(E,nqp,dim) . phi_i * factor -> (E, nloc)."""
        wv = wvec * factor[..., None]
        if tab.vec_phi.ndim == 4:
            return torch.einsum("eqbd,eqd->eb", tab.vec_phi, wv)
        return torch.einsum("qbd,eqd->eb", tab.vec_phi, wv)

    @staticmethod
    def accumulate_div(tab: LeafTab, factor, w):
        """sum_q w(E,nqp) * div phi_i * factor -> (E, nloc)."""
        if tab.div.ndim == 3:
            return torch.einsum("eqb,eq->eb", tab.div, w * factor)
        return torch.einsum("qb,eq->eb", tab.div, w * factor)

    # -- H(curl) edge-element helpers: a per-element tab is told by
    #    vec_phi.ndim == 4 (the curl's shape alone is ambiguous for nb == 3)
    @staticmethod
    def curl_at_qp(tab: LeafTab, u):
        """Curl of an H(curl) field: (E, nqp) in 2D, (E, nqp, 3) in 3D."""
        if tab.vec_phi is not None and tab.vec_phi.ndim == 4:
            if tab.curl.ndim == 3:
                return torch.einsum("eqb,eb->eq", tab.curl, u)
            return torch.einsum("eqbd,eb->eqd", tab.curl, u)
        if tab.curl.ndim == 2:
            return torch.einsum("qb,eb->eq", tab.curl, u)
        return torch.einsum("qbd,eb->eqd", tab.curl, u)

    @staticmethod
    def accumulate_curl(tab: LeafTab, factor, w):
        """Dual of curl_at_qp: weight w (E, nqp[, 3]) -> (E, nloc)."""
        if tab.vec_phi is not None and tab.vec_phi.ndim == 4:
            if tab.curl.ndim == 3:
                return torch.einsum("eqb,eq->eb", tab.curl, w * factor)
            return torch.einsum("eqbd,eqd->eb", tab.curl, w * factor[..., None])
        if tab.curl.ndim == 2:
            return torch.einsum("qb,eq->eb", tab.curl, w * factor)
        return torch.einsum("qbd,eqd->eb", tab.curl, w * factor[..., None])


class CombinedOperator(LocalOperator):
    """Weighted sum of local operators (reference:
    localoperator/combinedoperator.hh:29, sum.hh:25, weightedsum.hh,
    scaled.hh), e.g. mass + stiffness outside the one-step machinery. A
    kernel is present when any summand has it (method presence, as the
    GridOperator tests with hasattr)."""

    def __init__(self, ops, weights=None):
        self.ops = tuple(ops)
        self.weights = tuple(weights) if weights is not None else (1.0,) * len(self.ops)
        self.is_linear = all(op.is_linear for op in self.ops)
        self.quadrature_factor = max(op.quadrature_factor for op in self.ops)
        self.quadrature_add = max(op.quadrature_add for op in self.ops)

    def set_time(self, t):
        return CombinedOperator([op.set_time(t) for op in self.ops], self.weights)

    def _sum(self, method, *args):
        out = None
        for w, op in zip(self.weights, self.ops):
            if hasattr(op, method):
                term = getattr(op, method)(*args)
                if isinstance(term, tuple):
                    term = tuple(w * t for t in term)
                    out = term if out is None else tuple(a + b for a, b in zip(out, term))
                else:
                    out = w * term if out is None else out + w * term
        return out

    def __getattr__(self, name):
        if name in ("alpha_volume", "lambda_volume", "alpha_boundary",
                    "lambda_boundary", "alpha_skeleton", "lambda_skeleton"):
            if any(hasattr(op, name) for op in self.ops):
                return lambda *args: self._sum(name, *args)
        raise AttributeError(name)


def ScaledOperator(op, factor):
    """Scaled local operator (reference: localoperator/scaled.hh)."""
    return CombinedOperator([op], [factor])
