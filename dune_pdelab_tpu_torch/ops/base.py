"""Local operator protocol: PDE weak forms as batched element kernels.

PyTorch port of dune_pdelab_tpu/ops/base.py, volume part (face and
skeleton contexts wait for ROADMAP slice 7). A kernel processes all
elements of a group at once; `do*` flags become method presence; the
Jacobian comes from torch.func.jvp of alpha in the assembler.

Kernel signatures:
  alpha_volume(ctx: VolumeContext, u (E, nloc)) -> r (E, nloc)
  lambda_volume(ctx: VolumeContext)             -> r (E, nloc)

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
    element).
    """

    phi: Any          # (nqp, nb)
    grad: Any         # (Eb, nqp, nb, dim) physical gradients
    ref_grad: Any     # (nqp, nb, dim) reference gradients
    degree: int = 1


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
