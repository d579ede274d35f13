"""Variable-order (p-adaptive) DG spaces via modal truncation constraints.

PyTorch port of dune_pdelab_tpu/constraints/variableorder.py (reference:
dune/pdelab/finiteelementmap/variableqkdgfem.hh, variablemonomfem.hh,
variableopbfem.hh: per-element basis size chosen at run time). Every
element carries the full degree-kmax modal basis (Legendre, OPB or
monomial), so one uniform batched assembly serves any degree layout, and
an element of order k < kmax has its modes outside the order-k
truncation constrained to zero. The modal bases are hierarchical
(max multi-index <= k spans Qk, total degree <= k spans Pk), so the
constrained space is exactly the variable-order DG space; the masked rows
behave like Dirichlet rows everywhere (zero residual rows, identity
Jacobian rows). Low-order elements pay kmax-order assembly flops.
"""
from __future__ import annotations

import numpy as np

from dune_pdelab_tpu_torch.constraints.dirichlet import DirichletConstraints


def variable_order_mask(space, degrees, truncation: str = "tensor"):
    """(ndofs,) bool mask of INACTIVE modes for per-element orders.

    space: leaf DG FunctionSpace over a modal hierarchical basis
    (LegendreDGFEM, OPBFEM, MonomialDGFEM). degrees: (E,) ints <= fem
    degree. truncation: 'tensor' keeps modes with max multi-index <= k
    (Qk subspace), 'total' keeps total degree <= k (Pk subspace).
    """
    fem = space.fem
    if getattr(fem, "nodes", 0) is not None:
        raise ValueError("variable order needs a modal (hierarchical) basis "
                         "— LegendreDGFEM / OPBFEM / MonomialDGFEM")
    degrees = np.asarray(degrees, dtype=np.int64)
    E = space.mesh.nelements
    if degrees.shape != (E,):
        raise ValueError(f"degrees must be ({E},)")
    mi = getattr(fem, "_mi", None)
    if mi is None:
        mi = fem._exps
    mi = np.asarray(mi)                                          # (nb, dims)
    if truncation == "tensor":
        mode_order = mi.max(axis=1)
    elif truncation == "total":
        mode_order = mi.sum(axis=1)
    else:
        raise ValueError(truncation)
    inactive = mode_order[None, :] > degrees[:, None]            # (E, nb)
    mask = np.zeros(space.ndofs, dtype=bool)
    mask[space.element_dofs[inactive]] = True
    return mask


def p_adaptive_constraints(space, degrees, bc_constraints=None,
                           truncation: str = "tensor", device=None):
    """DirichletConstraints fixing truncated modes to zero, optionally
    merged with existing boundary constraints (union of masks), with the
    mask on `device` (default: utils/common.default_device())."""
    mask = variable_order_mask(space, degrees, truncation)
    if bc_constraints is not None:
        if bc_constraints.has_affine:
            raise NotImplementedError("p-adaptive + hanging nodes")
        mask = mask | bc_constraints.mask_np
    return DirichletConstraints(mask, device=device)
