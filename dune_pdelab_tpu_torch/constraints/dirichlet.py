"""Constraints: Dirichlet masks.

PyTorch port of dune_pdelab_tpu/constraints/dirichlet.py without affine
(hanging-node) rows, which wait for ROADMAP slice 11. A constraint set is a
(ndofs,) bool mask, True where the DOF is constrained; the DOF-vector
helpers mirror dune/pdelab/constraints/common/constraints.hh:796-972 as
masked torch ops.
"""
from __future__ import annotations

import numpy as np
import torch

from dune_pdelab_tpu_torch.space.space import FunctionSpace
from dune_pdelab_tpu_torch.utils.common import device_key, resolve_device


class DirichletConstraints:
    """Static constraint data for one flat DOF vector.

    `mask_np` is the host copy; `mask` lives on `device` (default: the
    card, utils/common.default_device). Vectors on another device get a
    cached copy through `mask_on`.
    """

    def __init__(self, mask: np.ndarray, device=None):
        self.mask_np = np.asarray(mask, dtype=bool)
        self.mask = torch.as_tensor(self.mask_np, device=resolve_device(device))
        self.nconstrained = int(self.mask_np.sum())
        self._masks = {device_key(self.mask.device): self.mask}

    def mask_on(self, device) -> torch.Tensor:
        key = device_key(device)
        if key not in self._masks:
            self._masks[key] = self.mask.to(device)
        return self._masks[key]

    def __repr__(self):
        return f"DirichletConstraints(nconstrained={self.nconstrained})"


def _leaf_constraints(bctype, space: FunctionSpace) -> np.ndarray:
    """Boolean constrained-DOF mask for a leaf space.

    `bctype` is None (no constraints), True (whole boundary Dirichlet), or a
    callable evaluated at boundary DOF node coordinates (a float64 numpy
    array, as in the reference) returning a bool array (True = Dirichlet).
    """
    if bctype is None:
        return np.zeros(space.ndofs, dtype=bool)
    bmask = space.boundary_dof_mask()
    if bctype is True:
        return bmask
    mask = np.zeros(space.ndofs, dtype=bool)
    idx = np.nonzero(bmask)[0]
    isd = np.asarray(bctype(space.dof_coords_at(idx)), dtype=bool)
    mask[idx[isd]] = True
    return mask


def constraints(bctype, space, device=None) -> DirichletConstraints:
    """Assemble constraints for a leaf space.

    Analog of `Dune::PDELab::constraints(param, gfs, cg)` (reference:
    dune/pdelab/constraints/common/constraints.hh:775).
    """
    if not getattr(space, "is_leaf", False):
        raise NotImplementedError(
            "constraints on composite spaces are not ported yet "
            "(ROADMAP slice 9)")
    return DirichletConstraints(_leaf_constraints(bctype, space), device=device)


def set_constrained_dofs(cg: DirichletConstraints, value, x):
    """x[constrained] = value  (set_constrained_dofs analog, :796)."""
    return torch.where(cg.mask_on(x.device), value, x)


def set_nonconstrained_dofs(cg: DirichletConstraints, value, x):
    """x[unconstrained] = value  (set_nonconstrained_dofs analog, :960)."""
    return torch.where(cg.mask_on(x.device), x, value)


def copy_constrained_dofs(cg: DirichletConstraints, x_from, x_to):
    """x_to[constrained] = x_from[constrained]  (copy_constrained_dofs, :936)."""
    return torch.where(cg.mask_on(x_to.device), x_from, x_to)


def copy_nonconstrained_dofs(cg: DirichletConstraints, x_from, x_to):
    return torch.where(cg.mask_on(x_to.device), x_to, x_from)


def interpolate_dirichlet(g, space, cg: DirichletConstraints, x):
    """Interpolate boundary function g into x on constrained DOFs only
    (reference idiom: dune/pdelab/test/testpoisson.cc:201)."""
    xg = space.interpolate(g, dtype=x.dtype, device=x.device)
    return copy_constrained_dofs(cg, xg, x)
