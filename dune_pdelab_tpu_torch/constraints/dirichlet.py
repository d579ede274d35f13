"""Constraints: Dirichlet masks and affine (hanging-node) constraint rows.

PyTorch port of dune_pdelab_tpu/constraints/dirichlet.py (reference:
dune/pdelab/constraints/common/constraints.hh:749-972, `constraints()`
and the DOF-vector helpers; constraints/conforming.hh:36). A constraint
set is a (ndofs,) bool mask, True where the DOF is constrained, plus, on an
AdaptiveMesh, affine rows x[row] = sum_j w_j x[col_j] for the hanging
vertices (reference: constraints/hangingnode.hh:24). The DOF-vector helpers
mirror constraints.hh:796-972 as masked torch ops.

The hanging-node operators sum in a fixed order: `prolong` reads each
hanging row's parents from a padded (rows, K) table, `restrict_transpose`
and `fold_diagonal` gather each parent's hanging children through a
transpose map. The reference's `.at[].add` scatters are atomic adds on the
card; these give the same bits on every call.
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
    cached copy through `mask_on`. `mask` marks ALL constrained DOFs
    (Dirichlet and hanging); hanging rows carry affine rows whose parent
    columns are never hanging themselves (transitively resolved).
    """

    def __init__(self, mask: np.ndarray, affine_rows=None, affine_cols=None,
                 affine_weights=None, device=None):
        self.mask_np = np.asarray(mask, dtype=bool)
        self.mask = torch.as_tensor(self.mask_np, device=resolve_device(device))
        self.nconstrained = int(self.mask_np.sum())
        self._masks = {device_key(self.mask.device): self.mask}
        self.affine_rows = None if affine_rows is None else np.asarray(affine_rows, np.int64)
        self.affine_cols = None if affine_cols is None else np.asarray(affine_cols, np.int64)
        self.affine_weights = (None if affine_weights is None
                               else np.asarray(affine_weights, np.float64))
        self._dev = {}
        if self.has_affine:
            self._build_affine()

    @property
    def has_affine(self) -> bool:
        return self.affine_rows is not None and len(self.affine_rows) > 0

    def mask_on(self, device) -> torch.Tensor:
        key = device_key(device)
        if key not in self._masks:
            self._masks[key] = self.mask.to(device)
        return self._masks[key]

    def _build_affine(self):
        """Host tables of the hanging rows: the per-DOF parent CSR of the
        assembled triple product (identity for DOFs that are not hanging),
        the padded parent table of `prolong` (the rows' entries in the
        order given) and the transpose map of the parents' sums."""
        rows, cols, w = self.affine_rows, self.affine_cols, self.affine_weights
        n = len(self.mask_np)
        cnt = np.bincount(rows, minlength=n)
        counts = np.where(cnt > 0, cnt, 1)          # hanging: #parents, else 1
        indptr = np.zeros(n + 1, dtype=np.int64)
        indptr[1:] = np.cumsum(counts)
        order = np.argsort(rows, kind="stable")     # entries of a row, in order
        rank = np.arange(len(rows)) - np.searchsorted(rows[order], rows[order])
        pidx = np.empty(indptr[-1], dtype=np.int64)
        pw = np.ones(indptr[-1], dtype=np.float64)
        free = cnt == 0
        pidx[indptr[:-1][free]] = np.nonzero(free)[0]
        pidx[indptr[rows[order]] + rank] = cols[order]
        pw[indptr[rows[order]] + rank] = w[order]
        self._parent_indptr, self._parent_idx, self._parent_w = indptr, pidx, pw
        hm = np.zeros(n, dtype=bool)
        hm[rows] = True
        self.hanging_mask_np = hm
        self._hrows = np.nonzero(hm)[0]                           # (H,)
        K = int(cnt.max())
        slot = indptr[self._hrows][:, None] + np.arange(K)[None, :]
        valid = np.arange(K)[None, :] < cnt[self._hrows][:, None]
        self._hcols = np.where(valid, pidx[np.minimum(slot, len(pidx) - 1)], 0)
        self._hw = np.where(valid, pw[np.minimum(slot, len(pw) - 1)], 0.0)

    def _tensors(self, device):
        """Device copies of the hanging tables (and the transpose map of
        the entries: for every DOF, the entries whose parent it is)."""
        key = device_key(device)
        if key not in self._dev:
            from dune_pdelab_tpu_torch.linalg.multigrid import transpose_map

            rows = torch.as_tensor(self.affine_rows, device=device)
            cols = torch.as_tensor(self.affine_cols, device=device)
            w = torch.as_tensor(self.affine_weights, device=device)
            tidx, tw = transpose_map(cols[:, None],
                                     torch.ones((len(rows), 1), dtype=torch.float64,
                                                device=device), len(self.mask_np))
            self._dev[key] = dict(
                hmask=torch.as_tensor(self.hanging_mask_np, device=device),
                hrows=torch.as_tensor(self._hrows, device=device),
                hcols=torch.as_tensor(self._hcols, device=device),
                hw=torch.as_tensor(self._hw, device=device),
                rows=rows, w=w,
                # padded slots point one past the entries (a zero appended)
                tidx=torch.where(tw != 0, tidx, len(rows)))
        return self._dev[key]

    def _to_parents(self, v, t):
        """out[c] = sum over entries e with col c of v[e], ascending e."""
        return torch.cat([v, v.new_zeros(1)])[t["tidx"]].sum(dim=1)

    # -- hanging-node operators (the etadd triple product as vector ops,
    #    reference: gridoperator/common/assemblerutilities.hh:501-586) ----
    def prolong(self, x):
        """P x: overwrite hanging DOFs with their parent interpolation."""
        if not self.has_affine:
            return x
        t = self._tensors(x.device)
        vals = (t["hw"].to(x.dtype) * x[t["hcols"]]).sum(dim=1)
        out = x.clone()
        out[t["hrows"]] = vals
        return out

    def restrict_transpose(self, r):
        """P^T r: distribute hanging-row residuals to parents, zero them."""
        if not self.has_affine:
            return r
        t = self._tensors(r.device)
        r = r + self._to_parents(t["w"].to(r.dtype) * r[t["rows"]], t)
        return torch.where(t["hmask"], 0.0, r)

    def fold_diagonal(self, d):
        """d + the hanging rows' diagonals folded into their parents with
        weight w^2 (the reference's approximate P^T J P diagonal)."""
        t = self._tensors(d.device)
        return d + self._to_parents((t["w"].to(d.dtype) ** 2) * d[t["rows"]], t)

    def __repr__(self):
        return (f"DirichletConstraints(nconstrained={self.nconstrained}"
                f"{', +affine' if self.has_affine else ''})")


def _leaf_constraints(bctype, space: FunctionSpace) -> np.ndarray:
    """Boolean constrained-DOF mask for a leaf space.

    `bctype` is None (no constraints), True (whole boundary Dirichlet), or a
    callable evaluated at boundary DOF node coordinates (a float64 numpy
    array, as in the reference) returning a bool array (True = Dirichlet).
    """
    if bctype is None or space.fem.continuity not in ("C0", "Mimetic"):
        # nodal continuities take Dirichlet values by mask: C0 (vertex, edge
        # and face nodes) and mimetic (face-centroid values); DG boundary
        # conditions are weak (face terms of the local operator)
        return np.zeros(space.ndofs, dtype=bool)
    bmask = space.boundary_dof_mask()
    if bctype is True:
        return bmask
    mask = np.zeros(space.ndofs, dtype=bool)
    idx = np.nonzero(bmask)[0]
    isd = np.asarray(bctype(space.dof_coords_at(idx)), dtype=bool)
    mask[idx[isd]] = True
    return mask


def _mask(bctype, space) -> np.ndarray:
    """Constrained-DOF mask of a leaf or composite space: composite spaces
    recurse and place each child's mask through the ordering."""
    if getattr(space, "is_leaf", False):
        return _leaf_constraints(bctype, space)
    if not isinstance(bctype, (tuple, list)):
        bctype = (bctype,) * space.nchildren
    mask = np.zeros(space.ndofs, dtype=bool)
    for i, (c, bc) in enumerate(zip(space.children, bctype)):
        mask[space.child_global(i, np.arange(c.ndofs, dtype=np.int64))] = _mask(bc, c)
    return mask


def constraints(bctype, space, device=None) -> DirichletConstraints:
    """Assemble constraints for a (possibly composite) space.

    Analog of `Dune::PDELab::constraints(param, gfs, cg)` (reference:
    dune/pdelab/constraints/common/constraints.hh:775). For a composite
    space pass a tuple of per-child bctypes (or one, applied to every
    child). A leaf space on an AdaptiveMesh adds the hanging-node affine
    rows; Dirichlet wins on overlap (the HangingNodesDirichletConstraints
    composition, reference: constraints/hangingnode.hh:310).
    """
    mask = _mask(bctype, space)
    if getattr(space, "is_leaf", False) and hasattr(space.mesh, "hanging_constraints"):
        rows, cols, w = space.mesh.hanging_constraints()
        keep = ~mask[rows]
        rows, cols, w = rows[keep], cols[keep], w[keep]
        if len(rows):
            mask = mask.copy()
            mask[rows] = True
            # parents may be Dirichlet (value prescribed) but never hanging
            if np.isin(cols, rows).any():
                raise AssertionError("hanging parents must not be hanging")
            return DirichletConstraints(mask, rows, cols, w, device=device)
    return DirichletConstraints(mask, device=device)


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


def no_constraints(space, device=None) -> DirichletConstraints:
    """NoConstraints analog (reference: constraints/noconstraints.hh)."""
    return DirichletConstraints(np.zeros(space.ndofs, dtype=bool), device=device)
