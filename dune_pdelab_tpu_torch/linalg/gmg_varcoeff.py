"""Variable-coefficient geometric multigrid on structured Q1 lattices.

PyTorch port of dune_pdelab_tpu/linalg/gmg_varcoeff.py. Level operators
are rediscretized: a GridOperator per level on the 2x-coarsened mesh, with
the coefficient fields re-evaluated at the level's quadrature points, and
applied matrix-free through the fused structured Q1 operator
(assembly/structured_fused.make_fused_japply: the structured_fused kernel
on a CUDA tensor, its plain version on a CPU tensor). Only an operator that
does not qualify for it falls back to the batched jvp apply.

Per-level smoother data comes from 27 residue-comb probes of the level
operator: a comb with unit spikes on the (i mod 3 == s) sublattice
isolates, for every row i, exactly one stencil entry A[i, j_s(i)] (reach-1
coupling, spacing-3 spikes). Summing |y_s| over the 27 combs gives exact
per-row Gershgorin sums, and the s = (i mod 3) entries give the exact
diagonal: a rigorous lambda_max(D^-1 A) bound for Chebyshev at 27 applies
per level. The cycle, smoother and solver logic is LatticeGMG's.

Validity: single-leaf Q1 C0 space, 3D uniform non-periodic mesh with even
cell counts per level, linear ConvectionDiffusionFEM volume kernels, fully
Dirichlet boundary.
"""
from __future__ import annotations

import itertools

import numpy as np
import torch

from dune_pdelab_tpu_torch.linalg.gmg_lattice import (
    LatticeGMG, coarse_lu_factor, level_hierarchy, separable_transfers,
)
from dune_pdelab_tpu_torch.utils.common import resolve_device


class _FusedLevelOp:
    """Level operator adapter with the StencilOperator protocol pieces the
    inherited V-cycle uses: __call__(z), .mask, .diagonal(dtype, device)."""

    def __init__(self, apply_fn, mask, diag):
        self._apply = apply_fn
        self.mask = mask
        self._diag = diag

    def __call__(self, z):
        return self._apply(z)

    def diagonal(self, dtype=None, device=None):
        return self._diag.to(device=device or self._diag.device,
                             dtype=dtype or self._diag.dtype)


def _probe_gershgorin(apply_fn, dims, dtype=torch.float32, device=None):
    """Exact diagonal + per-row Gershgorin ratio of a reach-1 lattice
    operator via 27 residue combs, on `device` (default_device() for None).
    Returns (diag, lmax_bound)."""
    device = resolve_device(device)
    dim = len(dims)
    rev = tuple(reversed(dims))
    axes_mod = [
        (torch.arange(rev[dim - 1 - d], device=device) % 3).reshape(
            [-1 if a == dim - 1 - d else 1 for a in range(dim)])
        for d in range(dim)
    ]
    n = int(np.prod(dims))
    abs_acc = torch.zeros(n, dtype=dtype, device=device)
    diag_acc = torch.zeros(n, dtype=dtype, device=device)
    for s in itertools.product(range(3), repeat=dim):
        comb = torch.ones(rev, dtype=torch.bool, device=device)
        for d in range(dim):
            comb = comb & (axes_mod[d] == s[d])
        comb = comb.reshape(-1).to(dtype)
        y = apply_fn(comb)
        abs_acc = abs_acc + torch.abs(y)
        diag_acc = diag_acc + comb * y
    lmax = float(torch.max(abs_acc / torch.abs(diag_acc)))
    return diag_acc, lmax


class VarCoeffGMG(LatticeGMG):
    """Rediscretized matrix-free GMG: LatticeGMG semantics (apply /
    solve_host / make_solver) for variable-coefficient Q1 operators. The
    level operators and smoother data live on go's constraint device."""

    def __init__(self, go, *, pre=2, post=2, smoother="chebyshev",
                 omega=0.8, coarsest_cells=4, cycle="v"):
        from dune_pdelab_tpu_torch.assembly.gridoperator import GridOperator
        from dune_pdelab_tpu_torch.assembly.structured_fused import make_fused_japply
        from dune_pdelab_tpu_torch.constraints.dirichlet import (
            constraints as make_constraints)
        from dune_pdelab_tpu_torch.space.space import (
            FunctionSpace, _leaf_boundary_dof_mask)

        space = go.space
        mesh, fem = space.mesh, space.fem
        if fem.degree != 1:
            raise ValueError("VarCoeffGMG is Q1-only (the fused kernel "
                             "contract); use LatticeGMG for invariant Qk")
        if any(mesh.periodic) or not mesh.uniform:
            raise ValueError("VarCoeffGMG requires a uniform non-periodic "
                             "structured mesh")
        if go.cg is None:
            raise ValueError("VarCoeffGMG requires Dirichlet constraints")
        bmask = _leaf_boundary_dof_mask(space)
        if not np.all(go.cg.mask_np[np.nonzero(bmask)[0]]):
            raise ValueError("VarCoeffGMG requires a fully Dirichlet "
                             "boundary (coarse levels impose it)")
        device = go.cg.mask.device
        self.meshes = level_hierarchy(mesh, coarsest_cells)
        dims = [tuple(c + 1 for c in m.cells) for m in self.meshes]

        gos = [go]
        for m in self.meshes[1:]:
            Vl = FunctionSpace(m, fem)
            gos.append(GridOperator(Vl, go.lop,
                                    constraints=make_constraints(True, Vl, device=device),
                                    quad_order=go.qorder, skip_boundary=True))
        self.level_gos = gos

        ops, lmax = [], []
        for l, gol in enumerate(gos):
            fused = make_fused_japply(gol)
            if fused is None:
                # non-qualifying operator: the batched jvp apply
                x0 = torch.zeros(gol.space.ndofs, dtype=torch.float32, device=device)

                def fused(z, _go=gol, _x0=x0):
                    return _go.jacobian_apply(_x0, z)
            diag, bound = _probe_gershgorin(fused, dims[l], device=device)
            ops.append(_FusedLevelOp(fused, gol.cg.mask_on(device), diag))
            lmax.append(bound)

        self._init_levels(dims, ops, separable_transfers(1, self.meshes, dims),
                          coarse_lu_factor(gos[-1]), pre=pre, post=post,
                          smoother=smoother, omega=omega, cycle=cycle, lmax=lmax)
