"""Preconditioners as closures r -> M r.

PyTorch port of dune_pdelab_tpu/linalg/preconditioners.py (reference:
dune/pdelab/backend/istl/seqistlsolverbackend.hh SeqJac/SeqSOR/AMG
combinations, and the matrix-free block preconditioners of
dune/pdelab/backend/istl/matrixfree/blockdiagonalwrapper.hh and
iterativeblockjacobipreconditioner.hh:267): Jacobi, element-block Jacobi,
Chebyshev, colored element-block Gauss-Seidel, and multicolor SSOR on the
DOF lattice (the SeqSSOR analog). Every color step writes each DOF once
(an index put, not an atomic add), so the result is the same from run to
run.
"""
from __future__ import annotations

import numpy as np
import torch

from dune_pdelab_tpu_torch.assembly.dofmaps import IndexDofMap
from dune_pdelab_tpu_torch.utils.common import resolve_device


def identity():
    return lambda r: r


def richardson(omega=1.0):
    """Scaled identity (ISTL Richardson preconditioner analog)."""
    return lambda r: omega * r


def jacobi(diag, omega=1.0):
    """Point Jacobi from an assembled diagonal (SeqJac analog).

    diag: (n,) = diag(A), e.g. GridOperator.jacobian_diagonal(x).
    """
    inv = omega / diag
    return lambda r: inv * r


def _explicit_block_inverse(blocks):
    """(E, m, m) -> per-block inverses, LU-factored and solved against the
    identity once, so every application is one batched matvec."""
    lu, piv = torch.linalg.lu_factor(blocks)
    eye = torch.eye(blocks.shape[-1], dtype=blocks.dtype,
                    device=blocks.device).expand(blocks.shape)
    return torch.linalg.lu_solve(lu, piv, eye)


def block_jacobi(element_dofs, blocks, overlap_counts=None):
    """Element-block Jacobi (reference: blockdiagonalwrapper.hh + the exact
    block solves of iterativeblockjacobipreconditioner.hh).

    element_dofs: (E, nloc) int64 tensor, the global DOF map; blocks:
    (E, nloc, nloc) element Jacobian blocks. For DG spaces the map is a
    partition and this is the exact block-diagonal inverse; for conforming
    spaces DOFs are shared and the result is scaled by the overlap counts.
    """
    return _block_jacobi_apply(element_dofs, _explicit_block_inverse(blocks), overlap_counts)


def _block_jacobi_apply(element_dofs, Dinv, counts=None):
    """The block solves summed over shared DOFs through one transpose map
    (assembly/dofmaps.py IndexDofMap): no atomics, one result per run.
    counts: the number of elements that hold each DOF (from the map when
    None)."""
    dm = IndexDofMap.of_tensor(element_dofs)
    if counts is None:
        n = int(element_dofs.max()) + 1
        counts = dm.scatter_add(torch.zeros(n, dtype=Dinv.dtype, device=Dinv.device),
                                torch.ones(element_dofs.shape, dtype=Dinv.dtype,
                                           device=Dinv.device))

    def apply(r):
        z_loc = torch.einsum("ejk,ek->ej", Dinv.to(r.dtype), dm.gather(r))
        return dm.scatter_add(torch.zeros_like(r), z_loc) / counts

    return apply


def chebyshev(A, diag, lambda_max, lambda_min_ratio=1.0 / 30.0, degree=4):
    """Chebyshev polynomial preconditioner/smoother on the Jacobi-scaled
    operator. `lambda_max` estimates the largest eigenvalue of D^{-1}A
    (power_iteration below); targets [lambda_max*ratio, lambda_max*1.05].
    """
    dinv = 1.0 / diag
    lmax = lambda_max * 1.05
    lmin = lambda_max * lambda_min_ratio
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)

    def apply(r):
        # standard three-term Chebyshev iteration for A z = r, z0 = 0
        z = torch.zeros_like(r)
        d = dinv * r / theta
        sigma = theta / delta
        rho = 1.0 / sigma
        for _ in range(degree):
            z = z + d
            res = r - A(z)
            rho_new = 1.0 / (2.0 * sigma - rho)
            d = rho_new * rho * d + 2.0 * rho_new / delta * (dinv * res)
            rho = rho_new
        return z + d

    return apply


def power_iteration(A, diag, n, iters=25, seed=0, dtype=torch.float32, v0=None):
    """Estimate lambda_max(D^{-1} A) for Chebyshev setup: `iters` steps
    from v0, else from a seeded standard-normal vector (numpy's generator;
    the reference draws it from jax.random, so the two start vectors
    differ). Returns a 0-d tensor."""
    if v0 is None:
        v0 = np.random.default_rng(seed).standard_normal(n)
    v = torch.as_tensor(np.array(v0, dtype=np.float64), dtype=dtype, device=diag.device)
    v = v / torch.linalg.norm(v)
    dinv = 1.0 / diag
    lam = torch.ones((), dtype=dtype, device=diag.device)
    for _ in range(iters):
        w = dinv * A(v)
        lam = torch.linalg.norm(w)
        v = w / lam
    return lam


def colored_block_gauss_seidel(A, element_dofs, blocks, colors, sweeps=1,
                               omega=1.0):
    """Multiplicative (Gauss-Seidel) element-block sweeps in color order.

    Analog of the block-SOR wrapper (reference:
    dune/pdelab/localoperator/blocksorpreconditioner.hh:38) with the
    race-free patch coloring of dune/pdelab/common/partition/halo/colored.hh:31:
    elements of one color share no DOFs, so each color's block solves are
    one batched matvec and a conflict-free scatter; colors are visited in
    order, which restores the Gauss-Seidel coupling block Jacobi lacks.

    A: operator closure; element_dofs (E, nloc) int64 tensor; blocks
    (E, nloc, nloc); colors: list of int64 element-index tensors.
    """
    return _colored_sweeps(A, element_dofs, _explicit_block_inverse(blocks),
                           colors, sweeps, omega)


def _colored_sweeps(A, element_dofs, Dinv, colors, sweeps=1, omega=1.0):
    color_dofs = [element_dofs[c] for c in colors]
    color_inv = [Dinv[c] for c in colors]

    def apply(r):
        z = torch.zeros_like(r)
        for _ in range(sweeps):
            for dofs, dc in zip(color_dofs, color_inv):
                r_loc = (r - A(z))[dofs]
                d_loc = torch.einsum("ejk,ek->ej", dc.to(r.dtype), r_loc)
                z = z.index_add(0, dofs.reshape(-1), omega * d_loc.reshape(-1))
        return z

    return apply


def checkerboard_colors(mesh, device=None):
    """2^dim parity-tuple element coloring of a structured mesh: elements
    of one color have pairwise disjoint DOF closures (colored.hh analog).
    Returns int64 element-index tensors on `device` (default: the CPU
    numpy-backed tensors' device, i.e. torch's default)."""
    mi = mesh.element_multi_index()
    code = np.zeros(len(mi), dtype=np.int64)
    for d in range(mesh.dim):
        code += (mi[:, d] % 2) << d
    return [torch.as_tensor(np.nonzero(code == c)[0], device=device)
            for c in range(2**mesh.dim)]


def ssor_like(A, diag, omega=1.0, sweeps=2):
    """Symmetric-Jacobi smoothing stand-in for SeqSSOR: damped Jacobi
    iterations applied symmetrically. For a genuine SOR-class method use
    `multicolor_ssor` below."""
    dinv = omega / diag

    def apply(r):
        z = dinv * r
        for _ in range(sweeps - 1):
            z = z + dinv * (r - A(z))
        return z

    return apply


def dof_lattice_colors(space, device=None):
    """Coordinate-parity coloring of a C0 Qk DOF lattice: (k+1)^dim classes
    by per-axis index mod (k+1). Two DOFs coupled by the Qk stencil
    (per-axis offsets in [-k, k], not all zero) always land in different
    classes, so each class is an independent set (the DOF-level
    counterpart of the element halo coloring, reference:
    dune/pdelab/common/partition/halo/colored.hh:31). Returns int64 index
    tensors on `device` (default: the default device)."""
    dims = getattr(space, "_dof_grid_dims", None)
    if dims is None or space.fem.continuity != "C0":
        raise ValueError("dof_lattice_colors needs a structured C0 space")
    m = space.fem.degree + 1
    code = np.zeros(space.ndofs, dtype=np.int64)
    g = np.arange(space.ndofs, dtype=np.int64)
    for d in range(space.mesh.dim):
        code = code * m + (g % dims[d]) % m
        g //= dims[d]
    device = resolve_device(device)
    return [torch.as_tensor(np.nonzero(code == c)[0], device=device)
            for c in range(m ** space.mesh.dim) if np.any(code == c)]


def multicolor_ssor(A, diag, colors, omega=1.0, sweeps=1):
    """Multicolor SSOR (the parallel SeqSSOR analog, reference slot:
    dune/pdelab/backend/istl/seqistlsolverbackend.hh SSOR combinations):
    one sweep is Gauss-Seidel over the color classes forward then
    backward. With a fixed color order the forward+backward composition is
    symmetric, so the result is an SPD preconditioner for CG."""

    def half(z, r, order):
        for cidx in order:
            r_cur = r - A(z)
            z = z.index_put((cidx,), z[cidx] + omega * r_cur[cidx] / diag[cidx])
        return z

    def apply(r):
        z = torch.zeros_like(r)
        for _ in range(sweeps):
            z = half(z, r, colors)
            z = half(z, r, colors[::-1])
        return z

    return apply


def ssor_preconditioner(go, x_lin, time=0.0, omega=1.0, sweeps=1):
    """LinearSolverBackend `precond` callable: multicolor SSOR on the DOF
    lattice of a structured C0 space."""
    colors = dof_lattice_colors(go.space, device=x_lin.device)
    diag = go.jacobian_diagonal(x_lin, time)
    return multicolor_ssor(lambda z: go.jacobian_apply(x_lin, z, time), diag,
                           colors, omega=omega, sweeps=sweeps)
