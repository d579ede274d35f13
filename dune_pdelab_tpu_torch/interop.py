"""State carried across from the JAX package, as numpy arrays.

Takes plain numpy data (e.g. `st.dims`, `st.k`, `st.weights`, `st.offsets`
and `np.asarray(st.mask)` of a JAX StencilOperator, the level state of a
JAX LatticeGMG, GeometricMultigrid or AlgebraicMultigrid, the arrays of
a simplex, structured or adaptive mesh, or `np.asarray(x)` of a JAX DOF
vector) and builds the port's
objects from it. Never imports jax, so it
runs where jax is absent.
Tensors land on `device`, default utils/common.default_device().
"""
from __future__ import annotations

import itertools

import numpy as np
import torch

from dune_pdelab_tpu_torch.assembly.stencil import StencilOperator
from dune_pdelab_tpu_torch.utils.common import resolve_device


def stencil_from_numpy(dims, k, weights, offsets, mask, device=None,
                       dtype=torch.float64):
    """Port StencilOperator from numpy stencil data; the weights are held at
    the precision of `dtype` (the dtype the operator was probed in)."""
    w = np.asarray(weights, dtype=np.float64)
    w = torch.as_tensor(w, dtype=dtype).to(torch.float64).numpy()
    m = None if mask is None else torch.as_tensor(
        np.array(mask, dtype=bool), device=resolve_device(device))
    classes = list(itertools.product(*[range(int(k))] * len(dims)))
    return StencilOperator(tuple(int(d) for d in dims), int(k), w,
                           np.asarray(offsets), m, classes)


def lattice_gmg_from_numpy(dims, k, stencils, transfers, coarse_lu, *, pre=2,
                           post=2, smoother="chebyshev", omega=0.8, cycle="v",
                           lmax=None, device=None):
    """Port LatticeGMG from a JAX LatticeGMG's numpy state, without probing.

    dims: per-level DOF dims; stencils: per level (weights, offsets, mask);
    transfers: per level and axis (idx, w, ridx, rw); coarse_lu: scipy's
    (lu, piv) with 0-based pivots (converted to LAPACK's 1-based ones);
    lmax: the reference's Chebyshev bounds (default: recomputed from the
    weights, as the reference does).
    """
    from dune_pdelab_tpu_torch.linalg.gmg_lattice import LatticeGMG

    sts = [stencil_from_numpy(d, k, w, off, m, device=device)
           for d, (w, off, m) in zip(dims, stencils)]
    trs = [[tuple(np.asarray(a) for a in axis) for axis in level]
           for level in transfers]
    lu, piv = coarse_lu
    gmg = object.__new__(LatticeGMG)
    gmg._init_levels(dims, sts, trs,
                     (torch.as_tensor(np.asarray(lu, np.float64)),
                      torch.as_tensor(np.asarray(piv) + 1, dtype=torch.int32)),
                     pre=pre, post=post, smoother=smoother, omega=omega,
                     cycle=cycle, lmax=None if lmax is None else list(lmax))
    return gmg


def geometric_mg_from_numpy(lop, mesh, fem, transfers, diags, coarse_lu, *,
                            bctype=None, lmax=None, device=None,
                            dtype=torch.float64, **options):
    """Port GeometricMultigrid of a linear operator from a JAX
    GeometricMultigrid's numpy state, without its setup: `transfers` per
    level (idx, w) (`gmg.transfers`), the level diagonals (`gmg._diags`),
    the coarse LU as scipy's (lu, piv) with 0-based pivots (converted to
    LAPACK's 1-based ones) and the Chebyshev bounds (`gmg._lmax`). The
    level operators are the port's own, re-discretised from (lop, mesh,
    fem, bctype) and linearised at zero; `options` are GeometricMultigrid's
    (cycle, smoother, sweeps, omega, ...). Tensors are held in `dtype` on
    `device`."""
    from dune_pdelab_tpu_torch.linalg.multigrid import GeometricMultigrid

    device = resolve_device(device)

    def t(a):
        return torch.as_tensor(np.array(a), dtype=dtype, device=device)

    gmg = GeometricMultigrid(lop, mesh, fem, bctype=bctype, nlevels=len(diags),
                             device=device, **options)
    gmg.transfers = [(np.asarray(i, np.int32), np.asarray(w, np.float64))
                     for i, w in transfers]
    gmg._xs = [torch.zeros(s.ndofs, dtype=dtype, device=device) for s in gmg.spaces]
    gmg._time = 0.0
    gmg._diags = [t(d) for d in diags]
    if lmax is not None:
        gmg._lmax = [t(v) for v in lmax]
    lu, piv = coarse_lu
    gmg._coarse_lu = (t(lu), torch.as_tensor(np.asarray(piv) + 1, dtype=torch.int32,
                                             device=device))
    gmg._build_apply(gmg._level_maps(dtype))
    return gmg


def ell_from_numpy(dims, k, offsets, values, mask, device=None,
                   dtype=torch.float64):
    """Port EllMatrix from a JAX EllMatrix's arrays as numpy (`ell.dims`,
    `ell.k`, `ell.offsets`, `np.asarray(ell.values)`, `np.asarray(ell.mask)`
    or None), the values held in `dtype` on `device`."""
    from dune_pdelab_tpu_torch.assembly.ell import EllMatrix

    device = resolve_device(device)
    m = None if mask is None else torch.as_tensor(
        np.array(mask, dtype=bool).reshape(-1), device=device)
    return EllMatrix(tuple(int(d) for d in dims), int(k), np.asarray(offsets),
                     torch.as_tensor(np.array(values), dtype=dtype, device=device), m)


def vector_from_numpy(x, device=None, dtype=torch.float64):
    """Port DOF vector from a numpy array."""
    return torch.as_tensor(np.array(x), dtype=dtype, device=resolve_device(device))


def block_stencil_from_numpy(cells, nb, W_taps, offsets, dD_sides, dtype=None):
    """Port BlockStencilOperator from a JAX BlockStencilOperator's arrays
    (`bst.cells`, `bst.nb`, `bst.W_taps`, `bst.offsets`, `bst.dD_sides`).
    The weights are held at the precision of `dtype` (the dtype the
    operator was probed in; default float64); its tensors are built on the
    device of the vector it is applied to."""
    from dune_pdelab_tpu_torch.assembly.blockstencil import BlockStencilOperator

    def held(a):
        a = np.asarray(a, dtype=np.float64)
        if dtype is None:
            return a
        return torch.as_tensor(a, dtype=dtype).to(torch.float64).numpy()

    return BlockStencilOperator(tuple(int(c) for c in cells), int(nb), held(W_taps),
                                np.asarray(offsets), held(dD_sides))


def simplex_mesh_from_numpy(vertices, cells, boundary_vertices=None, parent_cells=None,
                            bisect_tag=None, cell_tags=None, facet_tags=None):
    """Port SimplexMesh from a mesh's arrays (`m.vertices`, `m.cells`,
    `m.boundary_vertex_mask()` of a JAX SimplexMesh), with, where the mesh
    has them, the bisection state (`m.parent_cells`, `m.bisect_tag`) and
    the gmsh tags (`m.cell_tags`, `m.facet_tags`)."""
    from dune_pdelab_tpu_torch.mesh.simplex import SimplexMesh

    bv = None if boundary_vertices is None else np.asarray(boundary_vertices, bool)
    m = SimplexMesh(np.asarray(vertices, np.float64), np.asarray(cells, np.int64),
                    boundary_vertices=bv)
    if parent_cells is not None:
        m.parent_cells = np.asarray(parent_cells, np.int64)
    if bisect_tag is not None:
        m.bisect_tag = np.asarray(bisect_tag, np.int64)
    if cell_tags is not None:
        m.cell_tags = np.asarray(cell_tags, np.int64)
    if facet_tags is not None:
        m.facet_tags = {tuple(int(v) for v in k): int(t) for k, t in facet_tags.items()}
    return m


def structured_mesh_from_numpy(lower, upper, cells, periodic=None, coords=None):
    """Port StructuredMesh from a mesh's numpy state (`m.lower`, `m.upper`,
    `m.cells`, `m.periodic`, `m.coords` of a JAX StructuredMesh)."""
    from dune_pdelab_tpu_torch.mesh.structured import StructuredMesh

    return StructuredMesh(np.asarray(lower, np.float64), np.asarray(upper, np.float64),
                          tuple(int(c) for c in cells),
                          periodic=None if periodic is None else tuple(bool(p) for p in periodic),
                          coords=None if coords is None else np.asarray(coords, np.float64))


def adaptive_mesh_from_numpy(lower, upper, coarse_cells, levels, origins, max_level):
    """Port AdaptiveMesh from a forest's numpy state (`m.lower`, `m.upper`,
    `m.coarse_cells`, `m.levels`, `m.origins`, `m.max_level` of a JAX
    AdaptiveMesh)."""
    from dune_pdelab_tpu_torch.mesh.adaptive import AdaptiveMesh

    return AdaptiveMesh(np.asarray(lower, np.float64), np.asarray(upper, np.float64),
                        tuple(int(c) for c in coarse_cells),
                        levels=np.asarray(levels, np.int64),
                        origins=np.asarray(origins, np.int64), max_level=int(max_level))


def amg_from_host_levels(host_levels, host_coarse, *, device=None, **amg_kw):
    """Port AlgebraicMultigrid V-cycle from the JAX package's hierarchy kept
    with `setup_from_csr(A, keep_host=True)`: `amg.host_levels`, per level
    (A, P, R, diag, rho) as scipy CSRs and numpy arrays, and the dense
    coarse matrix `amg.host_coarse`. No set-up runs; the cycle's options
    (smoother, presmooth, ...) are `amg_kw`. Holds the port's cycle against
    the reference's even where a set-up detail differs."""
    import scipy.sparse as sp

    from dune_pdelab_tpu_torch.linalg.amg import AlgebraicMultigrid

    amg = AlgebraicMultigrid(**amg_kw)
    host = [(sp.csr_matrix(A, dtype=np.float64), sp.csr_matrix(P, dtype=np.float64),
             sp.csr_matrix(R, dtype=np.float64), np.asarray(d, np.float64), float(rho))
            for A, P, R, d, rho in host_levels]
    coarse = np.asarray(host_coarse, np.float64)
    return amg._install(host, coarse, np.count_nonzero(coarse), resolve_device(device))
