"""State carried across from the JAX package, as numpy arrays.

Takes plain numpy data (e.g. `st.dims`, `st.k`, `st.weights`, `st.offsets`
and `np.asarray(st.mask)` of a JAX StencilOperator, the level state of a
JAX LatticeGMG, or `np.asarray(x)` of a JAX DOF vector) and builds the
port's objects from it. Never imports jax, so it runs where jax is absent.
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
