"""State carried across from the JAX package, as numpy arrays.

Takes plain numpy data (e.g. `st.dims`, `st.k`, `st.weights`, `st.offsets`
and `np.asarray(st.mask)` of a JAX StencilOperator, the level state of a
JAX LatticeGMG, or `np.asarray(x)` of a JAX DOF vector) and builds the
port's objects from it. Never imports jax, so it runs where jax is absent.
"""
from __future__ import annotations

import itertools

import numpy as np
import torch

from dune_pdelab_tpu_torch.assembly.stencil import StencilOperator


def stencil_from_numpy(dims, k, weights, offsets, mask, device=None,
                       dtype=torch.float64):
    """Port StencilOperator from numpy stencil data; the weights are held at
    the precision of `dtype` (the dtype the operator was probed in)."""
    w = np.asarray(weights, dtype=np.float64)
    w = torch.as_tensor(w, dtype=dtype).to(torch.float64).numpy()
    m = None if mask is None else torch.as_tensor(
        np.array(mask, dtype=bool), device=device)
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


def vector_from_numpy(x, device=None, dtype=torch.float64):
    """Port DOF vector from a numpy array."""
    return torch.as_tensor(np.array(x), dtype=dtype, device=device)
