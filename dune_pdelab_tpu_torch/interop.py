"""State carried across from the JAX package, as numpy arrays.

Takes plain numpy data (e.g. `st.dims`, `st.k`, `st.weights`, `st.offsets`
and `np.asarray(st.mask)` of a JAX StencilOperator, or `np.asarray(x)` of a
JAX DOF vector) and builds the port's objects from it. Never imports jax,
so it runs where jax is absent.
"""
from __future__ import annotations

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
    return StencilOperator(tuple(int(d) for d in dims), int(k), w,
                           np.asarray(offsets), m)


def vector_from_numpy(x, device=None, dtype=torch.float64):
    """Port DOF vector from a numpy array."""
    return torch.as_tensor(np.array(x), dtype=dtype, device=device)
