"""Geometric multigrid transfer maps on structured mesh hierarchies.

PyTorch port of `_transfer_1d` of dune_pdelab_tpu/linalg/multigrid.py: the
1D Lagrange prolongation map that the lattice multigrids (linalg/
gmg_lattice.py, linalg/gmg_varcoeff.py) apply axis by axis.
GeometricMultigrid (re-discretized levels on the general GridOperator path)
waits for a later slice (ROADMAP Queue 1 item 4).
"""
from __future__ import annotations

import numpy as np

from dune_pdelab_tpu_torch.fe.basis import (
    _lagrange_coeffs, _poly_eval, lagrange_nodes_1d,
)


def _transfer_1d(k: int, nc: int, periodic: bool):
    """1D prolongation map from a coarse Qk DOF line (nc cells) to the
    2x-refined fine line: per fine DOF, (k+1) coarse indices + weights."""
    nodes = lagrange_nodes_1d(k)
    C = _lagrange_coeffs(nodes)
    nfd = 2 * k * nc if periodic else 2 * k * nc + 1
    ncd = k * nc if periodic else k * nc + 1
    gf = np.arange(nfd)
    s = gf / (2.0 * k)                      # position in coarse-element units
    e = np.minimum(np.floor(s + 1e-12).astype(int), nc - 1)
    xi = s - e
    vals, _ = _poly_eval(C, xi)             # (nfd, k+1)
    idx = k * e[:, None] + np.arange(k + 1)[None, :]
    if periodic:
        idx = idx % ncd
    return idx.astype(np.int64), vals, nfd, ncd
