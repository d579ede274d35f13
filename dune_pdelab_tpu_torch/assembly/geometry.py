"""Element geometry precomputation for the batched assembler.

PyTorch port of dune_pdelab_tpu/assembly/geometry.py, uniform path only
(multilinear geometry and FaceGeometry wait for ROADMAP slices 11 and 7).
Every element is the same axis-aligned box, so the Jacobian is one shared
diagonal and the per-element data is the element origin. Origins are never
held on the host: at 512^3 an eager (E, dim) float64 origin array costs
about 3.2 GB. They are computed on the device when a context is built, and
the slabbed / stencil paths only ever build contexts of slab or proxy
size.
"""
from __future__ import annotations

import numpy as np
import torch

from dune_pdelab_tpu_torch.mesh.structured import StructuredMesh


class VolumeGeometry:
    """Per-element geometry at a set of reference quadrature points."""

    def __init__(self, mesh: StructuredMesh, qp_ref: np.ndarray, weights: np.ndarray):
        if not mesh.uniform:
            raise NotImplementedError(
                "multilinear geometry is not ported yet (ROADMAP slice 11)")
        self.mesh = mesh
        self.qp_ref = qp_ref            # (nqp, dim)
        self.weights = weights          # (nqp,)
        h = mesh.h
        detJ = float(np.prod(h))
        self.jac_inv_T = np.diag(1.0 / h)[None, None]     # (1, 1, d, d)
        self.factor = (weights * detJ)[None, :]           # (1, nqp)
        self.cell_volume = np.array([detJ])               # (1,)
        self.qp_phys_offset = qp_ref * h                  # (nqp, dim)

    def origins_tensor(self, dtype, device) -> torch.Tensor:
        """(E, dim) element origins lower + multi_index * h, computed on
        `device` in float64 (the reference's host arithmetic), then cast."""
        mesh = self.mesh
        e = torch.arange(mesh.nelements, dtype=torch.int64, device=device)
        cols = []
        for d in range(mesh.dim):
            cols.append(e % mesh.cells[d])
            e = e // mesh.cells[d]
        mi = torch.stack(cols, dim=1).to(torch.float64)
        lower = torch.as_tensor(mesh.lower, device=device)
        h = torch.as_tensor(mesh.h, device=device)
        return (lower + mi * h).to(dtype)

    def transform_grad(self, ref_grad: np.ndarray) -> np.ndarray:
        """Reference (nqp, nb, d) -> physical gradients (1, nqp, nb, d)."""
        return (ref_grad / self.mesh.h)[None]
