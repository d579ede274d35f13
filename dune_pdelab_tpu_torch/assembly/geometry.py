"""Element geometry precomputation for the batched assembler.

PyTorch port of dune_pdelab_tpu/assembly/geometry.py. Two volume paths:

  * uniform: every element is the same axis-aligned box, so the Jacobian
    is one shared diagonal and the per-element data is the element origin.
    Origins are never held on the host: at 512^3 an eager (E, dim) float64
    origin array costs about 3.2 GB. They are computed on the device when a
    context is built, and the slabbed / stencil paths only ever build
    contexts of slab or proxy size.
  * per element (simplex, mapped cube and AdaptiveMesh meshes):
    J = sum over corners of corner (x) dN of the P1/Q1 geometry
    element, per element and quadrature point, inverted in closed form
    (`det_inv`), with the quadrature factor, the cell volume and the
    physical quadrature points, all float64 numpy at setup.

FaceGeometry is the uniform structured mesh's shared face data; the faces
of mapped and simplex meshes carry per-face geometry built by the
GridOperator's face groups.
"""
from __future__ import annotations

import numpy as np
import torch

from dune_pdelab_tpu_torch.fe.basis import geometry_element


def det_inv(J: np.ndarray):
    """Closed-form det and inverse-transpose of (..., d, d) for d in 1..3."""
    d = J.shape[-1]
    if d == 1:
        det = J[..., 0, 0]
        return det, (1.0 / det)[..., None, None]
    if d == 2:
        a, b = J[..., 0, 0], J[..., 0, 1]
        c, e = J[..., 1, 0], J[..., 1, 1]
        det = a * e - b * c
        inv = np.empty_like(J)
        inv[..., 0, 0] = e
        inv[..., 0, 1] = -b
        inv[..., 1, 0] = -c
        inv[..., 1, 1] = a
        return det, np.swapaxes(inv, -1, -2) / det[..., None, None]
    if d == 3:
        cof = np.empty_like(J)
        for i in range(3):
            for j in range(3):
                r = [k for k in range(3) if k != i]
                c = [k for k in range(3) if k != j]
                cof[..., i, j] = ((-1) ** (i + j)) * (
                    J[..., r[0], c[0]] * J[..., r[1], c[1]]
                    - J[..., r[0], c[1]] * J[..., r[1], c[0]])
        det = (J[..., 0, :] * cof[..., 0, :]).sum(-1)
        return det, cof / det[..., None, None]   # inv^T = cof / det
    raise NotImplementedError(f"dim {d}")


class VolumeGeometry:
    """Per-element geometry at a set of reference quadrature points."""

    def __init__(self, mesh, qp_ref: np.ndarray, weights: np.ndarray):
        self.mesh = mesh
        self.qp_ref = qp_ref            # (nqp, dim)
        self.weights = weights          # (nqp,)
        self.jac_inv_T_elem = None      # (E, d, d) on a simplex mesh
        if mesh.uniform:
            h = mesh.h
            detJ = float(np.prod(h))
            self.jac_inv_T = np.diag(1.0 / h)[None, None]     # (1, 1, d, d)
            self.factor = (weights * detJ)[None, :]           # (1, nqp)
            self.cell_volume = np.array([detJ])               # (1,)
            self.qp_phys_offset = qp_ref * h                  # (nqp, dim)
            self.qp_phys = None
            return
        corners = mesh.element_corner_coords()                # (E, C, d)
        N, dN = geometry_element(mesh.geometry_type, mesh.dim).tabulate(qp_ref)
        # the einsums "eci,qcj->eqij" and "qc,ecd->eqd" as broadcast matmuls
        if mesh.geometry_type == "simplex":
            # affine: one Jacobian per element (the same bits at every point),
            # inverted once and broadcast over the points (a view)
            J1 = np.swapaxes(corners, 1, 2) @ dN[0]           # (E, d, d)
            det1, invT1 = det_inv(J1)
            E, nqp, d = len(corners), len(weights), mesh.dim
            self.jac_inv_T_elem = invT1
            self.jac_inv_T = np.broadcast_to(invT1[:, None], (E, nqp, d, d))
            detJ = np.broadcast_to(det1[:, None], (E, nqp))
        else:
            J = np.swapaxes(corners, 1, 2)[:, None] @ dN[None]    # (E, nqp, d, d)
            detJ, self.jac_inv_T = det_inv(J)                     # (E, nqp, d, d)
        self.factor = weights[None, :] * np.abs(detJ)         # (E, nqp)
        self.cell_volume = np.einsum("q,eq->e", weights, np.abs(detJ))
        self.qp_phys = N[None] @ corners                      # (E, nqp, d)
        self.qp_phys_offset = None

    @property
    def origins(self):
        """(E, dim) float64 element origins of a uniform mesh (computed on
        each access: the fast paths never hold them), else None."""
        if not self.mesh.uniform:
            return None
        mesh = self.mesh
        return mesh.lower + mesh.element_multi_index() * mesh.h

    def origins_tensor(self, dtype, device) -> torch.Tensor:
        """(E, dim) element origins lower + multi_index * h of a uniform
        mesh, computed on `device` in float64 (the reference's host
        arithmetic), then cast."""
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

    def x_tensor(self, dtype, device) -> torch.Tensor:
        """(E, nqp, dim) physical quadrature points."""
        if self.mesh.uniform:
            return (self.origins_tensor(dtype, device)[:, None, :]
                    + torch.as_tensor(self.qp_phys_offset, dtype=dtype,
                                      device=device)[None])
        return torch.as_tensor(self.qp_phys, dtype=dtype, device=device)

    def transform_grad(self, ref_grad: np.ndarray) -> np.ndarray:
        """Reference (nqp, nb, d) -> physical gradients (Eb, nqp, nb, d):
        Eb = 1 on a uniform mesh, E else."""
        if self.mesh.uniform:
            return (ref_grad / self.mesh.h)[None]
        # "eqij,qbj->eqbi" as a broadcast matmul
        invT = (self.jac_inv_T_elem[:, None] if self.jac_inv_T_elem is not None
                else self.jac_inv_T)
        return np.swapaxes(invT @ np.swapaxes(ref_grad, 1, 2)[None], 2, 3)

    def jac_inv_T_tensor(self, dtype, device) -> torch.Tensor:
        """jac_inv_T as a tensor: on a simplex mesh the per-element
        inverse expanded over the points (no copy per point)."""
        if self.jac_inv_T_elem is None:
            return torch.as_tensor(self.jac_inv_T, dtype=dtype, device=device)
        E, nqp, d, _ = self.jac_inv_T.shape
        return torch.as_tensor(self.jac_inv_T_elem, dtype=dtype,
                               device=device)[:, None].expand(E, nqp, d, d)


def embed_face_points(qp_face: np.ndarray, axis: int, side: int, dim: int) -> np.ndarray:
    """Embed (nqp, dim-1) face points into the reference cube at face
    (axis, side): coordinate `axis` pinned to `side`, tangential axes in
    increasing order carry the face coordinates."""
    nqp = qp_face.shape[0]
    pts = np.empty((nqp, dim))
    pts[:, axis] = float(side)
    t = 0
    for d in range(dim):
        if d != axis:
            pts[:, d] = qp_face[:, t]
            t += 1
    return pts


class FaceGeometry:
    """Geometry of a group of faces normal to `axis` on a uniform
    structured mesh: one shared normal, one shared face measure."""

    def __init__(self, mesh, axis: int,
                 qp_face: np.ndarray, weights: np.ndarray):
        if not mesh.uniform:
            raise NotImplementedError(
                "FaceGeometry needs a uniform mesh: the faces of a mapped "
                "mesh carry per-face geometry (GridOperator's mapped face "
                "groups), as in the reference")
        self.mesh = mesh
        self.axis = axis
        self.qp_face = qp_face
        self.weights = weights
        h = mesh.h
        tang = [d for d in range(mesh.dim) if d != axis]
        self.measure = float(np.prod(h[tang])) if tang else 1.0
        self.factor = (weights * self.measure)[None, :]       # (1, nqp)
        self.h_normal = np.array([h[axis]])                   # (1,)
