"""Mimetic finite differences: face-centered element and diffusion operator.

PyTorch port of dune_pdelab_tpu/fe/mimetic.py (reference slot:
dune/pdelab/finiteelementmap/mimeticfem.hh, a FEM over dune-localfunctions'
MimeticLocalFiniteElement with one DOF per cell face; the reference ships no
mimetic local operator, so the scheme is the standard lowest-order mimetic /
hybrid finite-volume construction, consistency plus stabilization, on
uniform structured cube meshes).

`MimeticFEM` carries one scalar DOF per face (the face-centroid value). Its
`tabulate` is the consistent linear reconstruction

    u_h(x) = u_bar + g(u) . (x - x_c),   g(u) = (1/|E|) sum_f |f| u_f n_f,

linear in the face values, so interpolation, values and gradients at
quadrature points and L2 errors go through the generic machinery.
`DiffusionMFD` adds the mimetic stabilization to the consistency term, which
makes the local form SPD and the scheme exact for affine solutions.
"""
from __future__ import annotations

import numpy as np
import torch

from dune_pdelab_tpu_torch.ops.base import LocalOperator, VolumeContext
from dune_pdelab_tpu_torch.ops.convectiondiffusion import at_face_qp
from dune_pdelab_tpu_torch.utils.common import device_key


class MimeticFEM:
    """Face-centered mimetic element on the reference cube [0,1]^d.

    phi_f(x) = 1/(2d) + n_f . (x - 1/2): a partition of unity that
    reproduces affine functions from face-centroid values."""

    geometry = "cube"
    continuity = "Mimetic"
    degree = 1
    ndofs_per_face = 1

    def __init__(self, dim: int):
        self.dim = dim
        self.nbasis = 2 * dim
        # face centers of the reference cube in (axis, side) order, the
        # H(div) face numbering (space/space.py _build_hdiv_map)
        nodes = np.full((2 * dim, dim), 0.5)
        for a in range(dim):
            nodes[2 * a, a] = 0.0
            nodes[2 * a + 1, a] = 1.0
        self.nodes = nodes
        self.interpolation_points = nodes
        self.interpolation_matrix = np.eye(2 * dim)
        self._normals = np.zeros((2 * dim, dim))
        for a in range(dim):
            self._normals[2 * a, a] = -1.0
            self._normals[2 * a + 1, a] = 1.0

    def tabulate(self, points):
        points = np.atleast_2d(points)
        vals = 1.0 / (2 * self.dim) + (points - 0.5) @ self._normals.T  # (npts, nb)
        grads = np.broadcast_to(self._normals.T[None],
                                (len(points), self.dim, self.nbasis))
        return vals, np.ascontiguousarray(np.swapaxes(grads, 1, 2))

    def __repr__(self):
        return f"MimeticFEM(dim={self.dim})"


class DiffusionMFD(LocalOperator):
    """Mimetic diffusion -div(K grad u) = f on uniform cube meshes.

    alpha_volume = consistency (the exact-gradient term through the linear
    reconstruction) + stabilization sum_f sigma_f s_f(u) s_f(v), with
    s_f(u) = u_f - u_h(x_f), the reconstruction's defect at the face
    centroid, and sigma_f = K |f| / d_f. Exact for affine u (s_f = 0)."""

    is_linear = True
    quadrature_factor = 2

    def __init__(self, problem):
        self.problem = problem
        self._stab = None          # host (nb, nb) matrix I - phi(face centers)
        self._stab_dev = {}        # its copies per dtype and device

    def _stab_data(self, nb, dim, dtype, device):
        if self._stab is None:
            fem = MimeticFEM(dim)
            self._stab = np.eye(nb) - fem.tabulate(fem.nodes)[0]   # s = S u
        key = (dtype, device_key(device))
        if key not in self._stab_dev:
            self._stab_dev[key] = torch.as_tensor(self._stab, dtype=dtype, device=device)
        return self._stab_dev[key]

    def alpha_volume(self, ctx: VolumeContext, u):
        tab = ctx.tab
        dim = ctx.x.shape[-1]
        nb = 2 * dim
        jinv = ctx.jac_inv_T
        if tuple(jinv.shape[:2]) != (1, 1):        # uniform: (1, 1, d, d)
            raise NotImplementedError("DiffusionMFD: uniform cube meshes only")
        K = self.problem.A(ctx.x)
        if isinstance(K, torch.Tensor) and K.ndim > ctx.x.ndim - 1:   # tensor: trace / d
            K = torch.einsum("...ii->...", K) / dim
        Kq = torch.broadcast_to(at_face_qp(K, ctx, u.dtype), ctx.x.shape[:-1])  # (E, nqp)
        # consistency: int K grad u_h . grad v_h
        gu = self.gradient_at_qp(tab, u)
        r = self.accumulate_gradient(tab, ctx.factor, Kq[..., None] * gu)
        # stabilization: sigma_f = K |f| / d_f, d_f = h_a / 2 and
        # |f| = |E| / h_a, so sigma_f = 2 K |E| / h_a^2
        S = self._stab_data(nb, dim, u.dtype, u.device)
        s_u = torch.einsum("fb,eb->ef", S, u)
        Kc = torch.mean(Kq, dim=-1)                               # (E,)
        h = 1.0 / torch.diagonal(jinv[0, 0])                      # (dim,) spacings
        h2 = (h * h)[:, None].expand(dim, 2).reshape(1, nb)     # per face (axis, side)
        sigma = 2.0 * ctx.cell_volume.reshape(-1, 1) / h2
        return r + torch.einsum("fb,ef->eb", S, Kc[:, None] * sigma * s_u)

    def lambda_volume(self, ctx: VolumeContext):
        f = at_face_qp(self.problem.f(ctx.x), ctx, ctx.factor.dtype)
        return self.accumulate_value(ctx.tab, ctx.factor, -f)
