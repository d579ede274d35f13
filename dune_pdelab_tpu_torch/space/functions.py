"""Grid-function norms: evaluate FE solutions at quadrature points, L2 errors.

PyTorch port of `evaluate_at_quadrature` and `l2_difference` of
dune_pdelab_tpu/space/functions.py (reference: the test oracle
dune/pdelab/test/l2difference.hh:15-34). Uniform meshes only,
as the port's VolumeGeometry; `exact` receives the (npts, dim) quadrature
points as a float64 tensor on x's device (the port's callback convention)
and returns a tensor, array or scalar.
"""
from __future__ import annotations

import torch

from dune_pdelab_tpu_torch.assembly.dofmaps import make_leaf_dof_map
from dune_pdelab_tpu_torch.assembly.geometry import VolumeGeometry
from dune_pdelab_tpu_torch.fe.quadrature import quadrature_rule


def evaluate_at_quadrature(space, x, quad_order=None):
    """u_h and grad u_h at volume quadrature points of every element.

    Returns (x_qp (E,nqp,dim) float64, u (E,nqp), gradu (E,nqp,dim),
    factor (1,nqp)).
    """
    mesh = space.mesh
    qo = quad_order if quad_order is not None else 2 * space.fem.degree + 2
    qp, w = quadrature_rule(mesh.geometry_type, mesh.dim, qo)
    geo = VolumeGeometry(mesh, qp, w)
    vals, grads = space.fem.tabulate(qp)
    xq = (geo.origins_tensor(torch.float64, x.device)[:, None, :]
          + torch.as_tensor(geo.qp_phys_offset, device=x.device)[None])
    u_loc = make_leaf_dof_map(space, None, offset=0).gather(x)   # (E, nb)

    def t(a):
        return torch.as_tensor(a, dtype=x.dtype, device=x.device)

    u = torch.einsum("qb,eb->eq", t(vals), u_loc)
    gu = torch.einsum("qbd,eb->eqd", t(geo.transform_grad(grads))[0], u_loc)
    return xq, u, gu, t(geo.factor)


def l2_difference(space, x, exact, quad_order=None):
    """|| u_h - exact ||_L2 (reference: test/l2difference.hh:15-34); real
    for a complex x."""
    xq, u, _, factor = evaluate_at_quadrature(space, x, quad_order)
    ue = torch.as_tensor(exact(xq.reshape(-1, xq.shape[-1])), dtype=x.dtype,
                         device=x.device)
    d = u - torch.broadcast_to(ue.reshape(-1) if ue.ndim else ue,
                               (u.numel(),)).reshape(u.shape)
    return torch.sqrt(torch.real(torch.sum(factor * d * torch.conj(d))))
