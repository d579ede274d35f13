"""Discrete grid functions and norms: evaluate FE solutions, L2 errors.

PyTorch port of dune_pdelab_tpu/space/functions.py (reference:
DiscreteGridFunction, dune/pdelab/gridfunctionspace/
gridfunctionspaceutilities.hh:54, and the test oracles
dune/pdelab/test/l2difference.hh:15-34, l2norm.hh) on uniform, periodic,
mapped and adaptive cube meshes and on simplex meshes (the mapped,
adaptive and simplex ones through VolumeGeometry's per-element `qp_phys`
and gradient transform); `exact` and `exact_grad` receive the
(npts, dim) quadrature points as a float64 tensor on x's device (the
port's callback convention) and return a tensor, array or scalar. Norms
of a complex x are real.
"""
from __future__ import annotations

import numpy as np
import torch

from dune_pdelab_tpu_torch.assembly.dofmaps import make_leaf_dof_map
from dune_pdelab_tpu_torch.assembly.geometry import VolumeGeometry
from dune_pdelab_tpu_torch.fe.quadrature import quadrature_rule


def evaluate_at_quadrature(space, x, quad_order=None, gradient=True):
    """u_h and grad u_h at volume quadrature points of every element.

    Returns (x_qp (E,nqp,dim) float64, u (E,nqp), gradu (E,nqp,dim),
    factor (Eb,nqp)); Eb = 1 on a uniform mesh, E else. gradient=False
    skips the physical gradients (gradu is None): on a simplex mesh they
    cost E*nqp*nb*dim host values.
    """
    mesh = space.mesh
    qo = quad_order if quad_order is not None else 2 * space.fem.degree + 2
    qp, w = quadrature_rule(mesh.geometry_type, mesh.dim, qo)
    geo = VolumeGeometry(mesh, qp, w)
    vals, grads = space.fem.tabulate(qp)
    xq = geo.x_tensor(torch.float64, x.device)
    u_loc = make_leaf_dof_map(space, None, offset=0).gather(x)   # (E, nb)

    def t(a):
        return torch.as_tensor(a, dtype=x.dtype, device=x.device)

    u = torch.einsum("qb,eb->eq", t(vals), u_loc)
    if not gradient:
        return xq, u, None, t(geo.factor)
    gphys = t(geo.transform_grad(grads))
    if gphys.shape[0] == 1:
        gu = torch.einsum("qbd,eb->eqd", gphys[0], u_loc)
    else:
        gu = torch.einsum("eqbd,eb->eqd", gphys, u_loc)
    return xq, u, gu, t(geo.factor)


def l2_difference(space, x, exact, quad_order=None):
    """|| u_h - exact ||_L2 (reference: test/l2difference.hh:15-34); real
    for a complex x."""
    xq, u, _, factor = evaluate_at_quadrature(space, x, quad_order, gradient=False)
    ue = torch.as_tensor(exact(xq.reshape(-1, xq.shape[-1])), dtype=x.dtype,
                         device=x.device)
    d = u - torch.broadcast_to(ue.reshape(-1) if ue.ndim else ue,
                               (u.numel(),)).reshape(u.shape)
    return torch.sqrt(torch.real(torch.sum(factor * d * torch.conj(d))))


def _at_points(v, like, shape):
    """A callback's value as a tensor of x's dtype and device, in `shape`."""
    t = torch.as_tensor(v, dtype=like.dtype, device=like.device)
    return torch.broadcast_to(t.reshape(shape) if t.numel() > 1 else t, shape)


def l2_norm(space, x, quad_order=None):
    """|| u_h ||_L2 (l2norm.hh analog); real for a complex x."""
    _, u, _, factor = evaluate_at_quadrature(space, x, quad_order, gradient=False)
    return torch.sqrt(torch.real(torch.sum(factor * u * torch.conj(u))))


def h1_seminorm_difference(space, x, exact_grad, quad_order=None):
    """| u_h - exact |_H1 given the exact gradient callable (points (npts,
    dim) -> (npts, dim))."""
    xq, _, gu, factor = evaluate_at_quadrature(space, x, quad_order)
    d = gu - _at_points(exact_grad(xq.reshape(-1, xq.shape[-1])), x, gu.shape)
    return torch.sqrt(torch.real(torch.sum(factor * torch.sum(d * torch.conj(d), dim=-1))))


def integrate_grid_function(space, x, quad_order=None):
    """∫ u_h dx (functionutilities.hh integrateGridFunction analog)."""
    _, u, _, factor = evaluate_at_quadrature(space, x, quad_order, gradient=False)
    return torch.sum(factor * u)


def _locate_simplex(mesh, pts, chunk=4096, tol=1e-12):
    """(element, reference coordinates) of every point on a simplex mesh:
    the first element whose barycentric coordinates are all >= -tol (the
    affine map inverted per element). Points outside the mesh raise."""
    corners = mesh.element_corner_coords()                  # (E, d+1, d)
    v0 = corners[:, 0]
    # reference corner j sits at e_{dim-j}: columns of J in that order
    J = np.stack([corners[:, mesh.dim - j] - v0 for j in range(mesh.dim)], axis=2)
    Jinv = np.linalg.inv(J)                                 # (E, d, d)
    elem = np.empty(len(pts), np.int64)
    ref = np.empty_like(pts)
    for s in range(0, len(pts), chunk):
        p = pts[s:s + chunk]
        xi = np.einsum("eij,pej->pei", Jinv, p[:, None, :] - v0[None])  # (p, E, d)
        inside = np.all(xi >= -tol, axis=2) & (xi.sum(axis=2) <= 1 + tol)
        if not np.all(inside.any(axis=1)):
            raise ValueError("a point lies outside the simplex mesh")
        e = np.argmax(inside, axis=1)
        elem[s:s + chunk] = e
        ref[s:s + chunk] = xi[np.arange(len(p)), e]
    return elem, ref


def evaluate_at_points(space, x, pts):
    """u_h at arbitrary points (npts, dim): locate each point's element and
    reference coordinates (lattice arithmetic on a uniform mesh, the leaf
    walk on an AdaptiveMesh, a barycentric search on a simplex mesh; a
    mapped mesh raises), tabulate the basis there (the
    reference's per-point adaptivity._evaluate_on, in one batch). Returns a
    tensor of x's dtype on x's device."""
    mesh = space.mesh
    pts = np.atleast_2d(pts.detach().cpu().numpy() if isinstance(pts, torch.Tensor)
                        else np.asarray(pts, dtype=np.float64))
    if mesh.geometry_type == "simplex":
        elem, ref = _locate_simplex(mesh, pts)
        vals, _ = space.fem.tabulate(ref)                     # (npts, nb)
        dofs = torch.as_tensor(space.element_dofs[elem], device=x.device)
        return torch.sum(torch.as_tensor(vals, dtype=x.dtype, device=x.device)
                         * x[dofs], dim=1)
    if hasattr(mesh, "locate"):                               # AdaptiveMesh
        elem, ref = mesh.locate(pts)
    elif not mesh.uniform:
        raise NotImplementedError("point evaluation on a mapped mesh needs the "
                                  "inverse multilinear map (not in the reference)")
    else:
        rel = (pts - mesh.lower) / mesh.h
        e_mi = np.clip(np.floor(rel).astype(np.int64), 0, np.array(mesh.cells) - 1)
        elem, ref = mesh.element_index(e_mi), rel - e_mi
    vals, _ = space.fem.tabulate(ref)                         # (npts, nb)
    dofs = torch.as_tensor(space.element_dofs[elem], device=x.device)
    return torch.sum(torch.as_tensor(vals, dtype=x.dtype, device=x.device) * x[dofs],
                     dim=1)


class DiscreteGridFunction:
    """Evaluable view of (space, DOF vector): DiscreteGridFunction analog
    (reference: gridfunctionspaceutilities.hh:54) with the arithmetic
    combinators of the reference's function/ directory (product,
    difference, scaled, ...). Point callables take (npts, dim) points and
    return a tensor."""

    def __init__(self, space, x):
        self.space = space
        self.x = x

    def __call__(self, pts):
        return evaluate_at_points(self.space, self.x, pts)

    # -- combinators return plain point-callables ---------------------------
    def __add__(self, other):
        return _combine(self, other, lambda a, b: a + b)

    def __sub__(self, other):
        return _combine(self, other, lambda a, b: a - b)

    def __mul__(self, other):
        return _combine(self, other, lambda a, b: a * b)

    __rmul__ = __mul__

    def squared(self):
        return _combine(self, self, lambda a, b: a * b)

    def l2_norm(self, quad_order=None):
        return l2_norm(self.space, self.x, quad_order)

    def integrate(self, quad_order=None):
        return integrate_grid_function(self.space, self.x, quad_order)


def _combine(f, g, op):
    def h(pts):
        a = torch.as_tensor(f(pts)) if callable(f) else f
        b = torch.as_tensor(g(pts)) if callable(g) else g
        return op(a, b)

    return h
