"""A-posteriori error estimation, marking, and solution transfer.

PyTorch port of dune_pdelab_tpu/adaptivity/adaptivity.py (reference:
dune/pdelab/adaptivity/adaptivity.hh: error_fraction :863,
element_fraction :915, mark_grid :1029, adapt_grid :632 backup/replay; the
residual estimator of localoperator/convectiondiffusionfem.hh:359). The
estimator runs on the device; marking is host numpy, as in the reference.
`adapt_uniform` re-sets-up at a finer uniform resolution and transfers the
solution by conforming interpolation.
"""
from __future__ import annotations

import numpy as np
import torch

from dune_pdelab_tpu_torch.assembly.geometry import FaceGeometry, embed_face_points
from dune_pdelab_tpu_torch.fe.quadrature import quadrature_rule
from dune_pdelab_tpu_torch.ops.convectiondiffusion import apply_tensor


def host(v) -> np.ndarray:
    """A tensor, array or list as a host numpy array."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _coef(v, like):
    return torch.as_tensor(v, dtype=like.dtype, device=like.device)


def residual_estimator_convectiondiffusion(go, problem, x, time=0.0):
    """Classical residual-type eta^2 per element for
    -div(A grad u) + b.grad u + c u = f:

    eta_K^2 = h_K^2 ||f + div(A grad u_h) - b.grad u_h - c u_h||_K^2
              + 1/2 h_F sum_faces ||[A grad u_h . n]||_F^2

    (reference: convectiondiffusionfem.hh:359). Needs a single-leaf Qk
    space on a uniform mesh: the face term builds the uniform
    FaceGeometry, which raises on a mapped mesh, as in the reference. The
    face sums add into distinct elements per axis (`index_add`)."""
    space = go.space
    if not space.is_leaf:
        raise ValueError("the residual estimator needs a single-leaf space")
    mesh, fem = space.mesh, space.fem
    dim = mesh.dim
    dtype, device = x.dtype, x.device
    vctx = go._volume_ctx(time, dtype, device)

    # --- volume residual with second derivatives ---------------------------
    h = mesh.h
    Htrace = np.einsum("qbdd->qb", fem.tabulate_hessian(go.vol_geo.qp_ref)
                       / (h[None, None, :, None] * h[None, None, None, :]))
    u_loc = go.dof_maps[0].gather(x)                   # (E, nloc)
    tab = vctx.tabs[0]
    uq = torch.einsum("qb,eb->eq", tab.phi, u_loc)
    gu = (torch.einsum("qbd,eb->eqd", tab.grad[0], u_loc) if tab.grad.shape[0] == 1
          else torch.einsum("eqbd,eb->eqd", tab.grad, u_loc))
    lap = torch.einsum("qb,eb->eq", _coef(Htrace, x), u_loc)
    A = _coef(problem.A(vctx.x), x)
    Ascal = A if A.ndim <= vctx.x.ndim - 1 else torch.einsum("...ii", A) / dim
    b = _coef(problem.b(vctx.x), x)
    rvol = (_coef(problem.f(vctx.x), x) + Ascal * lap
            - torch.sum(torch.broadcast_to(b, vctx.x.shape) * gu, dim=-1)
            - _coef(problem.c(vctx.x), x) * uq)
    hK = float(np.max(h))
    eta2 = torch.broadcast_to(hK ** 2 * torch.sum(rvol ** 2 * vctx.factor, dim=-1),
                              (mesh.nelements,))

    # --- face jumps ---------------------------------------------------------
    itf = mesh.interior_faces()
    qpf, wf = quadrature_rule("cube", dim - 1, go.qorder)
    dofs = torch.as_tensor(np.asarray(space.element_dofs, np.int64), device=device)
    for a in range(dim):
        sel = np.nonzero(itf["axis"] == a)[0]
        if len(sel) == 0:
            continue
        ins, outs = itf["inside"][sel], itf["outside"][sel]
        fgeo = FaceGeometry(mesh, a, qpf, wf)
        pts_in = embed_face_points(qpf, a, 1, dim)
        pts_out = embed_face_points(qpf, a, 0, dim)
        gin = _coef(fem.tabulate(pts_in)[1] / h, x)    # physical gradients
        gout = _coef(fem.tabulate(pts_out)[1] / h, x)
        ins_t = torch.as_tensor(ins, device=device)
        outs_t = torch.as_tensor(outs, device=device)
        gui = torch.einsum("qbd,eb->eqd", gin, x[dofs[ins_t]])
        guo = torch.einsum("qbd,eb->eqd", gout, x[dofs[outs_t]])
        # [A grad u . n] with the volume coefficient A at the face points
        origins = (mesh.lower + mesh.element_multi_index()[ins] * mesh.h)
        xf = _coef(origins[:, None, :] + (pts_in * mesh.h)[None], x)
        Af = _coef(problem.A(xf), x)
        jump = (apply_tensor(Af, gui) - apply_tensor(Af, guo))[..., a]
        face_eta = 0.5 * float(h[a]) * torch.sum(jump ** 2 * _coef(fgeo.factor, x), dim=-1)
        eta2 = eta2.index_add(0, ins_t, face_eta).index_add(0, outs_t, face_eta)
    return eta2


def error_fraction(eta2, alpha: float):
    """Refinement threshold capturing fraction `alpha` of the total error
    (Doerfler marking; reference: adaptivity.hh:863 error_fraction)."""
    e = np.sort(host(eta2))[::-1]
    cum = np.cumsum(e)
    total = cum[-1]
    if total <= 0:
        return np.inf
    idx = int(np.searchsorted(cum, alpha * total))
    return float(e[min(idx, len(e) - 1)])


def element_fraction(eta2, alpha: float):
    """Threshold marking the largest-eta `alpha` fraction of elements
    (reference: adaptivity.hh:915)."""
    e = np.sort(host(eta2))[::-1]
    idx = max(0, min(len(e) - 1, int(alpha * len(e)) - 1))
    return float(e[idx])


def mark_elements(eta2, refine_threshold, coarsen_threshold=0.0):
    """(refine_mask, coarsen_mask) per element (mark_grid analog :1029)."""
    e = host(eta2)
    return e >= refine_threshold, e <= coarsen_threshold


def adapt_uniform(space_old, x_old, factor: int = 2):
    """Refine the mesh uniformly and transfer the solution by conforming
    interpolation (the backup -> adapt -> replay cycle, reference:
    adaptivity.hh:523-710 GridAdaptor, collapsed to one prolongation).
    Returns (space_new, x_new)."""
    from dune_pdelab_tpu_torch.linalg.multigrid import build_prolongation
    from dune_pdelab_tpu_torch.space.space import FunctionSpace

    mesh_new = space_old.mesh.refine(factor)
    space_new = FunctionSpace(mesh_new, space_old.fem, name=space_old.name)
    if factor == 2:
        idx, w = build_prolongation(space_old, space_new)
        idx = torch.as_tensor(np.asarray(idx, np.int64), device=x_old.device)
        x_new = (torch.as_tensor(w, dtype=x_old.dtype, device=x_old.device)
                 * x_old[idx]).sum(1)
    else:
        x_new = space_new.interpolate(
            lambda pts: _evaluate_on(space_old, x_old, host(pts)),
            dtype=x_old.dtype, device=x_old.device)
    return space_new, x_new


def _evaluate_on(space, x, pts):
    """Pointwise evaluation of a discrete function at arbitrary points of a
    uniform mesh: locate elements and reference coordinates, evaluate the
    basis (host numpy, as the reference's per-point loop; one batch)."""
    mesh = space.mesh
    pts = np.atleast_2d(pts)
    rel = (pts - mesh.lower) / mesh.h
    e_mi = np.clip(np.floor(rel).astype(np.int64), 0, np.array(mesh.cells) - 1)
    xi = rel - e_mi
    strides = np.ones(mesh.dim, dtype=np.int64)
    for d in range(1, mesh.dim):
        strides[d] = strides[d - 1] * mesh.cells[d - 1]
    vals, _ = space.fem.tabulate(xi)
    return np.einsum("nb,nb->n", vals, host(x)[np.asarray(space.element_dofs)[e_mi @ strides]])
