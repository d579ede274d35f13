"""Local adaptive refinement: estimate -> mark -> refine -> transfer.

PyTorch port of dune_pdelab_tpu/adaptivity/local.py (reference: the
adaptivity cycle on locally refined grids, dune/pdelab/adaptivity/
adaptivity.hh:632,672 adapt_grid = backup -> grid.adapt() -> replay;
hanging nodes from constraints/hangingnode.hh). Each adapt step produces
a NEW mesh and FunctionSpace; the backup/replay cycle collapses to one
interpolation at the new nodal points. Indicators that the reference
computes on the host (`p1_edge_jump_indicator`, the nodal transfers) stay
host numpy; `volume_residual_indicator` runs on the device.
"""
from __future__ import annotations

import itertools
import time

import numpy as np
import torch

from dune_pdelab_tpu_torch.adaptivity.adaptivity import host
from dune_pdelab_tpu_torch.mesh.adaptive import AdaptiveMesh
from dune_pdelab_tpu_torch.mesh.simplex import SimplexMesh
from dune_pdelab_tpu_torch.space.space import FunctionSpace


def _like(v, x_old):
    """Host values as a tensor of x_old's dtype on x_old's device."""
    return torch.as_tensor(v, dtype=x_old.dtype, device=x_old.device)


def evaluate_fe(space, x, pts):
    """Evaluate the FE function (space, x) at physical points (n, dim), a
    host numpy array. Works on AdaptiveMesh (leaf location by lattice
    walk) and on a uniform StructuredMesh. x must be hanging-consistent
    (the solvers return it so)."""
    mesh = space.mesh
    pts = np.atleast_2d(np.asarray(pts, dtype=np.float64))
    xv = host(x)
    dofs = np.asarray(space.element_dofs)
    if isinstance(mesh, AdaptiveMesh):
        elems, ref = mesh.locate(pts)
    else:
        rel = (pts - mesh.lower) / mesh.h
        emi = np.clip(np.floor(rel).astype(np.int64), 0, np.array(mesh.cells) - 1)
        ref = rel - emi
        strides = np.ones(mesh.dim, dtype=np.int64)
        for d in range(1, mesh.dim):
            strides[d] = strides[d - 1] * mesh.cells[d - 1]
        elems = emi @ strides
    vals, _ = space.fem.tabulate(ref)            # (n, nb) at per-point ref
    return np.einsum("nb,nb->n", vals, xv[dofs[elems]])


def volume_residual_indicator(go, problem, x, time=0.0):
    """eta_K^2 = h_K^2 || f + div(A grad u) - b.grad u - c u ||_K^2, the
    volume part of the residual estimator (reference:
    convectiondiffusionfem.hh:359) on axis-aligned cube elements
    (AdaptiveMesh or a uniform mesh). Scalar A only."""
    space = go.space
    if not space.is_leaf:
        raise ValueError("the volume indicator needs a single-leaf space")
    mesh, fem = space.mesh, space.fem
    dim = mesh.dim
    dtype, device = x.dtype, x.device
    if go.cg is not None and go.cg.has_affine:
        x = go.cg.prolong(x)

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    vctx = go._volume_ctx(time, dtype, device)
    tab = vctx.tabs[0]
    u_loc = go.dof_maps[0].gather(x)                   # (E, nloc)
    uq = torch.einsum("qb,eb->eq", tab.phi, u_loc)
    gu = (torch.einsum("qbd,eb->eqd", tab.grad[0], u_loc) if tab.grad.shape[0] == 1
          else torch.einsum("eqbd,eb->eqd", tab.grad, u_loc))
    if isinstance(mesh, AdaptiveMesh):
        h_e = mesh.element_sizes()                     # (E, dim)
    else:
        h_e = np.broadcast_to(mesh.h, (mesh.nelements, dim))
    Hdiag = np.einsum("qbdd->qbd", fem.tabulate_hessian(go.vol_geo.qp_ref))
    lap_basis = torch.einsum("qbd,ed->eqb", t(Hdiag), t(1.0 / h_e ** 2))
    lap = torch.einsum("eqb,eb->eq", lap_basis, u_loc)
    A = t(problem.A(vctx.x))
    Ascal = A if A.ndim <= vctx.x.ndim - 1 else torch.einsum("...ii", A) / dim
    b = t(problem.b(vctx.x))
    rvol = (t(problem.f(vctx.x)) + Ascal * lap
            - torch.sum(torch.broadcast_to(b, vctx.x.shape) * gu, dim=-1)
            - t(problem.c(vctx.x)) * uq)
    return t(h_e.max(axis=1) ** 2) * torch.sum(rvol ** 2 * vctx.factor, dim=-1)


def adapt_local(space_old, x_old, marks, coarsen_marks=None, timings=None):
    """Refine marked elements (2:1-balanced closure), optionally coarsen
    (sibling-complete merges), and transfer the solution by interpolation
    at the new nodal points (reference: adaptivity.hh:632).

    space_old.mesh may be a StructuredMesh (first adapt: converted) or an
    AdaptiveMesh. Refine marks take precedence over coarsen marks.
    `timings`, a dict, receives the host seconds of the refinement (with
    any coarsening), the new space and the transfer. Returns (space_new,
    x_new)."""
    t = {} if timings is None else timings
    t0 = time.perf_counter()
    mesh = space_old.mesh
    if not isinstance(mesh, AdaptiveMesh):
        # same element order (lexicographic) by construction
        mesh = AdaptiveMesh(mesh.lower, mesh.upper, mesh.cells)
    marks = np.asarray(host(marks), dtype=bool)
    if coarsen_marks is not None and np.any(host(coarsen_marks)):
        cm = np.asarray(host(coarsen_marks), dtype=bool) & ~marks
        marked_centers = mesh.element_centers()[marks]
        mesh_c = mesh.coarsen(cm)
        space_c = FunctionSpace(mesh_c, space_old.fem, name=space_old.name)
        x_old = _like(evaluate_fe(space_old, x_old, space_c.dof_coords()), x_old)
        space_old, mesh = space_c, mesh_c
        # refine marks carry over to the (never coarsened) leaves of the
        # new mesh, located by element centre
        marks = np.zeros(mesh.nelements, dtype=bool)
        if len(marked_centers):
            elems, _ = mesh.locate(marked_centers)
            marks[elems] = True
    mesh_new = mesh.refine(marks)
    t1 = time.perf_counter()
    space_new = FunctionSpace(mesh_new, space_old.fem, name=space_old.name)
    t2 = time.perf_counter()
    x_new = _like(evaluate_fe(space_old, x_old, space_new.dof_coords()), x_old)
    t["refine"], t["space"], t["transfer"] = t1 - t0, t2 - t1, time.perf_counter() - t2
    return space_new, x_new


def p1_edge_jump_indicator(space, x, f=None):
    """Facet-jump a-posteriori indicator for P1 on simplex meshes (2D and
    3D), host numpy as in the reference:

        eta_K^2 = h_K^2 ||f||_K^2
                  + (1/2) sum_{F in dK, interior} h_F ||[grad u . n]||_F^2

    (reference: convectiondiffusionfem.hh:359; for P1 the volume Laplacian
    vanishes). Returns a per-element numpy array eta_K^2."""
    mesh = space.mesh
    if not (isinstance(mesh, SimplexMesh) and mesh.dim in (2, 3)):
        raise ValueError("p1_edge_jump_indicator needs a 2D or 3D simplex mesh")
    dim = mesh.dim
    xv = np.asarray(host(x), dtype=np.float64)
    cc = mesh.element_corner_coords()                   # (E, d+1, d)
    uv = xv[np.asarray(space.element_dofs)]             # (E, d+1) P1 nodal
    # constant gradient per cell: solve [p_i - p0]^T g = [u_i - u0]
    Edge = np.stack([cc[:, i] - cc[:, 0] for i in range(1, dim + 1)], axis=1)
    du = np.stack([uv[:, i] - uv[:, 0] for i in range(1, dim + 1)], axis=1)
    grads = np.linalg.solve(Edge, du[..., None])[..., 0]   # (E, d)

    eta2 = np.zeros(mesh.nelements)
    itf = mesh.interior_faces()
    ge = mesh.faces()[0][itf["face"]]                   # (NI, d) vertex ids
    if dim == 2:
        tvec = mesh.vertices[ge[:, 1]] - mesh.vertices[ge[:, 0]]
        measure = np.linalg.norm(tvec, axis=1)          # edge length
        n_e = np.stack([tvec[:, 1], -tvec[:, 0]], axis=1) / measure[:, None]
        h_F = measure
    else:
        e1 = mesh.vertices[ge[:, 1]] - mesh.vertices[ge[:, 0]]
        e2 = mesh.vertices[ge[:, 2]] - mesh.vertices[ge[:, 0]]
        nvec = np.cross(e1, e2)
        dbl = np.linalg.norm(nvec, axis=1)
        measure = 0.5 * dbl                             # face area
        n_e = nvec / dbl[:, None]
        h_F = np.sqrt(measure)
    jump = np.einsum("id,id->i", grads[itf["inside"]] - grads[itf["outside"]], n_e)
    contrib = 0.5 * h_F * jump ** 2 * measure     # ||const||_F^2 = |F| c^2
    np.add.at(eta2, itf["inside"], contrib)
    np.add.at(eta2, itf["outside"], contrib)
    if f is not None:
        vol = np.abs(np.linalg.det(Edge)) / (2.0 if dim == 2 else 6.0)
        hK2 = np.max([np.linalg.norm(cc[:, a] - cc[:, b], axis=1)
                      for a, b in itertools.combinations(range(dim + 1), 2)],
                     axis=0) ** 2
        fc = np.asarray(host(f(mesh.element_centers())), dtype=np.float64)
        eta2 += hK2 * fc ** 2 * vol
    return eta2


def adapt_local_simplex(space_old, x_old, marks, timings=None):
    """Bisect marked cells (conforming closure) and transfer the solution
    by interpolation. P1 uses the exact nodal shortcut (a new vertex is an
    edge midpoint: the mean of its endpoints, resolved in creation order
    for 3D multi-level closure); Pk evaluates the old FE function at the
    new nodal points through the recorded parent cells (children are
    nested, so the parent's inverse affine map locates every new node).
    `timings`, a dict, receives the host seconds of the bisection, the new
    space and the transfer. Returns (space_new, x_new)."""
    mesh = space_old.mesh
    if not isinstance(mesh, SimplexMesh):
        raise ValueError("adapt_local_simplex needs a simplex mesh")
    t = {} if timings is None else timings
    t0 = time.perf_counter()
    mesh_new, (nv_old, mids, ends) = mesh.refine_bisection(host(marks))
    t1 = time.perf_counter()
    space_new = FunctionSpace(mesh_new, space_old.fem, name=space_old.name)
    t["bisection"], t["space"] = t1 - t0, time.perf_counter() - t1
    t0 = time.perf_counter()
    space_new, x_new = _transfer_simplex(space_old, space_new, x_old, nv_old, mids, ends)
    t["transfer"] = time.perf_counter() - t0
    return space_new, x_new


def _transfer_simplex(space_old, space_new, x_old, nv_old, mids, ends):
    """The solution transfer of `adapt_local_simplex`."""
    mesh, mesh_new = space_old.mesh, space_new.mesh
    xv = np.asarray(host(x_old), dtype=np.float64)
    if space_old.fem.degree == 1:
        xnew = np.zeros(space_new.ndofs)
        xnew[:nv_old] = xv
        mids = np.asarray(mids)
        if len(mids):
            for _ in range(64):
                upd = 0.5 * (xnew[ends[:, 0]] + xnew[ends[:, 1]])
                if np.array_equal(upd, xnew[mids]):
                    break
                xnew[mids] = upd
        return space_new, _like(xnew, x_old)

    dim = mesh.dim
    d1 = dim + 1
    ed_new = np.asarray(space_new.element_dofs)
    own = np.empty(space_new.ndofs, dtype=np.int64)
    own[ed_new.reshape(-1)] = np.repeat(np.arange(mesh_new.nelements), ed_new.shape[1])
    pts = space_new.dof_coords()                     # (ndofs, dim)
    par = mesh_new.parent_cells[own]                 # old cell per new dof
    cc = mesh.element_corner_coords()[par]           # (ndofs, d1, dim)
    # the assembler's affine-map convention: xi_i moved by node (d1-1-i)
    J = np.stack([cc[:, d1 - 1 - i] - cc[:, 0] for i in range(dim)], axis=-1)
    xi = np.linalg.solve(J, (pts - cc[:, 0])[..., None])[..., 0]
    vals, _ = space_old.fem.tabulate(xi)             # (ndofs, nb) per point
    xnew = np.einsum("nb,nb->n", vals, xv[np.asarray(space_old.element_dofs)[par]])
    return space_new, _like(xnew, x_old)
