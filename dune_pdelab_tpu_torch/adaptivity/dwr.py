"""Goal-oriented (dual-weighted-residual) error estimation.

PyTorch port of dune_pdelab_tpu/adaptivity/dwr.py. The reference's
adaptivity stack (dune/pdelab/adaptivity/adaptivity.hh) has only
energy-norm estimators; for a goal functional J,

    J(u) - J(u_h)  ~  - r(u_h)(z)  =  - sum_K r_K(u_h)(w),
    w = z - I_h z,

with z the adjoint solution in an enriched space (same mesh, higher order)
and I_h the interpolation onto the primal space. The per-element
contributions come from `GridOperator.weighted_element_residuals`; the
adjoint solve is one Krylov solve of the transposed linearization
(torch.func.vjp of the residual).
"""
from __future__ import annotations

import numpy as np
import torch
from torch.func import grad, vjp

from dune_pdelab_tpu_torch.linalg import krylov
from dune_pdelab_tpu_torch.linalg.multigrid import transpose_map
from dune_pdelab_tpu_torch.utils.common import device_key


def space_transfer(space_from, space_to):
    """Nodal transfer between two leaf spaces on the same mesh.

    Returns apply(u_from) -> u_to with u_to|_K = M_to @ (u_from at the
    target element's interpolation points): the exact embedding for nested
    spaces (Q_p into Q_{p+1}), nodal interpolation otherwise. A DOF shared
    by several elements receives equal values from each (continuous
    inputs); the reference's `.at[].set` keeps one of them in an
    unspecified order, here the element of lowest index writes it (a
    gather through the transpose map's first slot), so the result is the
    same on every call."""
    vals, _ = space_from.fem.tabulate(space_to.fem.interpolation_points)
    T = np.asarray(space_to.fem.interpolation_matrix) @ vals   # (nb_to, nb_from)
    dofs_from = np.asarray(space_from.element_dofs, np.int64)
    dofs_to = np.asarray(space_to.element_dofs, np.int64)
    n_to = space_to.ndofs
    cache = {}

    def tensors(u):
        key = (u.dtype, device_key(u.device))
        if key not in cache:
            dt = torch.as_tensor(dofs_to.reshape(-1, 1), device=u.device)
            ridx, _ = transpose_map(dt, torch.ones(dt.shape, dtype=torch.float64,
                                                   device=u.device), n_to)
            cache[key] = (torch.as_tensor(T, dtype=u.dtype, device=u.device),
                          torch.as_tensor(dofs_from, device=u.device), ridx[:, 0])
        return cache[key]

    def apply(u):
        Tt, df, first = tensors(u)
        loc = torch.einsum("ib,eb->ei", Tt, u[df])
        return loc.reshape(-1)[first]

    return apply


def dwr_indicators(go, go_rich, x, goal, *, solver="cg", tol=1e-12,
                   maxiter=10_000, time=0.0):
    """Goal-oriented error indicators for the primal solution x of `go`.

    go_rich discretizes the SAME problem on an enriched leaf space (same
    mesh; e.g. Q_{p+1}) with its own constraints; goal(u_rich) -> scalar
    tensor is any differentiable functional. Returns (eta, estimate):
      eta      (nelements,) nonnegative refinement indicators |eta_K|
      estimate signed float sum_K eta_K ~ J(u) - J(u_h)
    One adjoint Krylov solve in the rich space per call ("cg" for
    symmetric operators, else "bicgstab"/"minres"/"gmres")."""
    krysolve = {"cg": krylov.cg, "bicgstab": krylov.bicgstab,
                "minres": krylov.minres, "gmres": krylov.restarted_gmres}[solver]
    embed = space_transfer(go.space, go_rich.space)
    proj = space_transfer(go_rich.space, go.space)
    xr = embed(x)

    gbar = grad(goal)(xr)
    _, vjp_x = vjp(lambda u: go_rich.residual(u, time), xr)

    def vjpR(lam):
        return vjp_x(lam)[0]

    if go_rich.cg is not None:
        m = go_rich.cg.mask_on(xr.device)

        def free(v):
            return torch.where(m, 0.0, v)

        def At(lam):
            return free(vjpR(free(lam))) + torch.where(m, lam, 0.0)

        z, _ = krysolve(At, free(gbar), tol=tol, maxiter=maxiter)
        z = free(z)
    else:
        z, _ = krysolve(vjpR, gbar, tol=tol, maxiter=maxiter)

    w = z - embed(proj(z))
    eta_signed = go_rich.weighted_element_residuals(xr, w, time)
    # J(u) - J(u_h) ~ -r(u_h)(z): the residual convention here is
    # r(u)(v) = a(u, v) - l(v), adjoint a(v, z) = J'(v)
    return torch.abs(eta_signed), -float(torch.sum(eta_signed))
