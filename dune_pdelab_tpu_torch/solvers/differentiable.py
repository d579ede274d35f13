"""Differentiable PDE solves: adjoint gradients through stationary solves.

PyTorch port of dune_pdelab_tpu/solvers/differentiable.py. Beyond the C++
reference: PDELab has no sensitivity machinery. `implicit_solve` wraps any
"solve R(x, theta) = 0 for x" routine in a torch.autograd.Function that
implements the implicit function theorem (the adjoint method), so the
gradient of any functional of the solution costs ONE adjoint linear solve:

    dJ/dtheta = -lambda^T dR/dtheta,   (dR/dx)^T lambda = dJ/dx

theta is a tensor or a tuple/dict of tensors (the port's counterpart of the
reference's pytree). The residual's theta-dependence enters through a
LocalOperator factory (`parametric_residual`): coefficients close over the
live theta and flow through assembly, so torch.func.vjp of R gives exact
derivatives. The reference's jax.custom_vjp becomes the Function's
backward: the transposed apply is torch.func.vjp of R in x, the parameter
term torch.func.vjp of R in theta. There is no jit to compose with and no
vmap over parameters (a sweep is a loop).

Forward solves are never differentiated: `forward(theta)` runs under
no_grad. A host driver (NewtonMethod, StationaryLinearProblemSolver) is a
forward as it stands; `opaque_forward` only detaches theta and fixes the
result's dtype and device. On the card the Krylov applies of the forward
and adjoint solves are replayed from a CUDA graph for the length of one
solve (solvers/linear.GraphedApply), bit-equal to the eager applies; the
statistics of the last solves are kept in `f.info`.
"""
from __future__ import annotations

import torch
from torch.func import vjp
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

from dune_pdelab_tpu_torch.assembly.gridoperator import GridOperator
from dune_pdelab_tpu_torch.linalg import krylov
from dune_pdelab_tpu_torch.solvers.linear import GraphedApply
from dune_pdelab_tpu_torch.utils.common import default_float, resolve_device

_KRYLOV = {"cg": krylov.cg, "bicgstab": krylov.bicgstab, "minres": krylov.minres,
           "gmres": krylov.restarted_gmres}


def graphed(apply, like):
    """`apply` replayed from a CUDA graph for one solve on the card
    (GraphedApply), the plain closure on the CPU."""
    return GraphedApply(apply) if like.device.type == "cuda" else apply


def graph_note(A):
    """How a solve's operator ran: 'eager', 'CUDA graph replay', or the
    reason the capture was declined."""
    if not isinstance(A, GraphedApply):
        return "eager"
    return "CUDA graph replay" if A.reason is None else f"eager ({A.reason})"


def operator_cache(space, constraints, go_kwargs):
    """f(lop) -> a GridOperator for `lop`: the first is built, later ones
    share its index maps, geometry and context cache
    (GridOperator.with_operator); nothing theta-dependent is cached."""
    base = []

    def get(lop):
        if not base:
            base.append(GridOperator(space, lop, constraints=constraints, **go_kwargs))
            return base[0]
        return base[0].with_operator(lop)

    return get


def parametric_residual(space, lop_factory, constraints=None, **go_kwargs):
    """Build R(x, theta[, time]) from a LocalOperator factory.

    lop_factory(theta) -> LocalOperator; theta is a tensor or a tuple/dict
    of tensors, and coefficient callables that close over it give exact
    derivatives. The GridOperator's index maps and geometry are built once
    and shared by every call."""
    return _residual(operator_cache(space, constraints, go_kwargs), lop_factory)


def _residual(go_of, lop_factory):
    def R(x, theta, time=0.0):
        return go_of(lop_factory(theta)).residual(x, time)

    return R


def opaque_forward(solve_py, example_x):
    """Wrap a host-side Python solver as a forward solve for
    `implicit_solve`. solve_py(theta) -> x* may hold any Python control flow
    (NewtonMethod, StationaryLinearProblemSolver drivers); it receives theta
    detached and its result (tensor or array) is returned as a tensor of
    example_x's dtype and device, with no graph history."""
    def forward(theta):
        theta = tree_map(lambda t: t.detach() if isinstance(t, torch.Tensor) else t, theta)
        return torch.as_tensor(solve_py(theta), dtype=example_x.dtype,
                               device=example_x.device)
    return forward


def implicit_solve(R, forward, *, constraints=None, x0_fn=None,
                   adjoint_solver="cg", adjoint_tol=1e-12,
                   adjoint_maxiter=10_000, adjoint_precond=None):
    """Differentiable x(theta) with R(x(theta), theta) = 0.

    R(x, theta) -> residual (same size as x); `forward(theta) -> x*` does
    the solve and is never differentiated. The backward pass solves

        (dR/dx)^T lambda = xbar,   thetabar = -(dR/dtheta)^T lambda

    with `adjoint_solver` ('cg' for symmetric operators, 'bicgstab',
    'minres' or 'gmres' otherwise) on the exact transposed linearization.

    Constrained residuals zero their Dirichlet rows, so dR/dx alone is
    singular: pass the `constraints` of the assembly and, for
    theta-dependent Dirichlet data, `x0_fn(theta) -> x0`. The effective
    residual is then R + mask (x - x0(theta)), whose Jacobian
    [[I, 0], [A_fc, A_ff]] is block-triangular: a Krylov solve of
    A_ff^T lambda_f = xbar_f on the free subspace, then the explicit
    back-substitution lambda_c = xbar_c - (A_fc^T lambda_f)_c.

    Returns f(theta) -> x*, differentiable by torch.autograd; f.info holds
    the adjoint solve's SolverStats ('adjoint') and how its operator ran
    ('adjoint_apply')."""
    solver = _KRYLOV[adjoint_solver]
    kw = {} if adjoint_precond is None else {"M": adjoint_precond}
    info = {}

    def thetabar(x, theta, xbar):
        _, vjp_x = vjp(lambda xx: R(xx, theta), x)

        def vjp_r(lam):
            return vjp_x(lam)[0]

        if x.device.type == "cuda":
            # the linearization recomputed inside each apply, so that the
            # whole transposed apply can be captured and replayed
            def vjp_r_apply(lam):
                return vjp(lambda xx: R(xx, theta), x)[1](lam)[0]
        else:
            vjp_r_apply = vjp_r
        if constraints is None:
            A = graphed(vjp_r_apply, x)
            lam, stats = solver(A, xbar, tol=adjoint_tol, maxiter=adjoint_maxiter, **kw)
        else:
            m = constraints.mask_on(x.device)

            def free(v):
                return torch.where(m, 0.0, v)

            # SPD on the free subspace (if A_ff is), identity on the
            # constrained DOFs: R's constrained rows are zero
            A = graphed(lambda lam: free(vjp_r_apply(free(lam))) + torch.where(m, lam, 0.0), x)
            sol, stats = solver(A, free(xbar), tol=adjoint_tol, maxiter=adjoint_maxiter, **kw)
            lam_f = free(sol)
            lam = lam_f + torch.where(m, xbar - vjp_r(lam_f), 0.0)
        info["adjoint"] = stats
        info["adjoint_apply"] = graph_note(A)
        _, vjp_t = vjp(lambda tt: R(x, tt), theta)
        tbar = tree_map(torch.neg, vjp_t(lam)[0])
        if constraints is not None and x0_fn is not None:
            # the Dirichlet rows x_c - x0_c(theta) add (dx0/dtheta)^T lambda_c
            _, vjp_x0 = vjp(x0_fn, theta)
            extra = vjp_x0(torch.where(m, lam, 0.0))[0]
            tbar = tree_map(torch.add, tbar, extra)
        return tbar

    class _Implicit(torch.autograd.Function):
        @staticmethod
        def forward(ctx, spec, *leaves):
            x = forward(tree_unflatten(list(leaves), spec))
            ctx.spec = spec
            ctx.save_for_backward(x, *leaves)
            return x

        @staticmethod
        def backward(ctx, xbar):
            x, *leaves = ctx.saved_tensors
            theta = tree_unflatten([t.detach() for t in leaves], ctx.spec)
            grads, _ = tree_flatten(thetabar(x.detach(), theta, xbar.contiguous()))
            return (None, *grads)

    def f(theta):
        leaves, spec = tree_flatten(theta)
        return _Implicit.apply(spec, *leaves)

    f.info = info
    return f


def _start_vector(space, theta, x0_fn):
    """x0_fn(theta), or zeros in the dtype and on the device of theta's
    first floating tensor (default float and device otherwise)."""
    if x0_fn is not None:
        return x0_fn(theta)
    lead = [t for t in tree_flatten(theta)[0]
            if isinstance(t, torch.Tensor) and t.is_floating_point()]
    if lead:
        return torch.zeros(space.ndofs, dtype=lead[0].dtype, device=lead[0].device)
    return torch.zeros(space.ndofs, dtype=default_float(), device=resolve_device(None))


def differentiable_stationary_solve(space, lop_factory, constraints=None,
                                    x0_fn=None, solver="cg", tol=1e-12,
                                    maxiter=10_000, precond=None,
                                    adjoint_solver=None, **go_kwargs):
    """Differentiable linear stationary solve.

    Forward: the StationaryLinearProblemSolver scheme (one Krylov solve on
    go.jacobian_apply in residual-correction form: J z = r(x0), x = x0 - z;
    stationary/linearproblem.hh:182). x0_fn(theta) -> x0 supplies the
    Dirichlet-interpolated start vector (theta-dependent boundary data
    differentiates too); zeros by default.

    Returns f(theta) -> x, differentiable through `implicit_solve`; f.info
    also holds the forward solve's SolverStats ('forward') and how its
    apply ran ('forward_apply')."""
    go_of = operator_cache(space, constraints, go_kwargs)
    R = _residual(go_of, lop_factory)
    fwd_solver = _KRYLOV[solver]

    def forward(theta):
        go = go_of(lop_factory(theta))
        x0 = _start_vector(space, theta, x0_fn)
        r = go.residual(x0)
        kw = {} if precond is None else {"M": precond}
        A = graphed(lambda p: go.jacobian_apply(x0, p), r)
        z, stats = fwd_solver(A, r, tol=tol, maxiter=maxiter, **kw)
        f.info["forward"] = stats
        f.info["forward_apply"] = graph_note(A)
        return x0 - z

    f = implicit_solve(R, forward, constraints=constraints, x0_fn=x0_fn,
                       adjoint_solver=adjoint_solver or solver,
                       adjoint_tol=tol, adjoint_maxiter=maxiter,
                       adjoint_precond=precond)
    return f
