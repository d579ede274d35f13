"""Differentiable time integration: a one-step theta scheme under autograd.

PyTorch port of dune_pdelab_tpu/instationary/differentiable.py. The
OneStepMethod driver (instationary/onestep.py) adapts dt and keeps
statistics on the host; this module is the linear-problem path as a plain
loop that torch.autograd differentiates:

    M (x_{n+1} - x_n) + dt [ theta R_s(x_{n+1}, t_{n+1})
                             + (1-theta) R_s(x_n, t_n) ] = 0

in residual-correction form (x_{n+1} = x_n + delta, delta = 0 on Dirichlet
DOFs, so static boundary values ride x_n):

    (M + dt*theta*A) delta = -dt [ theta R_s(x_n, t_{n+1})
                                   + (1-theta) R_s(x_n, t_n) ]

Each step's solve is a torch.autograd.Function (the reference's
lax.custom_linear_solve): its backward is ONE transposed step solve, never
a backward pass through Krylov iterations, and since the step operator
op = M(params) + dt*theta*A(params) depends on the parameters, the
parameter gradient carries -lambda^T (d op/d params) delta besides the
right-hand side's term (torch.func.vjp of params -> op_params(delta)). The
gradient of a terminal functional is the exact discrete adjoint, in the
parameters and in the initial condition.

No reference analog: PDELab's instationary stack (implicitonestep.hh,
onestepparameter.hh) has no sensitivity machinery. Restrictions as in the
reference: linear spatial operator, fixed dt, single-stage theta schemes
(explicit/implicit Euler, Crank-Nicolson), time-independent Dirichlet
data. `checkpoint_steps=True` recomputes each step on the backward pass
(torch.utils.checkpoint, non-reentrant) instead of keeping its saved
tensors; the reference's jax.checkpoint.
"""
from __future__ import annotations

import torch
from torch.func import vjp
from torch.utils.checkpoint import checkpoint
from torch.utils._pytree import tree_flatten, tree_unflatten

from dune_pdelab_tpu_torch.ops.l2 import L2
from dune_pdelab_tpu_torch.solvers.differentiable import (
    _KRYLOV, graph_note, graphed, operator_cache,
)


def differentiable_theta_rollout(space, spatial_factory, constraints=None,
                                 *, mass_factory=None, theta=0.5,
                                 solver="cg", tol=1e-12, maxiter=10_000,
                                 checkpoint_steps=False, **go_kwargs):
    """Build rollout(x0, params, dt, nsteps, t0=0.0) -> x(t0 + nsteps*dt).

    spatial_factory(params) -> LocalOperator of the (linear) spatial
    residual R_s; mass_factory(params) -> temporal LocalOperator (default:
    the unit L2 mass, l2.hh:149). theta: 0 explicit Euler, 1 implicit
    Euler, 0.5 Crank-Nicolson. params is a tensor or a tuple/dict of
    tensors; the rollout is differentiable in x0 and params.
    rollout.stats lists the SolverStats of every step solve of the last
    call (forward, then adjoint and recomputed ones) as (kind, stats,
    how the apply ran)."""
    krysolve = _KRYLOV[solver]
    symmetric = solver in ("cg", "minres")
    mass_factory = mass_factory or (lambda params: L2())
    spatial_of = operator_cache(space, constraints, go_kwargs)
    mass_of = operator_cache(space, constraints, go_kwargs)

    def rollout(x0, params, dt, nsteps, t0=0.0):
        leaves, spec = tree_flatten(params)
        zeros = torch.zeros_like(x0, requires_grad=False)
        stats = rollout.stats = []

        def step_operator(p):
            """v -> (M + dt*theta*A) v; jacobian_apply is the identity on
            Dirichlet rows for both, so op is (1 + dt*theta) I there and the
            zero right-hand side keeps delta = 0 on them."""
            go_s, go_m = spatial_of(spatial_factory(p)), mass_of(mass_factory(p))
            return lambda v: go_m.jacobian_apply(zeros, v) + dt * theta * go_s.jacobian_apply(zeros, v)

        # the step operator is fixed for the whole rollout: its forward and
        # transposed applies are captured once (on the card) and replayed by
        # every step solve, the recomputed ones of checkpoint_steps included
        op = step_operator(tree_unflatten([t.detach() for t in leaves], spec))
        A = graphed(op, x0)
        if symmetric:
            A_t = A
        else:
            # op is linear: its vjp at any point is the transpose
            A_t = graphed(lambda lam: vjp(op, zeros)[1](lam)[0], x0)

        def solve(kind, A, b):
            z, st = krysolve(A, b, tol=tol, maxiter=maxiter)
            stats.append((kind, st, graph_note(A)))
            return z

        class _StepSolve(torch.autograd.Function):
            @staticmethod
            def forward(ctx, rhs, *pl):
                delta = solve("step", A, rhs)
                ctx.save_for_backward(delta, *pl)
                return delta

            @staticmethod
            def backward(ctx, dbar):
                delta, *pl = ctx.saved_tensors
                lam = solve("adjoint", A_t, dbar.contiguous())
                grads = [None] * len(pl)
                if any(ctx.needs_input_grad[1:]):
                    _, vjp_p = vjp(lambda q: step_operator(tree_unflatten(list(q), spec))(delta),
                                   tuple(t.detach() for t in pl))
                    grads = [None if g is None else -g for g in vjp_p(lam)[0]]
                return (lam, *grads)

        def step(x, t, *pl):
            go_s = spatial_of(spatial_factory(tree_unflatten(list(pl), spec)))
            rhs = -dt * (theta * go_s.residual(x, t + dt) + (1.0 - theta) * go_s.residual(x, t))
            return x + _StepSolve.apply(rhs, *pl)

        x = x0
        for n in range(nsteps):
            t = t0 + dt * n
            if checkpoint_steps:
                x = checkpoint(step, x, t, *leaves, use_reentrant=False)
            else:
                x = step(x, t, *leaves)
        return x

    rollout.stats = []
    return rollout
