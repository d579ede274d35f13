"""Adjoint-differentiable solves and rollouts of the port against the JAX
package and central finite differences (fp64, CPU).

Tolerances: gradients against jax.grad of the JAX package on the same
theta 1e-8 relative (ROADMAP's target for slice 13c); against central
finite differences the reference tests' bounds (1e-5 relative, step 1e-6);
the rollout against the OneStepMethod driver 1e-9 (the reference's bound);
checkpointed against plain gradients rtol 1e-9. The reference's gated test
(test_linear_adjoint_gradient_vs_fd), its slow-tier opaque-Newton and
theta-dependent-Dirichlet tests at their sizes, its parameter sweep (as a
loop: the port has no vmap) and the three tests of
tests/test_differentiable_time.py (checkpoint_steps=True in place of jit)
run on the port. The Stokes viscosity gradient (slow tier in the
reference) runs on the card in chip_smoke phase 14e.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import dune_pdelab_tpu as jpt
import dune_pdelab_tpu_torch as tpt
from dune_pdelab_tpu.instationary import differentiable_theta_rollout as j_rollout
from dune_pdelab_tpu.ops import ConvectionDiffusionFEM as JCDFEM
from dune_pdelab_tpu.ops import ConvectionDiffusionProblem as JProblem
from dune_pdelab_tpu.ops import L2 as JL2, ScaledOperator as JScaled
from dune_pdelab_tpu import solvers as jsolvers
from dune_pdelab_tpu.solvers import differentiable_stationary_solve as j_dss
from dune_pdelab_tpu_torch.instationary import (
    OneStepMethod, differentiable_theta_rollout, one_step_theta,
)
from dune_pdelab_tpu_torch.ops import (
    BCType, ConvectionDiffusionFEM, ConvectionDiffusionProblem, L2, ScaledOperator,
)
from dune_pdelab_tpu_torch import solvers as tsolvers
from dune_pdelab_tpu_torch.solvers import (
    SEQ_CG_Jacobi, differentiable_stationary_solve, parametric_residual,
)
from dune_pdelab_tpu_torch.utils.common import set_default_device

pytestmark = pytest.mark.fast
torch.set_num_threads(1)
set_default_device("cpu")
F64 = torch.float64


def _rel(a, b):
    a, b = np.asarray(a, dtype=float), np.asarray(b, dtype=float)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _m(x):
    return torch if isinstance(x, torch.Tensor) else jnp


def _eye(x):
    return (torch.eye(x.shape[-1], dtype=x.dtype) if isinstance(x, torch.Tensor)
            else jnp.eye(x.shape[-1], dtype=x.dtype))


def _space(pkg, n):
    mod = tpt if pkg == "torch" else jpt
    V = mod.FunctionSpace(mod.StructuredMesh([0, 0], [1, 1], (n, n)), mod.QkFEM(1, 2))
    return V, mod.constraints(True, V)


def _factory(pkg):
    """tests/test_differentiable.py _make_factory: A = (t0 + t1 x + t2 y) I, f = 1."""
    Base, Op = ((ConvectionDiffusionProblem, ConvectionDiffusionFEM) if pkg == "torch"
                else (JProblem, JCDFEM))

    def factory(theta):
        class P(Base):
            def A(self, x):
                a = theta[0] + theta[1] * x[..., 0] + theta[2] * x[..., 1]
                return a[..., None, None] * _eye(x)

            def f(self, x):
                return 1.0 + 0.0 * x[..., 0]
        return Op(P())
    return factory


def _grad(f, theta0, loss):
    th = torch.tensor(theta0, dtype=F64, requires_grad=True)
    loss(f(th)).backward()
    return th.grad.numpy()


def _fd_grad(value, theta, eps=1e-6):
    g = np.zeros(len(theta))
    for i in range(len(theta)):
        e = np.zeros(len(theta))
        e[i] = eps
        g[i] = (value(theta + e) - value(theta - e)) / (2 * eps)
    return g


# ---------------------------------------------- tests/test_differentiable.py
def test_linear_adjoint_gradient_vs_fd_and_jax():
    """test_linear_adjoint_gradient_vs_fd (10^2, CG to 1e-13): the
    directional FD agrees with the adjoint gradient to 1e-5, and the
    gradient equals jax.grad of the JAX package's solve to 1e-8."""
    V, cons = _space("torch", 10)
    f = differentiable_stationary_solve(V, _factory("torch"), constraints=cons,
                                        solver="cg", tol=1e-13)
    x_t = np.random.default_rng(0).standard_normal(V.ndofs) * 0.01

    def loss(x):
        return torch.sum((x - torch.from_numpy(x_t)) ** 2)

    theta0 = np.array([1.0, 0.4, -0.3])
    g = _grad(f, theta0, loss)
    v, eps = np.array([0.6, -0.3, 0.4]), 1e-6
    with torch.no_grad():
        fd = (float(loss(f(torch.from_numpy(theta0 + eps * v))))
              - float(loss(f(torch.from_numpy(theta0 - eps * v))))) / (2 * eps)
    assert abs(fd - g @ v) / abs(fd) < 1e-5, (fd, g @ v)
    assert f.info["adjoint"].converged and f.info["adjoint_apply"] == "eager"
    Vj, cj = _space("jax", 10)
    fj = j_dss(Vj, _factory("jax"), constraints=cj, solver="cg", tol=1e-13)
    gj = jax.grad(lambda t: jnp.sum((fj(t) - jnp.asarray(x_t)) ** 2))(jnp.asarray(theta0))
    assert _rel(g, gj) < 1e-8


def _opaque_newton(pkg):
    """tests/test_differentiable.py test_opaque_newton_forward_gradient at
    8^2 in `pkg`: f(theta) through a NewtonMethod forward wrapped by
    opaque_forward (a pure_callback in the JAX package)."""
    mod, sol = (tpt, tsolvers) if pkg == "torch" else (jpt, jsolvers)
    V, cons = _space(pkg, 8)
    Base, Op = ((ConvectionDiffusionProblem, ConvectionDiffusionFEM) if pkg == "torch"
                else (JProblem, JCDFEM))

    def factory(theta):
        class P(Base):
            def A(self, x):
                return (theta[0] + 0 * x[..., 0])[..., None, None] * _eye(x)

            def c(self, x):
                return theta[1] + 0 * x[..., 0]

            def f(self, x):
                return 1.0 + 0.0 * x[..., 0]
        return Op(P())

    R = sol.parametric_residual(V, factory, constraints=cons)
    zero = V.zero(dtype=F64) if pkg == "torch" else V.zero()

    def solve_py(theta):
        go = mod.GridOperator(V, factory(theta if pkg == "torch" else jnp.asarray(theta)),
                              constraints=cons)
        x = sol.NewtonMethod(go, sol.SEQ_CG_Jacobi(), reduction=1e-13, verbose=0).apply(zero)
        return x if pkg == "torch" else np.asarray(x)

    return sol.implicit_solve(R, sol.opaque_forward(solve_py, zero), constraints=cons,
                              adjoint_solver="cg", adjoint_tol=1e-13)


def test_opaque_newton_forward_fd():
    """test_opaque_newton_forward_gradient (8^2): a NewtonMethod forward
    wrapped by opaque_forward; the adjoint gradient matches central FD
    (1e-5) and jax.grad of the JAX package's opaque forward (1e-8)."""
    f = _opaque_newton("torch")

    def loss(x):
        return torch.sum(x ** 2)

    theta0 = np.array([1.0, 0.5])
    g = _grad(f, theta0, loss)
    with torch.no_grad():
        fd = _fd_grad(lambda t: float(loss(f(torch.from_numpy(t)))), theta0)
    assert np.abs(g - fd).max() / np.abs(fd).max() < 1e-5, (g, fd)
    fj = _opaque_newton("jax")
    gj = jax.grad(lambda t: jnp.sum(fj(t) ** 2))(jnp.asarray(theta0))
    assert _rel(g, gj) < 1e-8


def test_dirichlet_data_gradient_vs_fd():
    """test_theta_dependent_dirichlet_data (8^2): g = theta[3] (x + y);
    the x0_fn term of the adjoint carries its derivative (central FD in
    every component, 1e-5; jax.grad of the JAX package's solve with the
    same x0_fn, 1e-8)."""
    V, cons = _space("torch", 8)
    xg_unit = V.interpolate(lambda q: q[..., 0] + q[..., 1], dtype=F64)

    def x0_fn(theta):
        return torch.where(cons.mask, theta[3] * xg_unit, 0.0)

    f = differentiable_stationary_solve(V, _factory("torch"), constraints=cons,
                                        x0_fn=x0_fn, tol=1e-13)

    def loss(x):
        return torch.sum(x ** 2)

    theta0 = np.array([1.0, 0.2, -0.1, 0.7])
    g = _grad(f, theta0, loss)
    with torch.no_grad():
        fd = _fd_grad(lambda t: float(loss(f(torch.from_numpy(t)))), theta0)
    assert np.abs(g - fd).max() / np.abs(fd).max() < 1e-5, (g, fd)
    Vj, cj = _space("jax", 8)
    xg_j = Vj.interpolate(lambda q: q[..., 0] + q[..., 1])
    fj = j_dss(Vj, _factory("jax"), constraints=cj, tol=1e-13,
               x0_fn=lambda t: jnp.where(cj.mask, t[3] * xg_j, 0.0))
    gj = jax.grad(lambda t: jnp.sum(fj(t) ** 2))(jnp.asarray(theta0))
    assert _rel(g, gj) < 1e-8


def test_parameter_sweep_loop_matches_jax():
    """test_vmap_parameter_sweep as a loop (6^2) over three parameter sets:
    each set's loss and gradient equal a fresh solve's (1e-14; the
    operator cache keeps nothing theta-dependent), the first set's equal
    the JAX package's jax.value_and_grad (the loss 1e-10, its gradient
    1e-8)."""
    def factories(pkg):
        Base, Op = ((ConvectionDiffusionProblem, ConvectionDiffusionFEM) if pkg == "torch"
                    else (JProblem, JCDFEM))

        def factory(theta):
            class P(Base):
                def A(self, x):
                    return (theta[0] + theta[1] * x[..., 0])[..., None, None] * _eye(x)

                def f(self, x):
                    return 1.0 + 0.0 * x[..., 0]
            return Op(P())
        return factory

    V, cons = _space("torch", 6)
    Vj, cj = _space("jax", 6)
    f = differentiable_stationary_solve(V, factories("torch"), constraints=cons, tol=1e-12)
    fj = j_dss(Vj, factories("jax"), constraints=cj, tol=1e-12)
    thetas = ([1.0, 0.0], [1.5, 0.3], [0.7, -0.2])
    sweep = []
    for theta in thetas:
        th = torch.tensor(theta, dtype=F64, requires_grad=True)
        loss = torch.sum(f(th) ** 2)
        loss.backward()
        sweep.append((float(loss), th.grad.numpy()))
    for theta, (val, grad) in zip(thetas, sweep):
        fresh = differentiable_stationary_solve(V, factories("torch"), constraints=cons, tol=1e-12)
        th = torch.tensor(theta, dtype=F64, requires_grad=True)
        loss = torch.sum(fresh(th) ** 2)
        loss.backward()
        assert _rel(val, float(loss)) < 1e-14 and _rel(grad, th.grad) < 1e-14
    vj, gj = jax.value_and_grad(lambda t: jnp.sum(fj(t) ** 2))(jnp.asarray(thetas[0]))
    assert _rel(sweep[0][0], float(vj)) < 1e-10
    assert _rel(sweep[0][1], gj) < 1e-8


def test_coefficient_through_cached_context_keeps_gradient():
    """The GridOperator of parametric_residual keeps its geometry and
    context cache across calls; a coefficient evaluated from theta inside
    the kernels (a tensor diffusion coefficient through apply_tensor, a
    Neumann flux through at_face_qp) must still carry the live theta: after
    calls at other parameters, the vjp in theta is nonzero and equals the
    central FD of R."""
    V = tpt.FunctionSpace(tpt.StructuredMesh([0, 0], [1, 1], (5, 5)), tpt.QkFEM(1, 2))
    bc = lambda x: np.asarray(x)[..., 0] < 1e-9        # Dirichlet on x = 0 only
    cons = tpt.constraints(bc, V)

    def factory(theta):
        class P(ConvectionDiffusionProblem):
            def A(self, x):
                return theta[0]

            def bctype(self, x):
                return torch.where(x[..., 0] < 1e-9, BCType.DIRICHLET, BCType.NEUMANN)

            def j(self, x):
                return theta[1] * x[..., 1]
        return ConvectionDiffusionFEM(P())

    R = parametric_residual(V, factory, constraints=cons)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(V.ndofs))
    w = torch.from_numpy(np.random.default_rng(5).standard_normal(V.ndofs))
    for other in ([2.0, -1.0], [0.3, 0.1]):                 # warm the caches
        R(x, torch.tensor(other, dtype=F64))
    theta0 = np.array([1.3, 0.8])
    th = torch.tensor(theta0, requires_grad=True)
    torch.sum(w * R(x, th)).backward()
    with torch.no_grad():
        fd = _fd_grad(lambda t: float(torch.sum(w * R(x, torch.from_numpy(t)))), theta0)
    assert np.all(np.abs(th.grad.numpy()) > 1e-3), th.grad
    assert _rel(th.grad, fd) < 1e-7
    go = tpt.GridOperator(V, factory(th), constraints=cons)
    assert go.with_operator(factory(th))._ctx_cache is go._ctx_cache
    with pytest.raises(ValueError, match="kernels or quadrature order"):
        go.with_operator(L2())


@pytest.mark.parametrize("kind", ["q1-neumann", "rt0-mixed"])
def test_reverse_mode_is_the_transpose(kind):
    """The adjoint's transposed apply, the vjp of the residual, against its
    J.v: <w, J v> = <J^T w, v> to 1e-13 relative, through the C0 boundary
    face groups' IndexDofMap scatters (compact transpose maps) and an
    H(div) leaf's volume map."""
    from torch.func import jvp, vjp

    from dune_pdelab_tpu_torch.fe import P0FEM
    from dune_pdelab_tpu_torch.fe.hdiv import RT0Cube
    from dune_pdelab_tpu_torch.ops import DiffusionMixed

    mesh = tpt.StructuredMesh([0, 0], [1, 1], (5, 4))
    if kind == "q1-neumann":
        class P(ConvectionDiffusionProblem):
            def A(self, x):
                return 1.0 + x[..., 0] * x[..., 1]

            def bctype(self, x):
                m = torch if isinstance(x, torch.Tensor) else np
                return m.where(x[..., 1] < 1e-9, BCType.DIRICHLET, BCType.OUTFLOW)

            def b(self, x):
                return torch.stack([1.0 + 0 * x[..., 0], 0.5 + 0 * x[..., 0]], -1)

        V = tpt.FunctionSpace(mesh, tpt.QkFEM(1, 2))
        go = tpt.GridOperator(V, ConvectionDiffusionFEM(P()),
                              constraints=tpt.constraints(P().dirichlet_bctype(), V))
    else:
        V = tpt.CompositeSpace(tpt.FunctionSpace(mesh, RT0Cube(2)), tpt.FunctionSpace(mesh, P0FEM(2)))
        go = tpt.GridOperator(V, DiffusionMixed(ConvectionDiffusionProblem()))
    rng = np.random.default_rng(11)
    x, v, w = (torch.from_numpy(rng.standard_normal(V.ndofs)) for _ in range(3))
    _, jv = jvp(go.residual, (x,), (v,))
    _, pull = vjp(go.residual, x)
    lhs, rhs = float(w @ jv), float(pull(w)[0] @ v)
    assert abs(lhs - rhs) / abs(lhs) < 1e-13


# ---------------------------------------- tests/test_differentiable_time.py
def _heat(pkg):
    """tests/test_differentiable_time.py _setup at 8^2."""
    V, cons = _space(pkg, 8)
    Base, Op = ((ConvectionDiffusionProblem, ConvectionDiffusionFEM) if pkg == "torch"
                else (JProblem, JCDFEM))

    def factory(params):
        class P(Base):
            def A(self, x):
                return params[0][..., None, None] * _eye(x) + 0.0 * x[..., :1, None]

            def f(self, x):
                m = _m(x)
                return params[1] * m.sin(np.pi * x[..., 0]) * m.sin(np.pi * x[..., 1])
        return Op(P())
    return V, cons, factory


def _sine_x0(V, cons):
    x0 = V.interpolate(lambda q: np.sin(np.pi * np.asarray(q)[..., 0])
                       * np.sin(np.pi * np.asarray(q)[..., 1]), dtype=F64)
    return torch.where(cons.mask, 0.0, x0)


def test_rollout_equals_onestep_driver():
    """test_rollout_matches_onestep_driver: the Crank-Nicolson rollout equals
    OneStepMethod(one_step_theta(0.5)) to 1e-9 (dt 0.01, 6 steps)."""
    V, cons, factory = _heat("torch")
    params = torch.tensor([1.0, 5.0], dtype=F64)
    x0 = _sine_x0(V, cons)
    roll = differentiable_theta_rollout(V, factory, cons, theta=0.5, tol=1e-13)
    xT = roll(x0, params, 0.01, 6)
    osm = OneStepMethod(one_step_theta(0.5), tpt.GridOperator(V, factory(params), constraints=cons),
                        tpt.GridOperator(V, L2(), constraints=cons), SEQ_CG_Jacobi(),
                        pdesolver="linear", reduction=1e-13)
    x, t = x0, 0.0
    for _ in range(6):
        x = osm.apply(t, 0.01, x)
        t += 0.01
    assert float((xT - x).abs().max()) < 1e-9


def test_rollout_gradients_vs_fd_and_jax():
    """test_rollout_gradient_vs_fd (CN, dt 0.02, 5 steps): the parameter
    gradient (diffusivity, source amplitude) and a random direction of the
    initial-condition gradient against central FD (1e-5), both against
    jax.grad of the JAX package's rollout (1e-8)."""
    V, cons, factory = _heat("torch")
    roll = differentiable_theta_rollout(V, factory, cons, theta=0.5, tol=1e-13)
    x0 = _sine_x0(V, cons)

    def loss(p, x):
        return torch.sum(roll(x, p, 0.02, 5) ** 2)

    p0 = np.array([0.8, 3.0])
    p = torch.tensor(p0, requires_grad=True)
    xx = x0.clone().requires_grad_(True)
    loss(p, xx).backward()
    eps = 1e-6
    with torch.no_grad():
        fd = _fd_grad(lambda t: float(loss(torch.from_numpy(t), x0)), p0, eps)
        v = torch.where(cons.mask, 0.0, torch.from_numpy(
            np.random.default_rng(3).standard_normal(V.ndofs)))
        fdx = (float(loss(p.detach(), x0 + eps * v)) - float(loss(p.detach(), x0 - eps * v))) / (2 * eps)
    assert np.all(np.abs(p.grad.numpy() - fd) / np.abs(fd) < 1e-5), (p.grad, fd)
    assert abs(fdx - float(xx.grad @ v)) / abs(fdx) < 1e-5
    assert all(kind in ("step", "adjoint") for kind, _, _ in roll.stats)
    Vj, cj, fj = _heat("jax")
    rj = j_rollout(Vj, fj, cj, theta=0.5, tol=1e-13)
    gp, gx = jax.grad(lambda a, b: jnp.sum(rj(b, a, 0.02, 5) ** 2), argnums=(0, 1))(
        jnp.asarray(p0), jnp.asarray(x0.numpy()))
    assert _rel(p.grad, gp) < 1e-8
    assert _rel(xx.grad, gx) < 1e-8


def test_rollout_checkpointed_same_gradient():
    """test_rollout_checkpointed_and_jitted with checkpoint_steps=True in
    place of jit (implicit Euler, 4 steps): the same gradient, rtol 1e-9."""
    V, cons, factory = _heat("torch")
    x0 = torch.where(cons.mask, 0.0, V.interpolate(
        lambda q: np.asarray(q)[..., 0] * (1 - np.asarray(q)[..., 0]), dtype=F64))
    grads = []
    for cp in (False, True):
        roll = differentiable_theta_rollout(V, factory, cons, theta=1.0, tol=1e-13,
                                            checkpoint_steps=cp)
        p = torch.tensor([1.0, 1.0], dtype=F64, requires_grad=True)
        torch.sum(roll(x0, p, 0.02, 4) ** 2).backward()
        grads.append(p.grad.numpy())
    assert np.allclose(grads[0], grads[1], rtol=1e-9, atol=0.0)


@pytest.mark.parametrize("solver", ["cg", "bicgstab"])
def test_rollout_operator_term(solver):
    """The step operator M(params) + dt theta A(params) depends on the
    parameters: with a heat capacity c in the mass (c dx/dt - div(k grad x)
    = f), c enters only the operator, so its whole gradient is the
    -lambda^T (d op/d c) delta term. Against central FD (1e-5), with the
    symmetric (CG) and the transposed (vjp, BiCGStab) adjoint; the CG case
    also against jax.grad of the JAX package (1e-8). The reference cannot
    differentiate its rollout with a non-symmetric solver
    (lax.custom_linear_solve gets no transpose_solve)."""
    V, cons, factory = _heat("torch")
    x0 = _sine_x0(V, cons)
    roll = differentiable_theta_rollout(V, factory, cons, theta=0.5, tol=1e-13, solver=solver,
                                        mass_factory=lambda p: ScaledOperator(L2(), p[2]))

    def loss(p):
        return torch.sum(roll(x0, p, 0.02, 4) ** 2)

    p0 = np.array([0.8, 3.0, 1.7])
    p = torch.tensor(p0, requires_grad=True)
    loss(p).backward()
    with torch.no_grad():
        fd = _fd_grad(lambda t: float(loss(torch.from_numpy(t))), p0)
    assert abs(p.grad[2]) > 1e-3 * np.abs(fd).max()
    assert np.all(np.abs(p.grad.numpy() - fd) / np.abs(fd) < 1e-5), (p.grad, fd)
    if solver != "cg":
        return
    Vj, cj, fj = _heat("jax")
    rj = j_rollout(Vj, fj, cj, theta=0.5, tol=1e-13, solver=solver,
                   mass_factory=lambda q: JScaled(JL2(), q[2]))
    gj = jax.grad(lambda q: jnp.sum(rj(jnp.asarray(x0.numpy()), q, 0.02, 4) ** 2))(jnp.asarray(p0))
    assert _rel(p.grad, gj) < 1e-8
