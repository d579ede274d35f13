"""Complex values through the port, against the JAX package.

  * a 30x30 Hermitian positive-definite system through cg, bicgstab, minres
    and restarted_gmres to 1e-10: converged, the same solution as the JAX
    package's (1e-9), the same iteration counts (CG within one: it stops
    at a defect that the summation order of the matvec moves across the
    target, see test_hermitian_system_matches_jax);
  * every Krylov solver takes the reference's `dot=` argument and uses it;
  * the complex Helmholtz problem of tests/test_complex.py at 16^2 and
    32^2 cells with BiCGStab and GMRES (Jacobi): order > 1.8, L2 errors
    equal to the JAX package's within 1e-8 relative;
  * complex interpolation stays complex128 and equals the JAX package's;
    l2_difference of a complex vector is real;
  * compile_stencil declines a complex operator, with no ComplexWarning.
"""
import warnings

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import dune_pdelab_tpu as jpt
import dune_pdelab_tpu_torch as tpt
from dune_pdelab_tpu.linalg import krylov as jk
from dune_pdelab_tpu.ops.base import LocalOperator as JLocalOperator
from dune_pdelab_tpu.solvers import LinearSolverBackend as JBackend
from dune_pdelab_tpu.space.functions import l2_difference as j_l2
from dune_pdelab_tpu_torch.assembly.stencil import compile_stencil
from dune_pdelab_tpu_torch.linalg import krylov as tk
from dune_pdelab_tpu_torch.ops.base import LocalOperator as TLocalOperator
from dune_pdelab_tpu_torch.solvers import LinearSolverBackend as TBackend
from dune_pdelab_tpu_torch.space.functions import l2_difference as t_l2
from dune_pdelab_tpu_torch.utils.common import set_default_device

pytestmark = pytest.mark.fast
torch.set_num_threads(1)
set_default_device("cpu")

KAPPA2 = 10.0 + 4.0j          # tests/test_complex.py
AMP = 1.0 + 0.5j
SOLVERS = ["cg", "bicgstab", "minres", "restarted_gmres"]


def _hermitian():
    """30x30 Hermitian positive definite M M^H + 30 I and a complex b."""
    rng = np.random.default_rng(0)
    M = rng.standard_normal((30, 30)) + 1j * rng.standard_normal((30, 30))
    A = M @ M.conj().T + 30 * np.eye(30)
    b = rng.standard_normal(30) + 1j * rng.standard_normal(30)
    return A, b


@pytest.mark.parametrize("name", SOLVERS)
def test_hermitian_system_matches_jax(name):
    A, b = _hermitian()
    xj, sj = getattr(jk, name)(lambda z: jnp.asarray(A) @ z, jnp.asarray(b), tol=1e-10)
    At = torch.as_tensor(A)
    x, s = getattr(tk, name)(lambda z: At @ z, torch.as_tensor(b), tol=1e-10)
    assert x.dtype == torch.complex128 and bool(s.converged) and bool(sj.converged)
    assert np.linalg.norm(A @ x.numpy() - b) / np.linalg.norm(b) < 1e-9
    assert np.abs(x.numpy() - np.asarray(xj)).max() < 1e-9 * np.abs(np.asarray(xj)).max()
    # The JAX package: 24 / 17 / 25 / 24 iterations. CG's defect after 24
    # steps is 9.4e-11 of the first here and 1.10e-10 in the port; with the
    # matvec summed in other orders it spans 8.5e-11 to 2.8e-10 (in both
    # packages), so CG's count is held to one step.
    assert abs(s.iterations - int(sj.iterations)) <= (1 if name == "cg" else 0)


@pytest.mark.parametrize("name", SOLVERS + ["richardson_loop"])
def test_solvers_take_dot(name):
    A, b = _hermitian()
    A = A / 200 if name == "richardson_loop" else A  # a contraction for Richardson
    At = torch.as_tensor(A)
    calls = []

    def dot(u, v):
        calls.append(1)
        return torch.vdot(u, v)
    x, s = getattr(tk, name)(lambda z: At @ z, torch.as_tensor(b), tol=1e-10, dot=dot,
                             maxiter=2000)
    x0, s0 = getattr(tk, name)(lambda z: At @ z, torch.as_tensor(b), tol=1e-10, maxiter=2000)
    assert calls and bool(s.converged)
    assert s.iterations == s0.iterations and torch.equal(x, x0)


def _u_exact(p):
    p = np.asarray(p)
    return (np.sin(np.pi * p[:, 0]) * np.sin(np.pi * p[:, 1]) + p[:, 0]) * AMP


class JHelmholtz(JLocalOperator):
    """tests/test_complex.py's Helmholtz: -lap u - kappa^2 u = f."""

    is_linear = True

    def alpha_volume(self, ctx, u):
        tab = ctx.tab
        return (self.accumulate_gradient(tab, ctx.factor, self.gradient_at_qp(tab, u))
                - self.accumulate_value(tab, ctx.factor, KAPPA2 * self.value_at_qp(tab, u)))

    def lambda_volume(self, ctx):
        s = jnp.sin(jnp.pi * ctx.x[..., 0]) * jnp.sin(jnp.pi * ctx.x[..., 1])
        f = 2 * jnp.pi**2 * s * AMP - KAPPA2 * (s + ctx.x[..., 0]) * AMP
        return self.accumulate_value(ctx.tab, ctx.factor, -f)


class THelmholtz(TLocalOperator):
    """The same operator on the port's protocol."""

    is_linear = True

    def alpha_volume(self, ctx, u):
        tab = ctx.tab
        return (self.accumulate_gradient(tab, ctx.factor, self.gradient_at_qp(tab, u))
                - self.accumulate_value(tab, ctx.factor, KAPPA2 * self.value_at_qp(tab, u)))

    def lambda_volume(self, ctx):
        s = torch.sin(torch.pi * ctx.x[..., 0]) * torch.sin(torch.pi * ctx.x[..., 1])
        f = 2 * torch.pi**2 * s * AMP - KAPPA2 * (s + ctx.x[..., 0]) * AMP
        return self.accumulate_value(ctx.tab, ctx.factor, -f)


def _space(pkg, n):
    return pkg.FunctionSpace(pkg.StructuredMesh([0, 0], [1, 1], (n, n)), pkg.QkFEM(1, 2))


def _solve_jax(n, solver):
    V = _space(jpt, n)
    cgm = jpt.constraints(True, V)
    go = jpt.GridOperator(V, JHelmholtz(), constraints=cgm)
    g = jpt.interpolate_dirichlet(_u_exact, V, cgm, V.zero()).astype(jnp.complex128)
    ls = JBackend(solver=solver, precond="jacobi", maxiter=20000, restart=60)
    z, stats = ls.solve(go, g, go.residual(g), 1e-12)
    return float(j_l2(V, g - z, _u_exact)), int(stats.iterations)


def _solve_port(n, solver):
    V = _space(tpt, n)
    cgm = tpt.constraints(True, V)
    go = tpt.GridOperator(V, THelmholtz(), constraints=cgm)
    g = tpt.interpolate_dirichlet(_u_exact, V, cgm, V.zero(torch.float64))
    assert g.dtype == torch.complex128
    ls = TBackend(solver=solver, precond="jacobi", maxiter=20000, restart=60)
    z, stats = ls.solve(go, g, go.residual(g), 1e-12)
    x = g - z
    assert x.dtype == torch.complex128 and bool(stats.converged) and stats.iterations > 1
    return float(t_l2(V, x, _u_exact)), stats.iterations


@pytest.mark.parametrize("solver", ["bicgstab", "gmres"])
def test_helmholtz_matches_jax(solver):
    errs = []
    for n in (16, 32):
        err, _ = _solve_port(n, solver)
        err_j, _ = _solve_jax(n, solver)
        assert abs(err - err_j) <= 1e-8 * err_j, (n, err, err_j)
        errs.append(err)
    assert np.log2(errs[0] / errs[1]) > 1.8, errs


def test_complex_interpolation_matches_jax():
    Vj, Vt = _space(jpt, 8), _space(tpt, 8)
    xj = np.asarray(Vj.interpolate(_u_exact))
    xt = Vt.interpolate(_u_exact)
    assert xt.dtype == torch.complex128 and xj.dtype == np.complex128
    assert np.abs(xt.numpy() - xj).max() < 1e-15
    cj, ct = jpt.constraints(True, Vj), tpt.constraints(True, Vt)
    gj = jpt.interpolate_dirichlet(_u_exact, Vj, cj, Vj.zero())
    gt = tpt.interpolate_dirichlet(_u_exact, Vt, ct, Vt.zero(torch.float64))
    assert gt.dtype == torch.complex128
    assert np.abs(gt.numpy().imag).max() == pytest.approx(0.5)
    assert np.abs(gt.numpy() - np.asarray(gj)).max() < 1e-15


def test_l2_difference_of_complex_vector_is_real():
    Vj, Vt = _space(jpt, 8), _space(tpt, 8)
    zero = lambda p: np.zeros(len(np.asarray(p)))   # noqa: E731
    xt = Vt.interpolate(lambda q: np.asarray(q)[:, 0] * (1.0 + 1.0j))
    xj = Vj.interpolate(lambda q: np.asarray(q)[:, 0] * (1.0 + 1.0j))
    nt = t_l2(Vt, xt, zero)
    assert not nt.is_complex()
    # ||(1+i) x||^2 = 2 ||x||^2, and || x ||_L2 on [0,1]^2 is 1/sqrt(3)
    assert abs(float(nt) - np.sqrt(2.0 / 3.0)) < 1e-10
    assert abs(float(nt) - float(j_l2(Vj, xj, zero))) < 1e-13


def test_compile_stencil_declines_complex_operator():
    V = _space(tpt, 8)
    go = tpt.GridOperator(V, THelmholtz(), constraints=tpt.constraints(True, V))
    with warnings.catch_warnings():
        warnings.simplefilter("error", np.exceptions.ComplexWarning)
        assert compile_stencil(go, torch.zeros(V.ndofs, dtype=torch.complex128)) is None
