"""Parity of the port's nonlinear solve path with the JAX package (fp64).

  * NewtonMethod on the -lap u + u^3 = f problem of
    examples/03_nonlinear_newton.py at 16^2: the JAX package's iteration
    count, the defect of every step to 1e-10 relative (plus 1e-12 of the
    first defect, the rounding floor of the last steps) and the solution
    to 1e-10; the assemblies `reassemble_threshold` counts (counterpart of
    tests/test_solver_semantics.py:48): every step at 0, one at 1.0 (the
    chord method), each as in the JAX package; from_parameters through a
    ParameterTree read from INI text; NewtonError when it cannot converge;
  * LinearSolverBackend(reuse=...): a nonlinear operator's assembled
    matrix and Jacobi diagonal are kept under reuse=True and rebuilt at a
    new linearization point otherwise;
  * NonlinearConvectionDiffusionFEM: residual and J.v to 1e-12 relative
    (nodal w, v(u), q(u), f(u), a Neumann face);
  * assemble_ell_direct of a nonlinear operator against the JAX one and
    against colored probing at a random linearization point (counterpart
    of tests/test_ell_direct.py:57), 1e-12.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

import dune_pdelab_tpu as jpt
import dune_pdelab_tpu_torch as tpt
from dune_pdelab_tpu.assembly.ell import assemble_ell_direct as j_direct
from dune_pdelab_tpu.ops.base import LocalOperator as JLocalOperator
from dune_pdelab_tpu.ops.convectiondiffusion import BCType as JBCType
from dune_pdelab_tpu.ops.nonlinearconvectiondiffusion import (
    NonlinearConvectionDiffusionFEM as JNCD,
    NonlinearConvectionDiffusionProblem as JNCDProblem)
from dune_pdelab_tpu.solvers import NewtonMethod as JNewton
from dune_pdelab_tpu.solvers import SEQ_CG_Jacobi as J_CG_Jacobi
from dune_pdelab_tpu.utils.config import ParameterTree as JParameterTree
from dune_pdelab_tpu_torch.assembly.ell import assemble_ell, assemble_ell_direct
from dune_pdelab_tpu_torch.ops import BCType, LocalOperator
from dune_pdelab_tpu_torch.ops import NonlinearConvectionDiffusionFEM as TNCD
from dune_pdelab_tpu_torch.ops import NonlinearConvectionDiffusionProblem as TNCDProblem
from dune_pdelab_tpu_torch.solvers import LinearSolverBackend, SEQ_CG_Jacobi
from dune_pdelab_tpu_torch.solvers.newton import NewtonError, NewtonMethod
from dune_pdelab_tpu_torch.utils.common import set_default_device
from dune_pdelab_tpu_torch.utils.config import ParameterTree

pytestmark = pytest.mark.fast
torch.set_num_threads(1)
set_default_device("cpu")
F64 = torch.float64
PI = np.pi


def u_exact(p):
    return np.sin(PI * p[:, 0]) * np.sin(PI * p[:, 1]) + 0.5


class JNonlinearPoisson(JLocalOperator):
    """examples/03_nonlinear_newton.py."""

    def alpha_volume(self, ctx, u):
        tab = ctx.tab
        return (self.accumulate_gradient(tab, ctx.factor, self.gradient_at_qp(tab, u))
                + self.accumulate_value(tab, ctx.factor, self.value_at_qp(tab, u) ** 3))

    def lambda_volume(self, ctx):
        s = jnp.sin(jnp.pi * ctx.x[..., 0]) * jnp.sin(jnp.pi * ctx.x[..., 1])
        f = 2 * jnp.pi ** 2 * s + (s + 0.5) ** 3
        return self.accumulate_value(ctx.tab, ctx.factor, -f)


class TNonlinearPoisson(LocalOperator):
    """examples/03_nonlinear_newton.py on the port."""

    def alpha_volume(self, ctx, u):
        tab = ctx.tab
        return (self.accumulate_gradient(tab, ctx.factor, self.gradient_at_qp(tab, u))
                + self.accumulate_value(tab, ctx.factor, self.value_at_qp(tab, u) ** 3))

    def lambda_volume(self, ctx):
        s = torch.sin(PI * ctx.x[..., 0]) * torch.sin(PI * ctx.x[..., 1])
        f = 2 * PI ** 2 * s + (s + 0.5) ** 3
        return self.accumulate_value(ctx.tab, ctx.factor, -f)


def _recording(newton):
    """Record the defect after every step (the line search's result)."""
    defects = []
    orig = newton._line_search

    def rec(*a):
        out = orig(*a)
        defects.append(out[1])
        return out

    newton._line_search = rec
    return defects


@pytest.fixture(scope="module")
def poisson3():
    n = 16
    jV = jpt.FunctionSpace(jpt.StructuredMesh([0, 0], [1, 1], (n, n)), jpt.QkFEM(1, 2))
    jcg = jpt.constraints(True, jV)
    jgo = jpt.GridOperator(jV, JNonlinearPoisson(), constraints=jcg)
    jx0 = jpt.interpolate_dirichlet(u_exact, jV, jcg, jV.zero())
    V = tpt.FunctionSpace(tpt.StructuredMesh([0, 0], [1, 1], (n, n)), tpt.QkFEM(1, 2))
    cgm = tpt.constraints(True, V)
    go = tpt.GridOperator(V, TNonlinearPoisson(), constraints=cgm)
    x0 = tpt.interpolate_dirichlet(lambda p: u_exact(p.numpy()), V, cgm, V.zero(F64))
    return jgo, jx0, go, x0


@pytest.mark.parametrize("threshold,line_search", [(0.0, "hackbusch_reusken"),
                                                   (1.0, "none")])
def test_newton_steps_match_jax(poisson3, threshold, line_search):
    jgo, jx0, go, x0 = poisson3
    kw = dict(reduction=1e-10, verbose=0, reassemble_threshold=threshold,
              line_search=line_search, max_iterations=60)
    jn = JNewton(jgo, J_CG_Jacobi(), **kw)
    jdefects = _recording(jn)
    xj = jn.apply(jx0)
    tn = NewtonMethod(go, SEQ_CG_Jacobi(), **kw)
    tdefects = _recording(tn)
    x = tn.apply(x0)
    res, jres = tn.result, jn.result
    assert res.converged and res.iterations == jres.iterations
    assert res.assemblies == jres.assemblies
    assert res.assemblies == (res.iterations if threshold == 0.0 else 1)
    assert res.linear_solver_iterations == jres.linear_solver_iterations
    # each step's defect to 1e-10 relative; near the end the defects reach
    # the rounding floor of a residual norm, so 1e-12 of the first defect
    # is added as an absolute term
    assert res.first_defect == pytest.approx(jres.first_defect, rel=1e-12)
    assert np.allclose(tdefects, jdefects, rtol=1e-10, atol=1e-12 * jres.first_defect)
    assert np.abs(x.numpy() - np.asarray(xj)).max() <= 1e-10 * np.abs(np.asarray(xj)).max()


def test_newton_from_parameters_and_failure(poisson3):
    _, _, go, x0 = poisson3
    ini = """
    # newton settings
    [newton]
    reduction = 1e-10
    max_iterations = 1
    reassemble_threshold = 0.5
    line_search = none
    verbose = 0
    """
    tree, jtree = ParameterTree.from_ini(ini), JParameterTree.from_ini(ini)
    assert tree.to_dict() == jtree.to_dict()
    sub = tree.sub("newton")
    assert sub.get("max_iterations", 20, int) == 1 and sub.get("absent", 3) == 3
    tn = NewtonMethod.from_parameters(go, SEQ_CG_Jacobi(), sub)
    assert (tn.reduction, tn.max_iterations, tn.reassemble_threshold, tn.line_search,
            tn.verbose) == (1e-10, 1, 0.5, "none", 0)
    with pytest.raises(NewtonError, match="did not converge in 1"):
        tn.apply(x0)
    assert tn.result.iterations == 1 and not tn.result.converged


def test_backend_reuse_keeps_nonlinear_setup(poisson3):
    _, _, go, x0 = poisson3
    b = go.residual(x0)
    for mf in (True, False):
        ls = LinearSolverBackend(solver="cg", precond="jacobi", matrix_free=mf)
        ls.solve(go, x0, b, 1e-6)
        key = (id(go), "diag", F64, torch.device("cpu"))
        d0 = ls._setup_cache[key]
        mat0 = ls._setup_cache.get((id(go), "matval"))
        ls.solve(go, x0 + 1.0, b, 1e-6, reuse=True)     # keeps J(x0)
        assert ls._setup_cache[key] is d0
        assert ls._setup_cache.get((id(go), "matval")) is mat0
        ls.solve(go, x0 + 1.0, b, 1e-6)                 # relinearises
        d1 = ls._setup_cache[key]
        assert d1 is not d0 and not torch.equal(d1, d0)
        assert torch.equal(d1, go.jacobian_diagonal(x0 + 1.0))
        if not mf:
            assert ls._setup_cache[(id(go), "matval")] is not mat0


class JNCDP(JNCDProblem):
    def w(self, x, u):
        return u + 0.2 * u ** 3

    def v(self, x, u):
        return 1.0 + 0.5 * u * u

    def q(self, x, u):
        return jnp.stack([0.3 * u * u, -0.1 * u], axis=-1)

    def f(self, x, u):
        return jnp.sin(x[..., 0]) - u

    def D(self, x):
        return 1.0 + x[..., 0] * x[..., 1]

    def bctype(self, x):
        return jnp.where(x[..., 0] > 1 - 1e-12, JBCType.NEUMANN, JBCType.DIRICHLET)

    def j(self, x):
        return 0.7 * x[..., 1]


class TNCDP(TNCDProblem):
    def w(self, x, u):
        return u + 0.2 * u ** 3

    def v(self, x, u):
        return 1.0 + 0.5 * u * u

    def q(self, x, u):
        return torch.stack([0.3 * u * u, -0.1 * u], dim=-1)

    def f(self, x, u):
        return torch.sin(x[..., 0]) - u

    def D(self, x):
        return 1.0 + x[..., 0] * x[..., 1]

    def bctype(self, x):
        x = torch.as_tensor(x)
        return torch.where(x[..., 0] > 1 - 1e-12, BCType.NEUMANN, BCType.DIRICHLET)

    def j(self, x):
        return 0.7 * x[..., 1]


def test_nonlinear_convection_diffusion_matches_jax():
    n, k = 5, 2
    jV = jpt.FunctionSpace(jpt.StructuredMesh([0, 0], [1, 1], (n, n)), jpt.QkFEM(k, 2))
    V = tpt.FunctionSpace(tpt.StructuredMesh([0, 0], [1, 1], (n, n)), tpt.QkFEM(k, 2))
    jp, tp = JNCDP(), TNCDP()
    jgo = jpt.GridOperator(jV, JNCD(jp), constraints=jpt.constraints(jp.dirichlet_bctype(), jV))
    go = tpt.GridOperator(V, TNCD(tp), constraints=tpt.constraints(
        lambda x: tp.dirichlet_bctype()(x), V))
    rng = np.random.default_rng(13)
    x, z = rng.standard_normal(V.ndofs), rng.standard_normal(V.ndofs)
    tx, tz = torch.from_numpy(x), torch.from_numpy(z)
    for want, got in ((jgo.residual(jnp.asarray(x)), go.residual(tx)),
                      (jgo.jacobian_apply(jnp.asarray(x), jnp.asarray(z)),
                       go.jacobian_apply(tx, tz))):
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= 1e-12 * np.abs(want).max()


class JNP(JNCDProblem):
    def v(self, x, u):
        return 1.0 + u * u

    def f(self, x, u):
        return jnp.ones(x.shape[:-1], x.dtype)


class TNP(TNCDProblem):
    def v(self, x, u):
        return 1.0 + u * u

    def f(self, x, u):
        return 1.0


@pytest.mark.parametrize("dim,n,k", [(2, 10, 1), (2, 6, 2), (3, 4, 1)])
def test_nonlinear_ell_direct_matches_jax_and_probing(dim, n, k):
    lo, hi = [0.0] * dim, [1.0] * dim
    jV = jpt.FunctionSpace(jpt.StructuredMesh(lo, hi, (n,) * dim), jpt.QkFEM(k, dim))
    V = tpt.FunctionSpace(tpt.StructuredMesh(lo, hi, (n,) * dim), tpt.QkFEM(k, dim))
    jgo = jpt.GridOperator(jV, JNCD(JNP()), constraints=jpt.constraints(True, jV),
                           skip_boundary=True)
    go = tpt.GridOperator(V, TNCD(TNP()), constraints=tpt.constraints(True, V),
                          skip_boundary=True)
    x_lin = 0.1 * np.random.default_rng(2).standard_normal(V.ndofs)
    want = np.asarray(j_direct(jgo, x_lin=jnp.asarray(x_lin)).values)
    tx = torch.from_numpy(x_lin)
    direct = assemble_ell_direct(go, x_lin=tx, check=True)
    probed = assemble_ell(go, x_lin=tx)
    scale = np.abs(want).max()
    assert np.abs(direct.values.numpy() - want).max() <= 1e-12 * scale
    assert np.abs(direct.values.numpy() - probed.values.numpy()).max() <= 1e-12 * scale
    zero = assemble_ell_direct(go, x_lin=torch.zeros_like(tx))
    assert np.abs(zero.values.numpy() - direct.values.numpy()).max() > 1e-6 * scale
