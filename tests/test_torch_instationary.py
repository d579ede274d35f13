"""Parity of the port's time stepping with the JAX package (fp64).

  * every tableau of instationary/tableaux.py equals the reference's arrays
    bit for bit; the L2 mass (callable scale) and L2VolumeFunctional
    residuals and J.v to 1e-13;
  * OneStepMethod (implicit Euler and alexander2 with the linear stage
    solver, Crank-Nicolson with Newton) on the heat problem of
    tests/test_instationary.py: every step's solution to 1e-12 relative;
  * the config4_heat_theta_newton golden (models/configs.py:113): 16
    Newton iterations, L2 error to 1e-8 relative, on the general-jvp and
    the assembled (matrix_free=False) tiers;
  * ExplicitOneStepMethod on the DG heat problem of
    tests/test_instationary.py:130 (Heun, exact block mass inverse, 30
    steps) and on a C0 space (explicit Euler, the mass blocks averaged
    over shared DOFs): the JAX package's states to 1e-12;
    CFLTimeController's step;
  * failed-step handling (counterpart of
    tests/test_solver_semantics.py:67): failures booked, dt halved and the
    step retried, the error propagated once the retries run out.
"""
import json
import math
from pathlib import Path

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import dune_pdelab_tpu as jpt
import dune_pdelab_tpu_torch as tpt
from dune_pdelab_tpu import instationary as jinst
from dune_pdelab_tpu.fe import QkDGFEM as JQkDG
from dune_pdelab_tpu.ops import L2 as JL2
from dune_pdelab_tpu.ops import ConvectionDiffusionFEM as JFEM
from dune_pdelab_tpu.ops import ConvectionDiffusionProblem as JProblem
from dune_pdelab_tpu.ops.convectiondiffusiondg import ConvectionDiffusionDG as JDG
from dune_pdelab_tpu.solvers import SEQ_CG_Jacobi as J_CG_Jacobi
from dune_pdelab_tpu_torch import instationary as tinst
from dune_pdelab_tpu_torch.ops import L2, ConvectionDiffusionDG, ConvectionDiffusionFEM
from dune_pdelab_tpu_torch.ops import ConvectionDiffusionProblem as TProblem
from dune_pdelab_tpu_torch.solvers import LinearSolverBackend, SEQ_CG_Jacobi
from dune_pdelab_tpu_torch.solvers.newton import NewtonError
from dune_pdelab_tpu_torch.space.functions import l2_difference
from dune_pdelab_tpu_torch.utils.common import set_default_device

pytestmark = pytest.mark.fast
torch.set_num_threads(1)
set_default_device("cpu")
F64 = torch.float64
PI = np.pi
LAM = 2 * PI**2
GOLDEN = json.loads((Path(__file__).parent / "golden_parity.json").read_text())


class JHeat(JProblem):
    """tests/test_instationary.py HeatProblem: u = exp(-t) sin(pi x) sin(pi y)."""

    def u_exact(self, t):
        return lambda p: np.exp(-t) * np.sin(PI * p[:, 0]) * np.sin(PI * p[:, 1])

    def f(self, x):
        return (LAM - 1.0) * jnp.exp(-self.time) * jnp.sin(PI * x[..., 0]) * jnp.sin(
            PI * x[..., 1])


class THeat(TProblem):
    """The same problem on the port (a problem's time is a float)."""

    def u_exact(self, t):
        return lambda p: math.exp(-t) * torch.sin(PI * p[:, 0]) * torch.sin(PI * p[:, 1])

    def f(self, x):
        return (LAM - 1.0) * math.exp(-self.time) * torch.sin(PI * x[..., 0]) * torch.sin(
            PI * x[..., 1])


def _heat(n, k=1, dg=False):
    """(JAX space, go0, go1), (port space, go0, go1) of the heat problem."""
    cells = (n, n)
    jfem, tfem = (JQkDG(k, 2), tpt.QkDGFEM(k, 2)) if dg else (jpt.QkFEM(k, 2),
                                                              tpt.QkFEM(k, 2))
    jV = jpt.FunctionSpace(jpt.StructuredMesh([0, 0], [1, 1], cells), jfem)
    tV = tpt.FunctionSpace(tpt.StructuredMesh([0, 0], [1, 1], cells), tfem)
    jp, tp = JHeat(), THeat()
    if dg:
        return ((jV, jpt.GridOperator(jV, JDG(jp)), jpt.GridOperator(jV, JL2())),
                (tV, tpt.GridOperator(tV, ConvectionDiffusionDG(tp)), tpt.GridOperator(tV, L2())))
    jcg, tcg = jpt.constraints(jp.dirichlet_bctype(), jV), tpt.constraints(
        tp.dirichlet_bctype(), tV)
    return ((jV, jpt.GridOperator(jV, JFEM(jp), constraints=jcg),
             jpt.GridOperator(jV, JL2(), constraints=jcg)),
            (tV, tpt.GridOperator(tV, ConvectionDiffusionFEM(tp), constraints=tcg),
             tpt.GridOperator(tV, L2(), constraints=tcg)))


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("name", list(jinst.SCHEMES))
def test_tableaux_equal_reference(name):
    assert list(tinst.SCHEMES) == list(jinst.SCHEMES)
    want, got = jinst.SCHEMES[name](), tinst.SCHEMES[name]()
    assert (got.name, got.implicit, got.order, got.stages) == (
        want.name, want.implicit, want.order, want.stages)
    for a in ("a", "b", "d"):
        assert np.array_equal(getattr(got, a), getattr(want, a))
    th = 0.3
    assert np.array_equal(tinst.one_step_theta(th).b, jinst.one_step_theta(th).b)


def test_l2_operators_match_jax():
    """ops/l2.py: the scaled mass (a callable scale) and the volume
    functional, residual and J.v to 1e-13 relative."""
    from dune_pdelab_tpu.ops import L2VolumeFunctional as JL2F
    from dune_pdelab_tpu_torch.ops import L2VolumeFunctional

    jV = jpt.FunctionSpace(jpt.StructuredMesh([0, 0], [1, 1], (5, 4)), jpt.QkFEM(2, 2))
    tV = tpt.FunctionSpace(tpt.StructuredMesh([0, 0], [1, 1], (5, 4)), tpt.QkFEM(2, 2))
    rng = np.random.default_rng(17)
    x, z = rng.standard_normal(tV.ndofs), rng.standard_normal(tV.ndofs)
    pairs = ((JL2(scale=lambda q: 1.0 + q[..., 0] * q[..., 1]),
              L2(scale=lambda q: 1.0 + q[..., 0] * q[..., 1])),
             (JL2F(lambda q: jnp.cos(q[..., 0]) + q[..., 1]),
              L2VolumeFunctional(lambda q: torch.cos(q[..., 0]) + q[..., 1])))
    for jlop, tlop in pairs:
        jgo, tgo = jpt.GridOperator(jV, jlop), tpt.GridOperator(tV, tlop)
        assert _rel(tgo.residual(torch.from_numpy(x)).numpy(),
                    jgo.residual(jnp.asarray(x))) <= 1e-13
        jv = tgo.jacobian_apply(torch.from_numpy(x), torch.from_numpy(z)).numpy()
        if hasattr(tlop, "alpha_volume"):
            assert _rel(jv, jgo.jacobian_apply(jnp.asarray(x), jnp.asarray(z))) <= 1e-13
        else:                                   # a functional: J = 0
            assert not jv.any()


@pytest.mark.parametrize("scheme,pdesolver", [("implicit_euler", "linear"),
                                              ("crank_nicolson", "newton"),
                                              ("alexander2", "linear")])
def test_one_step_method_steps_match_jax(scheme, pdesolver):
    (jV, jgo0, jgo1), (tV, go0, go1) = _heat(8)
    red = {"reduction": 1e-12}
    josm = jinst.OneStepMethod(jinst.SCHEMES[scheme](), jgo0, jgo1, J_CG_Jacobi(),
                               pdesolver=pdesolver, **red)
    osm = tinst.OneStepMethod(tinst.SCHEMES[scheme](), go0, go1, SEQ_CG_Jacobi(),
                              pdesolver=pdesolver, **red)
    xj = jV.interpolate(JHeat().u_exact(0.0))
    x = tV.interpolate(THeat().u_exact(0.0), dtype=F64)
    t, dt = 0.0, 0.05
    for _ in range(3):
        xj = josm.apply(t, dt, xj)
        x = osm.apply(t, dt, x)
        t += dt
        assert _rel(x.numpy(), xj) <= 1e-12
    assert osm.result.steps == 3
    assert osm.result.total_newton_iterations == josm.result.total_newton_iterations
    assert osm.result.total_linear_iterations == josm.result.total_linear_iterations


@pytest.mark.parametrize("matrix_free", [True, False])
def test_config4_golden(matrix_free):
    """models/configs.py config4_heat_theta_newton: 16^2 Q1, Crank-Nicolson,
    Newton (reduction 1e-9) with Jacobi-CG per stage, 10 steps of 0.02."""
    want = GOLDEN["config4_heat_theta_newton"]
    _, (V, go0, go1) = _heat(16)
    p = go0.lop.problem
    ls = LinearSolverBackend(solver="cg", precond="jacobi", matrix_free=matrix_free)
    osm = tinst.OneStepMethod(tinst.crank_nicolson(), go0, go1, ls, pdesolver="newton",
                              reduction=1e-9)
    x = V.interpolate(p.u_exact(0.0), dtype=F64)
    t = 0.0
    for _ in range(10):
        x = osm.apply(t, 0.02, x)
        t += 0.02
    assert V.ndofs == want["ndofs"] and t == pytest.approx(want["t_final"], abs=1e-15)
    assert osm.result.total_newton_iterations == want["newton_iterations"]
    assert float(l2_difference(V, x, p.u_exact(t))) == pytest.approx(want["l2_error"],
                                                                      rel=1e-8)
    assert ("assembled EllMatrix" if not matrix_free else "general-jvp") in ls.report()


def test_explicit_dg_heat_matches_jax():
    """tests/test_instationary.py:130: Heun on Q1 DG at dt = 2e-4, here 30
    steps (to 0.006; the reference test runs 100)."""
    (jV, jgo0, jgo1), (tV, go0, go1) = _heat(8, dg=True)
    josm = jinst.ExplicitOneStepMethod(jinst.heun(), jgo0, jgo1)
    osm = tinst.ExplicitOneStepMethod(tinst.heun(), go0, go1)
    xj = jV.interpolate(JHeat().u_exact(0.0))
    x = tV.interpolate(THeat().u_exact(0.0), dtype=F64)
    tj, xj = josm.solve(0.0, 2e-4, 0.006, xj)
    t, x = osm.solve(0.0, 2e-4, 0.006, x)
    assert t == tj and _rel(x.numpy(), xj) <= 1e-12
    assert float(l2_difference(tV, x, THeat().u_exact(t))) < 0.02


class TSpeed(TProblem):
    pass


def test_explicit_c0_and_cfl_match_jax():
    (jV, jgo0, jgo1), (tV, go0, go1) = _heat(6)
    josm = jinst.ExplicitOneStepMethod(jinst.explicit_euler(), jgo0, jgo1)
    osm = tinst.ExplicitOneStepMethod(tinst.explicit_euler(), go0, go1)
    xj = jV.interpolate(JHeat().u_exact(0.0))
    x = tV.interpolate(THeat().u_exact(0.0), dtype=F64)
    for t in (0.0, 1e-3):
        xj, _ = josm.apply(t, 1e-3, xj)
        x, used = osm.apply(t, 1e-3, x)
        assert used == 1e-3 and _rel(x.numpy(), xj) <= 1e-12
    with pytest.raises(ValueError):
        tinst.ExplicitOneStepMethod(tinst.implicit_euler(), go0, go1)

    class Speedy(ConvectionDiffusionFEM):
        def max_speed(self, x, mesh=None):
            return 4.0

    go = tpt.GridOperator(tV, Speedy(TSpeed()))
    ctl = tinst.CFLTimeController(0.5, go)
    assert ctl.suggest_timestep(0.0, 1.0, x) == pytest.approx(0.5 / 6 / 4.0)
    assert ctl.suggest_timestep(0.0, 1e-3, x) == 1e-3
    assert tinst.CFLTimeController(0.5, go0).suggest_timestep(0.0, 0.1, x) == 0.1


def test_failed_steps_booked_and_retried():
    _, (V, go0, go1) = _heat(6)
    x0 = V.interpolate(THeat().u_exact(0.0), dtype=F64)

    def make(fail_first_n):
        osm = tinst.OneStepMethod(tinst.implicit_euler(), go0, go1, SEQ_CG_Jacobi(),
                                  pdesolver="newton", reduction=1e-10)
        calls = {"n": 0, "dt": []}
        orig = osm.pdesolver.apply

        def flaky(x, time=0.0):
            calls["n"] += 1
            calls["dt"].append(time.wb)
            if calls["n"] <= fail_first_n:
                raise NewtonError("synthetic stage failure")
            return orig(x, time=time)

        osm.pdesolver.apply = flaky
        return osm, calls

    osm, calls = make(fail_first_n=2)
    t, x = osm.solve(0.0, 0.4, 0.4, x0, max_step_retries=3)
    # two failures booked; the surviving first step ran at dt/4 = 0.1, then
    # the march goes on to tend
    assert osm.result.failed_steps == 2
    assert calls["dt"] == pytest.approx([0.4, 0.2, 0.1, 0.3], abs=1e-15)
    assert t == pytest.approx(0.4, abs=1e-12) and osm.result.steps == 2
    assert torch.isfinite(x).all()
    osm2, _ = make(fail_first_n=10)
    with pytest.raises(NewtonError):
        osm2.solve(0.0, 0.4, 0.4, x0, max_step_retries=2)
    assert osm2.result.failed_steps == 3           # the first try and 2 retries
    osm3, _ = make(fail_first_n=1)
    with pytest.raises(NewtonError):
        osm3.solve(0.0, 0.4, 0.4, x0)
    assert osm3.result.failed_steps == 1
