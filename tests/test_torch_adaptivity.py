"""Parity of the port's estimators, marking, transfers, goal-oriented
estimation and DG indicator/limiter with the JAX package (fp64, 1e-12).

  * error_fraction / element_fraction / mark_elements, equal;
  * residual_estimator_convectiondiffusion (uniform Q1/Q2) and the raise on
    a mapped mesh (the reference raises there too, adaptivity.py:77);
  * volume_residual_indicator on a hanging-node AdaptiveMesh;
  * p1_edge_jump_indicator in 2D and 3D, with and without a source;
  * adapt_uniform (factor 2: the prolongation; 3: pointwise evaluation);
  * GridOperator.weighted_element_residuals against the reference, with
    sum_K eta_K = w^T r (C0 with boundary terms, DG skeleton, simplex DG,
    hanging nodes);
  * dwr_indicators (Q1 primal, Q2 dual, J(u) = int u) and space_transfer;
  * dg_jump_indicator (structured and simplex) and MinmodSlopeLimiter.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

import dune_pdelab_tpu as jpt
import dune_pdelab_tpu_torch as tpt
from dune_pdelab_tpu import adaptivity as ja
from dune_pdelab_tpu.adaptivity import local as jl
from dune_pdelab_tpu.fe import PkDGFEM as JPkDG
from dune_pdelab_tpu.fe import QkDGFEM as JQkDG
from dune_pdelab_tpu.mesh import SimplexMesh as JSimplex
from dune_pdelab_tpu.mesh.adaptive import AdaptiveMesh as JAM
from dune_pdelab_tpu.ops import ConvectionDiffusionFEM as JFEM
from dune_pdelab_tpu.ops import ConvectionDiffusionProblem as JProblem
from dune_pdelab_tpu.ops.convectiondiffusiondg import ConvectionDiffusionDG as JDG
from dune_pdelab_tpu_torch import adaptivity as ta
from dune_pdelab_tpu_torch.adaptivity import local as tl
from dune_pdelab_tpu_torch.mesh import AdaptiveMesh as TAM
from dune_pdelab_tpu_torch.mesh import SimplexMesh as TSimplex
from dune_pdelab_tpu_torch.ops import ConvectionDiffusionFEM as TFEM
from dune_pdelab_tpu_torch.ops import ConvectionDiffusionProblem as TProblem
from dune_pdelab_tpu_torch.ops.convectiondiffusiondg import ConvectionDiffusionDG as TDG
from dune_pdelab_tpu_torch.utils.common import set_default_device

pytestmark = pytest.mark.fast
torch.set_num_threads(1)
set_default_device("cpu")
F64 = torch.float64


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


class JP(JProblem):
    def A(self, x):
        return 1.0 + 0.25 * x[..., 0]

    def b(self, x):
        return jnp.stack([0.3 + 0 * x[..., 0]] * x.shape[-1], -1)

    def f(self, x):
        return 2 * np.pi ** 2 * jnp.sin(np.pi * x[..., 0]) * jnp.sin(np.pi * x[..., 1])


class TP(TProblem):
    def A(self, x):
        return 1.0 + 0.25 * x[..., 0]

    def b(self, x):
        return torch.stack([0.3 + 0 * x[..., 0]] * x.shape[-1], -1)

    def f(self, x):
        return 2 * np.pi ** 2 * torch.sin(np.pi * x[..., 0]) * torch.sin(np.pi * x[..., 1])


def _rand(n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(n), rng.standard_normal(n)


def test_marking_equal():
    eta = np.random.default_rng(0).random(200) ** 3
    for a in (0.3, 0.5, 0.9):
        assert ta.error_fraction(eta, a) == ja.error_fraction(eta, a)
        assert ta.element_fraction(torch.from_numpy(eta), a) == ja.element_fraction(eta, a)
        for x, y in zip(ta.mark_elements(eta, ja.error_fraction(eta, a), 1e-3),
                        ja.mark_elements(eta, ja.error_fraction(eta, a), 1e-3)):
            np.testing.assert_array_equal(x, y)
    assert ta.error_fraction(np.zeros(4), 0.5) == np.inf


@pytest.mark.parametrize("k", [1, 2])
def test_residual_estimator_matches_jax(k):
    jV = jpt.FunctionSpace(jpt.StructuredMesh([0, 0], [1, 1], (5, 4)), jpt.QkFEM(k, 2))
    tV = tpt.FunctionSpace(tpt.StructuredMesh([0, 0], [1, 1], (5, 4)), tpt.QkFEM(k, 2))
    jgo = jpt.GridOperator(jV, JFEM(JP()), constraints=jpt.constraints(True, jV))
    tgo = tpt.GridOperator(tV, TFEM(TP()), constraints=tpt.constraints(True, tV))
    x, _ = _rand(tV.ndofs)
    got = ta.residual_estimator_convectiondiffusion(tgo, TP(), torch.from_numpy(x))
    want = ja.residual_estimator_convectiondiffusion(jgo, JP(), jnp.asarray(x))
    assert _rel(got.numpy(), np.asarray(want)) <= 1e-12
    coords = np.stack(np.meshgrid(np.linspace(0, 1, 3), np.linspace(0, 1, 3) ** 1.5,
                                  indexing="xy"), -1).reshape(-1, 2)
    mapped = tpt.StructuredMesh([0, 0], [1, 1], (2, 2), coords=coords)
    Vm = tpt.FunctionSpace(mapped, tpt.QkFEM(1, 2))
    gom = tpt.GridOperator(Vm, TFEM(TP()), constraints=tpt.constraints(True, Vm))
    with pytest.raises(NotImplementedError, match="uniform mesh"):
        ta.residual_estimator_convectiondiffusion(gom, TP(), Vm.zero(F64))


def test_volume_indicator_on_hanging_mesh():
    out = []
    for AM, pt_, P, FEM in ((JAM, jpt, JP, JFEM), (TAM, tpt, TP, TFEM)):
        m = AM([0, 0], [1, 1], (4, 4))
        marks = np.zeros(m.nelements, bool)
        marks[[0, 5]] = True
        m = m.refine(marks)
        V = pt_.FunctionSpace(m, pt_.QkFEM(1, 2))
        out.append(pt_.GridOperator(V, FEM(P()), constraints=pt_.constraints(True, V),
                                    skip_boundary=True))
    jgo, tgo = out
    x, _ = _rand(tgo.space.ndofs, 1)
    got = tl.volume_residual_indicator(tgo, TP(), torch.from_numpy(x))
    want = jl.volume_residual_indicator(jgo, JP(), jnp.asarray(x))
    assert _rel(got.numpy(), np.asarray(want)) <= 1e-12


@pytest.mark.parametrize("dim", [2, 3])
def test_p1_edge_jump_indicator_matches_jax(dim):
    n = 4 if dim == 2 else 2
    jm = JSimplex.from_structured(jpt.StructuredMesh([0] * dim, [1] * dim, (n,) * dim))
    tm = TSimplex.from_structured(tpt.StructuredMesh([0] * dim, [1] * dim, (n,) * dim))
    jV, tV = jpt.FunctionSpace(jm, jpt.PkFEM(1, dim)), tpt.FunctionSpace(tm, tpt.PkFEM(1, dim))
    x, _ = _rand(tV.ndofs, 2)

    def f(c):
        return np.sin(3 * c[:, 0]) + 1.0

    for src in (None, f):
        got = ta.p1_edge_jump_indicator(tV, torch.from_numpy(x), src)
        want = jl.p1_edge_jump_indicator(jV, jnp.asarray(x), src)
        assert _rel(got, want) <= 1e-13


@pytest.mark.parametrize("factor", [2, 3])
def test_adapt_uniform_matches_jax(factor):
    jV = jpt.FunctionSpace(jpt.StructuredMesh([0, 0], [1, 1], (3, 2)), jpt.QkFEM(2, 2))
    tV = tpt.FunctionSpace(tpt.StructuredMesh([0, 0], [1, 1], (3, 2)), tpt.QkFEM(2, 2))
    x, _ = _rand(tV.ndofs, 3)
    jV2, jx = ja.adapt_uniform(jV, jnp.asarray(x), factor)
    tV2, tx = ta.adapt_uniform(tV, torch.from_numpy(x), factor)
    assert tV2.ndofs == jV2.ndofs and _rel(tx.numpy(), np.asarray(jx)) <= 1e-13


def _weighted_cases():
    jm, tm = (JSimplex.from_structured(jpt.StructuredMesh([0, 0], [1, 1], (3, 3))),
              TSimplex.from_structured(tpt.StructuredMesh([0, 0], [1, 1], (3, 3))))
    jV, tV = jpt.FunctionSpace(jm, JPkDG(1, 2)), tpt.FunctionSpace(tm, tpt.PkDGFEM(1, 2))
    yield "simplex-dg", jpt.GridOperator(jV, JDG(JP())), tpt.GridOperator(tV, TDG(TP()))
    jV = jpt.FunctionSpace(jpt.StructuredMesh([0, 0], [1, 1], (4, 3)), JQkDG(1, 2))
    tV = tpt.FunctionSpace(tpt.StructuredMesh([0, 0], [1, 1], (4, 3)), tpt.QkDGFEM(1, 2))
    yield "dg", jpt.GridOperator(jV, JDG(JP())), tpt.GridOperator(tV, TDG(TP()))
    jV = jpt.FunctionSpace(jpt.StructuredMesh([0, 0], [1, 1], (4, 3)), jpt.QkFEM(2, 2))
    tV = tpt.FunctionSpace(tpt.StructuredMesh([0, 0], [1, 1], (4, 3)), tpt.QkFEM(2, 2))
    yield ("c0", jpt.GridOperator(jV, JFEM(JP()), constraints=jpt.constraints(True, jV)),
           tpt.GridOperator(tV, TFEM(TP()), constraints=tpt.constraints(True, tV)))


@pytest.mark.parametrize("case", ["simplex-dg", "dg", "c0", "hanging"])
def test_weighted_element_residuals(case):
    if case == "hanging":
        ops = []
        for AM, pt_, P, FEM in ((JAM, jpt, JP, JFEM), (TAM, tpt, TP, TFEM)):
            m = AM([0, 0], [1, 1], (3, 3)).refine([True] + [False] * 8)
            V = pt_.FunctionSpace(m, pt_.QkFEM(1, 2))
            ops.append(pt_.GridOperator(V, FEM(P()), constraints=pt_.constraints(True, V),
                                        skip_boundary=True))
        jgo, tgo = ops
    else:
        jgo, tgo = next((j, t) for name, j, t in _weighted_cases() if name == case)
    x, w = _rand(tgo.space.ndofs, 4)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    eta = tgo.weighted_element_residuals(tx, tw)
    assert _rel(eta.numpy(), np.asarray(jgo.weighted_element_residuals(jnp.asarray(x),
                                                                       jnp.asarray(w)))) <= 1e-12
    wf = w if tgo.cg is None else np.where(tgo.cg.mask_np, 0.0, w)
    rhs = float(np.dot(wf, tgo.residual(tx).numpy()))
    assert abs(float(eta.sum()) - rhs) <= 1e-11 * max(1.0, abs(rhs))
    assert torch.equal(eta, tgo.weighted_element_residuals(tx, tw))


def test_dwr_indicators_match_jax():
    from dune_pdelab_tpu.ops.l2 import L2 as JL2
    from dune_pdelab_tpu_torch.ops.l2 import L2 as TL2

    ops = []
    for pt_, P, FEM, L2 in ((jpt, JP, JFEM, JL2), (tpt, TP, TFEM, TL2)):
        mesh = pt_.StructuredMesh([0, 0], [1, 1], (6, 5))
        V, Vr = pt_.FunctionSpace(mesh, pt_.QkFEM(1, 2)), pt_.FunctionSpace(mesh, pt_.QkFEM(2, 2))
        ops.append((pt_.GridOperator(V, FEM(P()), constraints=pt_.constraints(True, V)),
                    pt_.GridOperator(Vr, FEM(P()), constraints=pt_.constraints(True, Vr)),
                    pt_.GridOperator(Vr, L2())))
    (jgo, jgor, jm), (tgo, tgor, tm) = ops
    x, _ = _rand(tgo.space.ndofs, 5)
    qj = jm.jacobian_apply(jgor.space.zero(), jnp.ones(jgor.space.ndofs))
    qt = tm.jacobian_apply(tgor.space.zero(F64), torch.ones(tgor.space.ndofs, dtype=F64))
    assert _rel(qt.numpy(), np.asarray(qj)) <= 1e-13
    eta_j, est_j = ja.dwr_indicators(jgo, jgor, jnp.asarray(x), lambda u: jnp.dot(qj, u))
    eta_t, est_t = ta.dwr_indicators(tgo, tgor, torch.from_numpy(x), lambda u: torch.dot(qt, u))
    assert _rel(eta_t.numpy(), np.asarray(eta_j)) <= 1e-9     # through a 1e-12 adjoint solve
    assert est_t == pytest.approx(est_j, rel=1e-9)
    emb_t = ta.space_transfer(tgo.space, tgor.space)
    emb_j = ja.space_transfer(jgo.space, jgor.space)
    assert _rel(emb_t(torch.from_numpy(x)).numpy(), np.asarray(emb_j(jnp.asarray(x)))) <= 1e-14


@pytest.mark.parametrize("mesh", ["structured", "simplex"])
def test_dg_jump_indicator_matches_jax(mesh):
    if mesh == "structured":
        jV = jpt.FunctionSpace(jpt.StructuredMesh([0, 0], [1, 1], (5, 4)), JQkDG(1, 2))
        tV = tpt.FunctionSpace(tpt.StructuredMesh([0, 0], [1, 1], (5, 4)), tpt.QkDGFEM(1, 2))
    else:
        jV = jpt.FunctionSpace(JSimplex.from_structured(
            jpt.StructuredMesh([0, 0], [1, 1], (3, 3))), JPkDG(1, 2))
        tV = tpt.FunctionSpace(TSimplex.from_structured(
            tpt.StructuredMesh([0, 0], [1, 1], (3, 3))), tpt.PkDGFEM(1, 2))
    jgo, tgo = jpt.GridOperator(jV, JDG(JP())), tpt.GridOperator(tV, TDG(TP()))
    x, _ = _rand(tV.ndofs, 6)
    got = ta.dg_jump_indicator(tgo, torch.from_numpy(x))
    assert _rel(got.numpy(), np.asarray(ja.dg_jump_indicator(jgo, jnp.asarray(x)))) <= 1e-12


@pytest.mark.parametrize("periodic", [None, (True, False)])
def test_minmod_limiter_matches_jax(periodic):
    jV = jpt.FunctionSpace(jpt.StructuredMesh([0, 0], [1, 1], (5, 4), periodic=periodic),
                           JQkDG(1, 2))
    tV = tpt.FunctionSpace(tpt.StructuredMesh([0, 0], [1, 1], (5, 4), periodic=periodic),
                           tpt.QkDGFEM(1, 2))
    x, _ = _rand(tV.ndofs, 7)
    for theta in (1.0, 1.5):
        got = ta.MinmodSlopeLimiter(tV, theta)(torch.from_numpy(x))
        want = ja.MinmodSlopeLimiter(jV, theta)(jnp.asarray(x))
        assert _rel(got.numpy(), np.asarray(want)) <= 1e-13
