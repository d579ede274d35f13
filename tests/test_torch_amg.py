"""Parity of the port's AlgebraicMultigrid with the JAX package (fp64).

  * the hierarchy from one CSR (2D Q1 16^2 and simplex P1 32^2): at every
    level the strength graph, the decoupled rows and the aggregates (the
    port's native and Python aggregation and the JAX package's), the level
    sizes and nonzeros, the operator complexity to 1e-14, the V-cycle on 4
    random vectors to 1e-12 relative, also through interop's
    amg_from_host_levels; the cycle is linear, symmetric and positive;
  * each package's hierarchy from its own assembly (the two store
    different explicit zeros: the port drops constrained rows and columns
    and keeps exact zeros of the element sums): the same nonzero pattern,
    strength graph, decoupled rows and aggregates;
  * Chebyshev smoothing and the decoupled per-block setup (parts=2):
    cycles to 1e-12, setup_parts_report's keys;
  * config12 from the port reproduces the golden (14 iterations, 2 levels,
    operator complexity to 1e-12, L2 to 1e-8 relative);
  * SEQ_CG_AMG and SEQ_BCGS_AMG give the JAX package's iteration counts on
    2D Q1 16^2; DGTwoLevel(coarse="amg") applies to 1e-10 of the JAX cycle
    on 2D Q1 SIPG 8^2 and takes its CG iterations;
  * a failed build of csrc/amg_setup.cc raises.
"""
import json
from pathlib import Path

import numpy as np
import pytest
import jax.numpy as jnp
import scipy.sparse as sp
import torch

import dune_pdelab_tpu as jpt
import dune_pdelab_tpu.linalg.amg as jamg
import dune_pdelab_tpu_torch as tpt
import dune_pdelab_tpu_torch.linalg.amg as tamg
from dune_pdelab_tpu.fe import PkFEM as JPk
from dune_pdelab_tpu.fe import QkDGFEM as JQkDG
from dune_pdelab_tpu.linalg import DGTwoLevel as JTwoLevel
from dune_pdelab_tpu.linalg.krylov import cg as jcg
from dune_pdelab_tpu.mesh import SimplexMesh as JSimplex
from dune_pdelab_tpu.ops import ConvectionDiffusionFEM as JFEM
from dune_pdelab_tpu.ops import ConvectionDiffusionProblem as JProblem
from dune_pdelab_tpu.ops.convectiondiffusiondg import ConvectionDiffusionDG as JDG
from dune_pdelab_tpu.solvers import SEQ_BCGS_AMG as J_BCGS_AMG
from dune_pdelab_tpu.solvers import SEQ_CG_AMG as J_CG_AMG
from dune_pdelab_tpu_torch.fe import PkFEM as TPk
from dune_pdelab_tpu_torch.interop import amg_from_host_levels
from dune_pdelab_tpu_torch.linalg import DGTwoLevel, cg
from dune_pdelab_tpu_torch.mesh import SimplexMesh as TSimplex
from dune_pdelab_tpu_torch.ops import ConvectionDiffusionDG as TDG
from dune_pdelab_tpu_torch.ops import ConvectionDiffusionFEM as TFEM
from dune_pdelab_tpu_torch.ops import ConvectionDiffusionProblem as TProblem
from dune_pdelab_tpu_torch.solvers import (
    LinearSolverBackend, SEQ_BCGS_AMG, SEQ_CG_AMG, StationaryLinearProblemSolver,
)
from dune_pdelab_tpu_torch.space.functions import l2_difference
from dune_pdelab_tpu_torch.utils.common import set_default_device

pytestmark = pytest.mark.fast
torch.set_num_threads(1)
set_default_device("cpu")
F64 = torch.float64
PI = np.pi
GOLDEN = json.loads((Path(__file__).parent / "golden_parity.json").read_text())


class JSine(JProblem):
    """models/configs.py _Sine2D."""

    def exact(self, p):
        return np.sin(PI * p[:, 0]) * np.cos(2 * PI * p[:, 1]) + p[:, 0]

    def f(self, x):
        return 5 * PI**2 * jnp.sin(PI * x[..., 0]) * jnp.cos(2 * PI * x[..., 1])

    def g(self, x):
        return jnp.sin(PI * x[..., 0]) * jnp.cos(2 * PI * x[..., 1]) + x[..., 0]


class TSine(TProblem):
    def exact(self, p):
        return torch.sin(PI * p[:, 0]) * torch.cos(2 * PI * p[:, 1]) + p[:, 0]

    def f(self, x):
        return 5 * PI**2 * torch.sin(PI * x[..., 0]) * torch.cos(2 * PI * x[..., 1])

    def g(self, x):
        return torch.sin(PI * x[..., 0]) * torch.cos(2 * PI * x[..., 1]) + x[..., 0]


def _ops(kind):
    """(JAX go, port go) of 2D Poisson: Q1 on 16^2 or simplex P1 on 32^2."""
    if kind == "q1":
        jm = jpt.StructuredMesh([0, 0], [1, 1], (16, 16))
        tm = tpt.StructuredMesh([0, 0], [1, 1], (16, 16))
        jV, tV = jpt.FunctionSpace(jm, jpt.QkFEM(1, 2)), tpt.FunctionSpace(tm, tpt.QkFEM(1, 2))
        skip = False
    else:
        jm = JSimplex.from_structured(jpt.StructuredMesh([0, 0], [1, 1], (32, 32)))
        tm = TSimplex.from_structured(tpt.StructuredMesh([0, 0], [1, 1], (32, 32)))
        jV, tV = jpt.FunctionSpace(jm, JPk(1, 2)), tpt.FunctionSpace(tm, TPk(1, 2))
        skip = True
    jgo = jpt.GridOperator(jV, JFEM(JSine()), constraints=jpt.constraints(True, jV))
    tgo = tpt.GridOperator(tV, TFEM(TSine()), constraints=tpt.constraints(True, tV),
                           skip_boundary=skip)
    return jgo, tgo


def _jax_csr(jgo):
    A = jgo.jacobian(jnp.zeros(jgo.space.ndofs))
    ind = np.asarray(A.indices)
    return sp.coo_matrix((np.asarray(A.data), (ind[:, 0], ind[:, 1])), shape=A.shape).tocsr()


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.abs(got - want).max() / np.abs(want).max()


def _level_graph(mod, A, theta=0.02):
    S = mod._strength_graph(A, theta)
    off = A - sp.diags(A.diagonal())
    off.eliminate_zeros()
    return S, np.diff(off.tocsr().indptr) == 0


def _rand(n, k=4, seed=11):
    return np.random.default_rng(seed).standard_normal((k, n))


@pytest.fixture(scope="module", params=["q1", "p1"])
def same_csr(request):
    jgo, tgo = _ops(request.param)
    A = _jax_csr(jgo)
    ja = jamg.AlgebraicMultigrid().setup_from_csr(A, keep_host=True)
    ta = tamg.AlgebraicMultigrid().setup_from_csr(A, keep_host=True)
    return A, ja, ta


def test_hierarchy_from_one_csr(same_csr):
    A, ja, ta = same_csr
    ji, ti = ja.hierarchy_info(), ta.hierarchy_info()
    assert ti["sizes"] == ji["sizes"] and ti["nnz"] == ji["nnz"]
    assert len(ti["sizes"]) >= 2
    assert abs(ti["operator_complexity"] - ji["operator_complexity"]) <= 1e-14
    for (jA, jP, _, jd, jrho), (tA, tP, _, td, trho) in zip(ja.host_levels, ta.host_levels):
        jS, jdec = _level_graph(jamg, jA)
        tS, tdec = _level_graph(tamg, jA)
        assert np.array_equal(tS.indptr, jS.indptr) and np.array_equal(tS.indices, jS.indices)
        assert np.array_equal(tdec, jdec)
        j_agg = jamg._aggregate(jS, jdec)
        for native in (True, False):
            t_agg = tamg._aggregate(tS, tdec, native=native)
            assert t_agg[1] == j_agg[1] and np.array_equal(t_agg[0], j_agg[0])
        assert trho == jrho and np.array_equal(td, jd)
        assert np.array_equal(tP.indptr, jP.indptr) and np.array_equal(tP.indices, jP.indices)
        assert _rel(tP.data, jP.data) <= 1e-14
        assert _rel(tA.toarray(), jA.toarray()) <= 1e-14
    assert _rel(ta.host_coarse, ja.host_coarse) <= 1e-13


def test_vcycle_from_one_csr(same_csr):
    A, ja, ta = same_csr
    via = amg_from_host_levels(ja.host_levels, ja.host_coarse)
    for r in _rand(A.shape[0]):
        want = np.asarray(ja.apply(jnp.asarray(r)))
        assert _rel(ta.apply(torch.from_numpy(r)).numpy(), want) <= 1e-12
        assert _rel(via.apply(torch.from_numpy(r)).numpy(), want) <= 1e-12
        assert _rel(ta(torch.from_numpy(r)).numpy(), want) <= 1e-12   # dual convention
    assert via.hierarchy_info()["sizes"] == ja.hierarchy_info()["sizes"]


def test_vcycle_linear_symmetric_positive(same_csr):
    A, _, ta = same_csr
    r1, r2 = (torch.from_numpy(v) for v in _rand(A.shape[0], 2, seed=3))
    M = ta.apply
    lin = M(2.0 * r1 - 3.0 * r2) - (2.0 * M(r1) - 3.0 * M(r2))
    assert float(torch.linalg.norm(lin)) < 1e-10
    s12, s21 = float(M(r1) @ r2), float(r1 @ M(r2))
    assert abs(s12 - s21) < 1e-8 * max(abs(s12), 1.0)
    assert float(r1 @ M(r1)) > 0
    # the float32 cycle: the same levels cast once
    y32 = M(r1.to(torch.float32))
    assert y32.dtype == torch.float32 and _rel(y32.double().numpy(), M(r1).numpy()) <= 1e-4


@pytest.mark.parametrize("kind", ["q1", "p1"])
def test_own_assembly_same_aggregates(kind):
    """The packages' assembled matrices store different explicit zeros;
    the nonzero pattern, the strength graph, the decoupled rows and the
    aggregates agree all the same."""
    jgo, tgo = _ops(kind)
    ja = jamg.AlgebraicMultigrid().setup_from_grid_operator(jgo, keep_host=True)
    ta = tamg.AlgebraicMultigrid().setup_from_grid_operator(tgo, keep_host=True)
    jA, tA = ja.host_levels[0][0], ta.host_levels[0][0]
    assert _rel(tA.toarray(), jA.toarray()) <= 1e-13
    tnz, jnz = tA.copy(), jA.copy()
    tnz.eliminate_zeros()
    jnz.eliminate_zeros()
    assert np.array_equal(tnz.indptr, jnz.indptr) and np.array_equal(tnz.indices, jnz.indices)
    jS, jdec = _level_graph(jamg, jA)
    tS, tdec = _level_graph(tamg, tA)
    assert np.array_equal(tS.indptr, jS.indptr) and np.array_equal(tS.indices, jS.indices)
    assert np.array_equal(tdec, jdec)
    j_agg, t_agg = jamg._aggregate(jS, jdec), tamg._aggregate(tS, tdec)
    assert t_agg[1] == j_agg[1] and np.array_equal(t_agg[0], j_agg[0])
    ji, ti = ja.hierarchy_info(), ta.hierarchy_info()
    assert ti["sizes"] == ji["sizes"] and ti["nnz"] == ji["nnz"]
    assert abs(ti["operator_complexity"] - ji["operator_complexity"]) <= 1e-14
    assert {"assemble", "host_csr", "strength", "aggregate", "smooth_p", "rap",
            "ell_upload", "coarse_lu"} <= set(ta.setup_times)


@pytest.mark.parametrize("opts", [{"smoother": "chebyshev"}, {"presmooth": 2, "postsmooth": 0},
                                  {"parts": 2}])
def test_options_match_jax(opts):
    jgo, _ = _ops("q1")
    A = _jax_csr(jgo)
    kw = {k: v for k, v in opts.items() if k != "parts"}
    parts = opts.get("parts")
    ja = jamg.AlgebraicMultigrid(max_coarse=30, **kw).setup_from_csr(A, parts=parts)
    ta = tamg.AlgebraicMultigrid(max_coarse=30, **kw).setup_from_csr(A, parts=parts)
    assert ta.hierarchy_info() == pytest.approx(ja.hierarchy_info(), rel=1e-14)
    for r in _rand(A.shape[0], 2):
        want = np.asarray(ja.apply(jnp.asarray(r)))
        assert _rel(ta.apply(torch.from_numpy(r)).numpy(), want) <= 1e-12
    if parts:
        rep_j, rep_t = ja.setup_parts_report(10**6), ta.setup_parts_report(10**6)
        assert rep_t.keys() == rep_j.keys() and rep_t["parts"] == 2
        assert len(ta.setup_part_walls) == len(ja.setup_part_walls)
    else:
        assert ta.setup_parts_report() is None


def test_config12_golden():
    """config12_simplex_amg (models/configs.py:490-522) from the port; the
    pure-Dirichlet problem drops its boundary kernels (skip_boundary)."""
    want = GOLDEN["config12_simplex_amg"]
    p = TSine()
    V = tpt.FunctionSpace(TSimplex.from_structured(tpt.StructuredMesh([0, 0], [1, 1], (32, 32))),
                          TPk(1, 2))
    cons = tpt.constraints(p.dirichlet_bctype(), V)
    go = tpt.GridOperator(V, TFEM(p), constraints=cons, skip_boundary=True)
    amg = tamg.AlgebraicMultigrid()
    ls = LinearSolverBackend(solver="cg", precond=amg, use_stencil=False)
    x0 = tpt.interpolate_dirichlet(p.g, V, cons, V.zero(F64))
    slp = StationaryLinearProblemSolver(go, ls, reduction=1e-10)
    x = slp.apply(x0)
    info = amg.hierarchy_info()
    assert slp.result.converged and V.ndofs == want["ndofs"]
    assert slp.result.linear_solver_iterations == want["iterations"]
    assert len(info["sizes"]) == want["levels"]
    assert info["operator_complexity"] == pytest.approx(want["operator_complexity"], rel=1e-12)
    assert float(l2_difference(V, x, p.exact)) == pytest.approx(want["l2_error"], rel=1e-8)


@pytest.mark.parametrize("which", ["cg", "bcgs"])
def test_amg_backends_match_jax(which):
    jgo, tgo = _ops("q1")
    jb, tb = (J_CG_AMG(), SEQ_CG_AMG()) if which == "cg" else (J_BCGS_AMG(), SEQ_BCGS_AMG())
    p = JSine()
    jV, tV = jgo.space, tgo.space
    jx0 = jpt.interpolate_dirichlet(lambda q: np.asarray(p.g(jnp.asarray(q))), jV, jgo.cg,
                                    jV.zero())
    jslp = jpt.StationaryLinearProblemSolver(jgo, jb, reduction=1e-10)
    jx = jslp.apply(jx0)
    tx0 = tpt.interpolate_dirichlet(TSine().g, tV, tgo.cg, tV.zero(F64))
    tslp = StationaryLinearProblemSolver(tgo, tb, reduction=1e-10)
    tx = tslp.apply(tx0)
    assert tslp.result.linear_solver_iterations == jslp.result.linear_solver_iterations
    assert _rel(tx.numpy(), np.asarray(jx)) <= 1e-9
    # the Krylov operator keeps the compiled stencil; the hierarchy is AMG's
    assert "compiled stencil" in tb.report() and "AlgebraicMultigrid" in tb.report()
    assert tb.precond.hierarchy_info() == pytest.approx(jb.precond.hierarchy_info(),
                                                        rel=1e-14)


def test_dg_two_level_amg_matches_jax():
    class JS(JProblem):
        def f(self, x):
            return 1.0 + x[..., 0] * x[..., 1]

    class TS(TProblem):
        def f(self, x):
            return 1.0 + x[..., 0] * x[..., 1]

    jV = jpt.FunctionSpace(jpt.StructuredMesh([0, 0], [1, 1], (8, 8)), JQkDG(1, 2))
    tV = tpt.FunctionSpace(tpt.StructuredMesh([0, 0], [1, 1], (8, 8)), tpt.QkDGFEM(1, 2))
    jgo, tgo = jpt.GridOperator(jV, JDG(JS())), tpt.GridOperator(tV, TDG(TS()))
    jtl = JTwoLevel(jgo, JFEM(JS()), coarse="amg", amg_kwargs={"max_coarse": 16})
    jtl.setup()
    ttl = DGTwoLevel(tgo, TFEM(TS()), coarse="amg", amg_kwargs={"max_coarse": 16})
    ttl.setup(torch.zeros(tV.ndofs, dtype=F64))
    assert len(ttl.amg.hierarchy_info()["sizes"]) >= 2
    for r in _rand(tV.ndofs, 2):
        want = np.asarray(jtl.apply(jnp.asarray(r)))
        assert _rel(ttl.apply(torch.from_numpy(r)).numpy(), want) <= 1e-10
    b = np.random.default_rng(5).standard_normal(tV.ndofs)
    z0 = jnp.zeros(jV.ndofs)
    _, js = jcg(lambda v: jgo.jacobian_apply(z0, v), jnp.asarray(b), M=jtl.apply, tol=1e-10)
    x0 = torch.zeros(tV.ndofs, dtype=F64)
    _, ts = cg(lambda v: tgo.jacobian_apply(x0, v), torch.from_numpy(b), M=ttl.apply,
               tol=1e-10)
    assert bool(ts.converged) and ts.iterations == int(js.iterations)


def test_failed_native_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "amg_setup.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tamg, "_SOURCE", str(bad))
    monkeypatch.setattr(tamg, "_NATIVE", None)
    S = sp.csr_matrix(np.ones((3, 3)) - np.eye(3))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        tamg._aggregate(S, np.zeros(3, bool))
    monkeypatch.setattr(tamg, "_NATIVE", None)
    # asked for, the Python aggregation runs without the library
    agg, n = tamg._aggregate(S, np.zeros(3, bool), native=False)
    assert n == 1 and np.array_equal(agg, [0, 0, 0])
