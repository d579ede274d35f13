"""Parity of the port's GeometricMultigrid with the JAX package (fp64).

  * build_prolongation: indices equal, weights to 1e-15, and exact on
    polynomials of the element degree;
  * one V-cycle (Chebyshev smoother) and one W-cycle (Jacobi) through
    interop.geometric_mg_from_numpy, the JAX multigrid's own state, to
    1e-12 relative; the port's own Chebyshev setup, handed the reference's
    start vectors (power_v0), finds its lambda_max to 1e-12;
  * CG + GeometricMultigrid (Jacobi) built by the port itself: the JAX
    package's iteration counts on 2D Q1 (and its solution to 1e-10), and
    on 3D Q2 through config2_poisson_3d_gmg(cells=8) (L2 to 1e-10
    relative); the config2 golden at 16^3 (9 iterations, 4 levels, L2 to
    1e-8 relative);
  * the setup cache (counterpart of tests/test_solver_semantics.py:131):
    one setup for a linear operator over two solves; a new setup for a
    nonlinear operator at a new linearization point and for an opaque
    stage time;
  * DGTwoLevel(gmg_kwargs=...) (GeometricMultigrid on the Q1 subspace):
    one cycle against the JAX one to 1e-12 and the JAX package's CG count.
"""
import json
from pathlib import Path

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import dune_pdelab_tpu as jpt
import dune_pdelab_tpu_torch as tpt
from dune_pdelab_tpu.fe import QkDGFEM as JQkDG
from dune_pdelab_tpu.linalg import DGTwoLevel as JTwoLevel
from dune_pdelab_tpu.linalg.multigrid import GeometricMultigrid as JGMG
from dune_pdelab_tpu.linalg.multigrid import build_prolongation as j_prolongation
from dune_pdelab_tpu.ops import ConvectionDiffusionFEM as JFEM
from dune_pdelab_tpu.ops import ConvectionDiffusionProblem as JProblem
from dune_pdelab_tpu.ops.convectiondiffusiondg import ConvectionDiffusionDG as JDG
from dune_pdelab_tpu.solvers import LinearSolverBackend as JBackend
from dune_pdelab_tpu_torch.instationary import StageContext
from dune_pdelab_tpu_torch.interop import geometric_mg_from_numpy
from dune_pdelab_tpu_torch.linalg import DGTwoLevel
from dune_pdelab_tpu_torch.linalg.multigrid import GeometricMultigrid, build_prolongation
from dune_pdelab_tpu_torch.ops import ConvectionDiffusionDG as TDG
from dune_pdelab_tpu_torch.ops import ConvectionDiffusionFEM as TFEM
from dune_pdelab_tpu_torch.ops import ConvectionDiffusionProblem as TProblem
from dune_pdelab_tpu_torch.ops import NonlinearConvectionDiffusionFEM
from dune_pdelab_tpu_torch.ops import NonlinearConvectionDiffusionProblem
from dune_pdelab_tpu_torch.solvers import LinearSolverBackend
from dune_pdelab_tpu_torch.space.functions import l2_difference
from dune_pdelab_tpu_torch.utils.common import set_default_device

pytestmark = pytest.mark.fast
torch.set_num_threads(1)
set_default_device("cpu")
F64 = torch.float64
PI = np.pi
GOLDEN = json.loads((Path(__file__).parent / "golden_parity.json").read_text())


class JSine2D(JProblem):
    def f(self, x):
        return 5 * PI**2 * jnp.sin(PI * x[..., 0]) * jnp.cos(2 * PI * x[..., 1])

    def g(self, x):
        return jnp.sin(PI * x[..., 0]) * jnp.cos(2 * PI * x[..., 1]) + x[..., 0]


class TSine2D(TProblem):
    def exact(self, p):
        return torch.sin(PI * p[:, 0]) * torch.cos(2 * PI * p[:, 1]) + p[:, 0]

    def f(self, x):
        return 5 * PI**2 * torch.sin(PI * x[..., 0]) * torch.cos(2 * PI * x[..., 1])

    def g(self, x):
        return torch.sin(PI * x[..., 0]) * torch.cos(2 * PI * x[..., 1]) + x[..., 0]


class TSine3D(TProblem):
    """models/configs.py _Sine3D."""

    def exact(self, p):
        return torch.sin(PI * p[:, 0]) * torch.sin(PI * p[:, 1]) * torch.sin(PI * p[:, 2])

    def f(self, x):
        return 3 * PI**2 * (torch.sin(PI * x[..., 0]) * torch.sin(PI * x[..., 1])
                            * torch.sin(PI * x[..., 2]))


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("dim,k", [(2, 1), (2, 2), (3, 2)])
def test_build_prolongation_matches_jax(dim, k):
    cells = (3, 4, 2)[:dim]
    lo, hi = [0.0] * dim, [1.0] * dim
    jm = jpt.StructuredMesh(lo, hi, cells)
    tm = tpt.StructuredMesh(lo, hi, cells)
    want_i, want_w = j_prolongation(jpt.FunctionSpace(jm, jpt.QkFEM(k, dim)),
                                    jpt.FunctionSpace(jm.refine(), jpt.QkFEM(k, dim)))
    Vc = tpt.FunctionSpace(tm, tpt.QkFEM(k, dim))
    Vf = tpt.FunctionSpace(tm.refine(), tpt.QkFEM(k, dim))
    idx, w = build_prolongation(Vc, Vf)
    assert idx.dtype == np.int32 and np.array_equal(idx, want_i)
    assert np.abs(w - want_w).max() <= 1e-15
    f = lambda p: (p[:, 0] + 0.3) ** k + (p[:, -1] - 0.2) ** k
    xc = Vc.interpolate(f, dtype=F64).numpy()
    assert np.allclose((w * xc[idx]).sum(axis=1), Vf.interpolate(f, dtype=F64).numpy(),
                       atol=1e-12)


@pytest.mark.parametrize("cycle,smoother,nlevels", [("v", "chebyshev", 2),
                                                    ("w", "jacobi", 3)])
def test_cycle_from_jax_state_matches_jax(cycle, smoother, nlevels):
    p_j, p_t = JSine2D(), TSine2D()
    n, k = 4, 2
    mj = jpt.StructuredMesh([0, 0], [1, 1], (n, n))
    jg = JGMG(JFEM(p_j), mj, jpt.QkFEM(k, 2), bctype=p_j.dirichlet_bctype(),
              cycle=cycle, smoother=smoother, coarsest_cells=1, nlevels=nlevels)
    jg.setup()
    mt = tpt.StructuredMesh([0, 0], [1, 1], (n, n))
    lu, piv = jg._coarse_lu
    tg = geometric_mg_from_numpy(
        TFEM(p_t), mt, tpt.QkFEM(k, 2), jg.transfers,
        [np.asarray(d) for d in jg._diags], (np.asarray(lu), np.asarray(piv)),
        bctype=p_t.dirichlet_bctype(), device="cpu",
        lmax=None if smoother == "jacobi" else [np.asarray(v) for v in jg._lmax],
        cycle=cycle, smoother=smoother, coarsest_cells=1)
    assert tg.nlevels == jg.nlevels == nlevels
    r = np.random.default_rng(7).standard_normal(tg.spaces[0].ndofs)
    want = np.asarray(jg.apply(jnp.asarray(r)))
    assert _rel(tg.apply(torch.from_numpy(r)).numpy(), want) <= 1e-12
    if smoother == "chebyshev":
        # the port's own setup, handed the reference's power-iteration start
        # vectors (jax.random, key 0 per level), finds its lambda_max
        v0 = [np.asarray(jax.random.normal(jax.random.PRNGKey(0), (s.ndofs,), jnp.float64))
              for s in tg.spaces]
        own = GeometricMultigrid(TFEM(p_t), mt, tpt.QkFEM(k, 2), bctype=p_t.dirichlet_bctype(),
                                 smoother="chebyshev", coarsest_cells=1, nlevels=nlevels,
                                 device="cpu", power_v0=v0)
        own.setup(dtype=F64)
        for got, ref in zip(own._lmax, jg._lmax):
            assert float(got) == pytest.approx(float(ref), rel=1e-12)
        assert _rel(own.apply(torch.from_numpy(r)).numpy(), want) <= 1e-12


def test_cg_gmg_2d_q1_matches_jax():
    p_j, p_t = JSine2D(), TSine2D()
    n = 8
    jV = jpt.FunctionSpace(jpt.StructuredMesh([0, 0], [1, 1], (n, n)), jpt.QkFEM(1, 2))
    jcg = jpt.constraints(p_j.dirichlet_bctype(), jV)
    jgo = jpt.GridOperator(jV, JFEM(p_j), constraints=jcg)
    jgmg = JGMG(JFEM(p_j), jV.mesh, jpt.QkFEM(1, 2), bctype=p_j.dirichlet_bctype())
    js = jpt.StationaryLinearProblemSolver(jgo, JBackend(solver="cg", precond=jgmg),
                                           reduction=1e-10, verbose=0)
    xj = js.apply(jpt.interpolate_dirichlet(
        lambda q: np.asarray(p_j.g(jnp.asarray(q))), jV, jcg, jV.zero()))
    mesh = tpt.StructuredMesh([0, 0], [1, 1], (n, n))
    V = tpt.FunctionSpace(mesh, tpt.QkFEM(1, 2))
    cgm = tpt.constraints(p_t.dirichlet_bctype(), V)
    go = tpt.GridOperator(V, TFEM(p_t), constraints=cgm)
    gmg = GeometricMultigrid(TFEM(p_t), mesh, tpt.QkFEM(1, 2), bctype=p_t.dirichlet_bctype())
    ls = LinearSolverBackend(solver="cg", precond=gmg)
    s = tpt.StationaryLinearProblemSolver(go, ls, reduction=1e-10, verbose=0)
    x = s.apply(tpt.interpolate_dirichlet(p_t.g, V, cgm, V.zero(F64)))
    assert "custom preconditioner GeometricMultigrid" in ls.report(go)
    assert gmg.nlevels == jgmg.nlevels == 3 and s.result.converged
    assert s.result.linear_solver_iterations == js.result.linear_solver_iterations
    assert _rel(x.numpy(), xj) <= 1e-10


def _config2(cells):
    """models/configs.py config2_poisson_3d_gmg on the port."""
    p = TSine3D()
    mesh = tpt.StructuredMesh([0.0] * 3, [1.0] * 3, (cells,) * 3)
    V = tpt.FunctionSpace(mesh, tpt.QkFEM(2, 3))
    go = tpt.GridOperator(V, TFEM(p), constraints=tpt.constraints(p.dirichlet_bctype(), V))
    gmg = GeometricMultigrid(TFEM(p), mesh, tpt.QkFEM(2, 3), bctype=p.dirichlet_bctype())
    s = tpt.StationaryLinearProblemSolver(
        go, LinearSolverBackend(solver="cg", precond=gmg), reduction=1e-10, verbose=0)
    x = s.apply(V.zero(F64))
    return {"l2_error": float(l2_difference(V, x, p.exact)),
            "iterations": s.result.linear_solver_iterations, "ndofs": V.ndofs,
            "levels": gmg.nlevels, "converged": s.result.converged}


def test_config2_3d_q2_matches_jax_run():
    from dune_pdelab_tpu.models.configs import config2_poisson_3d_gmg

    want = config2_poisson_3d_gmg(cells=8)
    got = _config2(8)
    assert got["converged"] and want["converged"]
    for key in ("iterations", "ndofs", "levels"):
        assert got[key] == want[key]
    assert got["l2_error"] == pytest.approx(want["l2_error"], rel=1e-10)


def test_config2_golden():
    want = GOLDEN["config2_poisson_3d_gmg"]
    got = _config2(16)
    assert got["converged"]
    assert (got["iterations"], got["levels"], got["ndofs"]) == (
        want["iterations"], want["levels"], want["ndofs"])
    assert got["l2_error"] == pytest.approx(want["l2_error"], rel=1e-8)


class TNonlinear(NonlinearConvectionDiffusionProblem):
    def v(self, x, u):
        return 1.0 + u * u


def test_setup_cached_per_linearization_point():
    p = TSine2D()
    mesh = tpt.StructuredMesh([0, 0], [1, 1], (16, 16))
    V = tpt.FunctionSpace(mesh, tpt.QkFEM(1, 2))
    go = tpt.GridOperator(V, TFEM(p), constraints=tpt.constraints(p.dirichlet_bctype(), V))
    gmg = GeometricMultigrid(TFEM(p), mesh, tpt.QkFEM(1, 2), bctype=p.dirichlet_bctype())
    calls = {"n": 0}
    orig = gmg.setup

    def counting_setup(*a, **k):
        calls["n"] += 1
        return orig(*a, **k)

    gmg.setup = counting_setup
    s = tpt.StationaryLinearProblemSolver(
        go, LinearSolverBackend(solver="cg", precond=gmg, use_stencil=False),
        reduction=1e-10, verbose=0)
    x = s.apply(V.zero(F64))
    s.apply(x)                                  # second solve: same linear operator
    assert calls["n"] == 1, calls

    lop = NonlinearConvectionDiffusionFEM(TNonlinear())
    ngmg = GeometricMultigrid(lop, mesh, tpt.QkFEM(1, 2), bctype=True)
    ngmg.setup = lambda *a, _o=ngmg.setup, **k: (calls.__setitem__("n", calls["n"] + 1),
                                                  _o(*a, **k))[1]
    calls["n"] = 0
    x0 = torch.zeros(V.ndofs, dtype=F64)
    M0 = ngmg(None, x0, 0.0)
    assert ngmg(None, x0.clone(), 0.0) is M0 and calls["n"] == 1
    ngmg(None, x0 + 0.5, 0.0)
    assert calls["n"] == 2
    sc = StageContext(t=0.0, wa=1.0, wb=0.01, const=None)
    ngmg(None, x0 + 0.5, sc)
    ngmg(None, x0 + 0.5, sc)
    assert calls["n"] == 4                      # an opaque time sets up each time


class JSource(JProblem):
    def f(self, x):
        return 1.0 + x[..., 0] * x[..., 1]


class TSource(TProblem):
    def f(self, x):
        return 1.0 + x[..., 0] * x[..., 1]


def test_dg_two_level_gmg_kwargs_match_jax():
    cells, kw = (8, 8), {"pre_sweeps": 1, "post_sweeps": 1, "omega": 0.7}
    jV = jpt.FunctionSpace(jpt.StructuredMesh([0, 0], [1, 1], cells), JQkDG(1, 2))
    tV = tpt.FunctionSpace(tpt.StructuredMesh([0, 0], [1, 1], cells), tpt.QkDGFEM(1, 2))
    jgo, tgo = jpt.GridOperator(jV, JDG(JSource())), tpt.GridOperator(tV, TDG(TSource()))
    jtl = JTwoLevel(jgo, JFEM(JSource()), gmg_kwargs=kw)
    jtl.setup()
    jtl._setup_key = 0                  # a linear operator: the solve keeps it
    tl = DGTwoLevel(tgo, TFEM(TSource()), gmg_kwargs=kw)
    tl.setup(torch.zeros(tV.ndofs, dtype=F64))
    tl._setup_key = 0
    assert tl.gmg_lattice is None and tl.gmg.nlevels == jtl.gmg.nlevels == 3
    r = np.random.default_rng(11).standard_normal(tV.ndofs)
    assert _rel(tl.apply(torch.from_numpy(r)).numpy(), jtl.apply(jnp.asarray(r))) <= 1e-12
    b = np.array(jgo.residual(jnp.zeros(jV.ndofs)))
    _, js = JBackend(solver="cg", precond=jtl, use_stencil=False).solve(
        jgo, jnp.zeros(jV.ndofs), jnp.asarray(b), 1e-10)
    _, s = LinearSolverBackend(solver="cg", precond=tl, use_stencil=False).solve(
        tgo, torch.zeros(tV.ndofs, dtype=F64), torch.from_numpy(b), 1e-10)
    assert bool(s.converged) and s.iterations == int(js.iterations)
