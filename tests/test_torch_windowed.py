"""The port's window-sharded GridOperator (parallel/windowed.py) against the
JAX package: the tests of tests/test_windowed.py, the config8 golden and
the composite-space, adaptive, two-phase, Stokes and adjoint modes of
__graft_entry__.dryrun_multichip (MULTICHIP_r05.json), on gloo ranks.

One RankPool of 8 CPU ranks (gloo) serves the module; the rank halves are
in tests/torch_parallel_ranks.py (no JAX). The test process computes the
JAX package's sequential values on the same seeded inputs, fp64: residuals
and J.v to 1e-10 relative, iteration counts equal, the reference tests'
solution bounds. The renumbering and the windows are held index for index
against the JAX package's WindowShardedGridOperator (built, not run), and
the face groups' element arrays, leaf DOF maps and the volume origins the
windowed operator reads against the JAX GridOperator's. The JAX values are
registered references (tests/torch_parallel_refs.py), computed ahead in
worker threads while the tests wait for their ranks.
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
from dune_pdelab_tpu.linalg import cg as jcg
from dune_pdelab_tpu.ops import ConvectionDiffusionFEM as JFEM
from dune_pdelab_tpu.ops import ConvectionDiffusionProblem as JProblem
from dune_pdelab_tpu_torch.parallel.launch import RankPool
from dune_pdelab_tpu_torch.utils.common import set_default_device

import torch_parallel_ranks as ranks
from torch_parallel_refs import References

pytestmark = pytest.mark.fast
torch.set_num_threads(1)
set_default_device("cpu")
REL = 1e-10
GOLDEN = json.loads((Path(__file__).parent / "golden_parity.json").read_text())
REFS = References()


@pytest.fixture(scope="module")
def pool():
    REFS.start()
    try:
        with RankPool(8, backend="gloo", device="cpu", timeout=600) as p:
            p.run(ranks.warm_up)
            yield p
    finally:
        REFS.stop()


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


class Problem(JProblem):
    def f(self, x):
        return jnp.sin(3 * x[..., 0]) * x[..., 1] + 1.0

    def j(self, x):
        return 0.1 * x[..., 0]


def _cd_go(n=10, dim=2, k=2):
    mesh = jpt.StructuredMesh([0] * dim, [1] * dim, (n,) * dim)
    V = jpt.FunctionSpace(mesh, jpt.QkFEM(k, dim))
    p = Problem()
    return V, jpt.GridOperator(V, JFEM(p), constraints=jpt.constraints(p.dirichlet_bctype(), V))


def _taylor_hood(n=8):
    from dune_pdelab_tpu.ops import TaylorHoodNavierStokes
    from dune_pdelab_tpu.ops.stokes import NavierStokesParameters
    from dune_pdelab_tpu.solvers.stokes import stokes_constraints, taylor_hood_space
    W = taylor_hood_space(jpt.StructuredMesh([0, 0], [1, 1], (n, n)), degree=2)
    cgm = stokes_constraints(W, bctype=True, pin_pressure=True)
    return W, jpt.GridOperator(W, TaylorHoodNavierStokes(
        NavierStokesParameters(mu=1.0, rho=0.0)), constraints=cgm)


def _outflow():
    """tests/test_windowed.py test_windowed_stokes_outflow_bc; the same
    problem and size as the dry run's mixed-BC mode."""
    from dune_pdelab_tpu.ops import TaylorHoodNavierStokes
    from dune_pdelab_tpu.solvers.stokes import taylor_hood_space
    from test_stokes_bc import Poiseuille, P0
    prm = Poiseuille(p_out=P0)
    W = taylor_hood_space(jpt.StructuredMesh([0, 0], [2.0, 1], (8, 4)), degree=2)
    cgm = jpt.constraints((prm.velocity_bctype(), None), W)
    return W, jpt.GridOperator(W, TaylorHoodNavierStokes(prm), constraints=cgm)


def _simplex_sipg():
    from dune_pdelab_tpu.fe import PkDGFEM
    from dune_pdelab_tpu.mesh import SimplexMesh
    from dune_pdelab_tpu.ops.convectiondiffusiondg import ConvectionDiffusionDG
    sm = SimplexMesh.from_structured(jpt.StructuredMesh([0, 0], [1, 1], (5, 5)))
    V = jpt.FunctionSpace(sm, PkDGFEM(1, 2))
    return V, jpt.GridOperator(V, ConvectionDiffusionDG(Problem()))


class Unit(JProblem):
    def f(self, x):
        return jnp.ones(x.shape[:-1], x.dtype)


def _adaptive(marks1, marks2=None, problem=Problem):
    from dune_pdelab_tpu.mesh.adaptive import AdaptiveMesh
    m = AdaptiveMesh([0, 0], [1, 1], (4, 4))
    for marks in (marks1, marks2):
        if marks is None:
            continue
        sel = np.zeros(m.nelements, bool)
        sel[list(marks)] = True
        m = m.refine(sel)
    V = jpt.FunctionSpace(m, jpt.QkFEM(1, 2))
    p = problem()
    cgm = jpt.constraints(p.dirichlet_bctype(), V)
    assert cgm.has_affine
    return V, jpt.GridOperator(V, JFEM(p), constraints=cgm, skip_boundary=True)


def _ccfv():
    from dune_pdelab_tpu.fe import P0FEM
    from dune_pdelab_tpu.ops.ccfv import ConvectionDiffusionCCFV
    V = jpt.FunctionSpace(jpt.StructuredMesh([0, 0], [1, 1], (6, 6)), P0FEM(2))
    return V, jpt.GridOperator(V, ConvectionDiffusionCCFV(Problem()))


def _twophase():
    from dune_pdelab_tpu.fe import P0FEM
    from dune_pdelab_tpu.ops.twophase import TwoPhaseCCFV, TwoPhaseParameters
    from dune_pdelab_tpu.space.space import PowerSpace

    class Disp(TwoPhaseParameters):
        def is_dirichlet(self, x):
            return (x[..., 0] < 1e-9) | (x[..., 0] > 1 - 1e-9)

        def g_l(self, x):
            return jnp.where(x[..., 0] < 0.5, 2.0, 0.0)

        def g_g(self, x):
            return jnp.full(x.shape[:-1], 1.5)

    prm = Disp(phi=0.2, K=lambda x: 1.0 + x[..., 0], mu_l=1.0, mu_g=0.2,
               gravity=(0.1, -0.3))
    W = PowerSpace(jpt.FunctionSpace(jpt.StructuredMesh([0, 0], [1, 1], (12, 12)),
                                     P0FEM(2)), 2)
    return W, jpt.GridOperator(W, TwoPhaseCCFV(prm))


# the JAX operators of the parity tests, by the rank side's case names
BUILDS = {
    "cd": lambda: _cd_go(10, 2, 2),
    "cd12q1": lambda: _cd_go(12, 2, 1),
    "taylor_hood": _taylor_hood,
    "outflow": _outflow,
    "simplex_sipg": _simplex_sipg,
    "adaptive": lambda: _adaptive((0, 5, 6), (0, 1)),
    "ccfv": _ccfv,
    "twophase": _twophase,
    "adaptive_unit": lambda: _adaptive((0, 5), problem=Unit),
}


@REFS.reference(("cd", 0, None, False), ("cd12q1", 0, None, False),
                ("taylor_hood", 0, None, False), ("outflow", 0, None, False),
                ("simplex_sipg", 0, None, False), ("adaptive", 0, None, False),
                ("ccfv", 0, None, True), ("twophase", 1, (0.5, 0.3), True),
                ("adaptive_unit", 2, None, False), ("twophase", 5, (0.5, 0.3), True))
def _reference(case, seed=0, x_dist=None, unconstrained=False):
    """The JAX operator's residual and J.v at the rank test's seeded x, z
    (the unconstrained CCFV and two-phase residuals jitted whole: they
    compile faster so than op by op)."""
    V, go = BUILDS[case]()
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(V.ndofs) if x_dist is None
         else rng.normal(x_dist[0], x_dist[1], V.ndofs))
    z = rng.standard_normal(V.ndofs)
    x, z = jnp.asarray(x), jnp.asarray(z)
    if unconstrained:
        r, j = jax.jit(go.residual_unconstrained)(x), jax.jit(go.jacobian_apply)(x, z)
    else:
        r, j = go.residual(x), go.jacobian_apply(x, z)
    return np.asarray(r), np.asarray(j)


def _parity(pool, case, args=(), nranks=8, seed=0, x_dist=None,
            unconstrained=False, owner=None, tol=REL, ref=None):
    """The rank side's GOS[case](*args) against the JAX operator BUILDS[ref]
    (default: the same name)."""
    task = pool.submit(ranks.residual_jvp, case, args, owner=owner, seed=seed, x_dist=x_dist,
                       nranks=nranks)
    r, j = _reference(ref or case, seed, x_dist, unconstrained)
    out = task.result()[0]
    assert _rel(out["r"], r) < tol
    assert _rel(out["j"], j) < tol
    return out


# ---- the interface the windowed operator reads --------------------------------
def test_face_groups_and_origins_match_reference():
    """Each face group's elements (inside and outside), its per-leaf DOF
    maps (materialised from the port's slabs) and the volume origins equal
    the JAX GridOperator's, on structured C0 (boundary groups) and DG
    (skeleton groups) operators."""
    from dune_pdelab_tpu.fe import QkDGFEM
    from dune_pdelab_tpu.ops.convectiondiffusiondg import ConvectionDiffusionDG
    for dim, cells in ((2, (5, 4)), (3, (3, 4, 2))):
        jmesh = jpt.StructuredMesh([0] * dim, [1] * dim, cells)
        tmesh = tpt.StructuredMesh([0] * dim, [1] * dim, cells)
        pairs = []
        jV = jpt.FunctionSpace(jmesh, jpt.QkFEM(2, dim))
        tV = tpt.FunctionSpace(tmesh, tpt.QkFEM(2, dim))
        pairs.append((jpt.GridOperator(jV, JFEM(Problem())),
                      tpt.GridOperator(tV, ranks.ConvectionDiffusionFEM(ranks.Problem()))))
        jD = jpt.FunctionSpace(jmesh, QkDGFEM(1, dim))
        tD = tpt.FunctionSpace(tmesh, tpt.QkDGFEM(1, dim))
        pairs.append((jpt.GridOperator(jD, ConvectionDiffusionDG(Problem())),
                      tpt.GridOperator(tD, ranks.ConvectionDiffusionDG(ranks.Problem()))))
        for jgo, tgo in pairs:
            np.testing.assert_array_equal(tgo.vol_geo.origins, np.asarray(jgo.vol_geo.origins))
            assert len(jgo.bnd_groups) + len(jgo.skel_groups) > 0
            for jgs, tgs in ((jgo.bnd_groups, tgo.bnd_groups), (jgo.skel_groups, tgo.skel_groups)):
                assert len(jgs) == len(tgs)
                for jg, tg in zip(jgs, tgs):
                    np.testing.assert_array_equal(tgo.group_elements(tg), jg.elements)
                    for a, b in zip(tgo.group_leaf_dofs(tg), jg.leaf_dofs_in):
                        np.testing.assert_array_equal(a, b)
                    if jg.outside is not None:
                        np.testing.assert_array_equal(tgo.group_elements(tg, True), jg.outside)
                        for a, b in zip(tgo.group_leaf_dofs(tg, True), jg.leaf_dofs_out):
                            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case,build,args,n,owner", [
    ("cd", _cd_go, (10, 2, 2), 3, None),
    ("cd", lambda: _cd_go(12, 2, 1), (12, 2, 1), 8, (2, 4)),
    ("adaptive", lambda: _adaptive((0, 5, 6), (0, 1)), ((0, 5, 6), (0, 1)), 8, None),
])
def test_window_renumbering_matches_reference(pool, case, build, args, n, owner):
    """The (owner, index) renumbering, the block size, every rank's window
    (hanging-node parents included) and the padded mask, index for index
    with the JAX package's WindowShardedGridOperator."""
    from dune_pdelab_tpu.parallel.windowed import WindowShardedGridOperator, block_partition
    task = pool.submit(ranks.window_layout, case, args, owner=owner, nranks=n)
    V, go = build()
    eo = None if owner is None else block_partition(go.mesh, owner)
    w = WindowShardedGridOperator(go, devices=jax.devices()[:n], element_owner=eo)
    out = task.result()[0]
    np.testing.assert_array_equal(out["pi"], w._pi)
    assert out["B"] == w.B and out["NP"] == w.NP
    assert len(out["wins"]) == len(w._wins)
    for a, b in zip(out["wins"], w._wins):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(out["mask"], np.asarray(w.mask_padded))


# ---- tests/test_windowed.py -----------------------------------------------------
@pytest.mark.parametrize("ndev", [1, 3, 8])
def test_windowed_cd_q2_parity(pool, ndev):
    _parity(pool, "cd", (10, 2, 2), nranks=ndev)


@pytest.mark.parametrize("case,args,owner", [
    ("taylor_hood", (), None), ("cd", (12, 2, 1), (2, 4)), ("adaptive", ((5, 10),), None)])
def test_flat_jacobian_apply_equals_padded(pool, case, args, owner):
    """The flat J.v on full vectors (one all-gather of window results)
    equals the padded path (halo exchange, combine, gather) bit for bit:
    composite space, a block partition, hanging nodes."""
    for r in pool.run(ranks.flat_jv_equals_padded, case, args, owner):
        assert r["equal"], r["max_diff"]
        assert r["flat_calls"] == 1


def test_windowed_2d_device_mesh_block_partition(pool):
    """A (2, 4) rank grid with the block partition: halo-sized windows."""
    V, _ = _cd_go(12, 2, 1)
    out = _parity(pool, "cd", (12, 2, 1), owner=(2, 4), ref="cd12q1")
    assert out["npeers"] >= 2
    assert out["W"] < V.ndofs


@REFS.reference(("cd8q1",), ("adaptive510",))
def _jacobi_cg(case):
    """Jacobi-CG to 1e-12 at zero with the JAX operator: iterations and z."""
    V, go = {"cd8q1": lambda: _cd_go(8, 2, 1), "adaptive510": lambda: _adaptive((5, 10))}[case]()
    x0 = V.zero()
    b = go.residual(x0)
    d = go.jacobian_diagonal(x0)
    z1, s1 = jcg(lambda q: go.jacobian_apply(x0, q), b, M=lambda r: r / d, tol=1e-12)
    return int(s1.iterations), np.asarray(z1)


def test_windowed_cg_iteration_parity(pool):
    task = pool.submit(ranks.solve_windowed, "cd", (8, 2, 1), how="solve_cg")
    its, z1 = _jacobi_cg("cd8q1")
    out = task.result()[0]
    assert out["its"] == its
    assert float(np.linalg.norm(out["z"] - z1)) < 1e-10


def test_windowed_taylor_hood_stokes(pool):
    """A composite (Taylor-Hood) space under the window sharding."""
    _parity(pool, "taylor_hood")


def test_windowed_stokes_outflow_bc(pool):
    """Mixed boundary conditions (Dirichlet inflow and walls, stress-Neumann
    outflow): bctype-dependent alpha and lambda boundary terms land in the
    right windows. The dry run's mixed-BC mode is this problem at this
    size."""
    _parity(pool, "outflow")


def test_windowed_simplex_sipg(pool):
    """Simplex mesh + DG skeleton terms (per-face geometry and tabs)."""
    _parity(pool, "simplex_sipg")


def test_windowed_adaptive_hanging_nodes(pool):
    """Hanging-node (affine) constraints: window-local prolong and
    restrict-transpose reproduce the sequential P / P^T."""
    _parity(pool, "adaptive", ((0, 5, 6), (0, 1)))


def test_windowed_adaptive_solve_parity(pool):
    task = pool.submit(ranks.adaptive_solve)
    its, z1 = _jacobi_cg("adaptive510")
    out = task.result()[0]
    assert out["its"] == its
    assert float(np.linalg.norm(out["z"] - z1)) < 1e-9


def test_windowed_comm_is_halo_only(pool):
    """A distributed residual (and J.v) communicates by neighbour exchanges
    only: no collective, every buffer at most a window, never a vector."""
    res = pool.run(ranks.comm_of_residual)
    for out in res:
        for kind in ("residual", "jvp"):
            assert set(out[kind]) <= {"sendrecv"}, out[kind]
            assert out[kind].get("sendrecv", {"largest": 0})["largest"] <= out["W"]
        assert out["W"] < out["N"]
    assert any(out["residual"] for out in res)


def test_sharded_alias_is_windowed(pool):
    out = pool.run(ranks.alias_diag)[0]
    assert out["sub"] and out["diff"] == 0.0


def test_windowed_ccfv_p0_parity(pool):
    _parity(pool, "ccfv", nranks=2, unconstrained=True)


def test_windowed_twophase_parity(pool):
    """Two-phase CCFV on PowerSpace(P0, 2) (heterogeneous K, gravity,
    Dirichlet and no-flow) on 8 ranks."""
    _parity(pool, "twophase", seed=1, x_dist=(0.5, 0.3), unconstrained=True)


@REFS.reference((8, 1e-13, 2000), (6, 1e-7, 500))
def _jax_adjoint(n, tol, maxiter):
    from dune_pdelab_tpu.solvers import implicit_solve
    V = jpt.FunctionSpace(jpt.StructuredMesh([0, 0], [1, 1], (n, n)), jpt.QkFEM(1, 2))
    cons = jpt.constraints(True, V)

    def factory(theta):
        class P(JProblem):
            def A(self, x):
                a = theta[0] + theta[1] * x[..., 0]
                return a[..., None, None] * jnp.eye(x.shape[-1], dtype=x.dtype)

            def f(self, x):
                return jnp.ones(x.shape[:-1], x.dtype)
        return JFEM(P())

    def R_seq(x, theta):
        return jpt.GridOperator(V, factory(theta), constraints=cons).residual(x)

    def forward(theta):
        go = jpt.GridOperator(V, factory(theta), constraints=cons)
        x0 = jnp.zeros(V.ndofs)
        z, _ = jcg(lambda p: go.jacobian_apply(x0, p), go.residual(x0), tol=tol,
                   maxiter=maxiter)
        return x0 - z

    f = implicit_solve(R_seq, forward, constraints=cons, adjoint_tol=tol,
                       adjoint_maxiter=maxiter)
    return np.asarray(jax.grad(lambda t: jnp.sum(f(t) ** 2))(jnp.array([1.0, 0.5])))


@pytest.mark.parametrize("n,tol,maxiter", [(8, 1e-13, 2000), (6, 1e-7, 500)])
def test_windowed_adjoint_gradient_parity(pool, n, tol, maxiter):
    """Adjoint gradients through the window-sharded residual (torch.func.vjp
    through the exchange, the combine and the all-gather; the parameters
    marked `replicated`) equal the JAX package's sequential ones; n = 6 at
    1e-7 is the dry run's mode."""
    task = pool.submit(ranks.adjoint_gradient, n, tol, maxiter)
    g = _jax_adjoint(n, tol, maxiter)
    out = task.result()[0]
    assert _rel(out["shard"], g) < (1e-10 if tol < 1e-10 else 1e-8)
    assert _rel(out["seq"], g) < (1e-10 if tol < 1e-10 else 1e-8)


@REFS.reference()
def _jax_instationary():
    """Three implicit-Euler steps of the JAX package's heat equation."""
    from dune_pdelab_tpu.instationary import OneStepMethod, implicit_euler
    from dune_pdelab_tpu.ops import L2
    from dune_pdelab_tpu.solvers import SEQ_CG_Jacobi

    class Heat(Problem):
        def g(self, x):
            return x[..., 0] * 0.0

    p = Heat()
    V = jpt.FunctionSpace(jpt.StructuredMesh([0, 0], [1, 1], (8, 8)), jpt.QkFEM(1, 2))
    cgm = jpt.constraints(p.dirichlet_bctype(), V)
    osm = OneStepMethod(implicit_euler(), jpt.GridOperator(V, JFEM(p), constraints=cgm),
                        jpt.GridOperator(V, L2(), constraints=cgm),
                        SEQ_CG_Jacobi(use_stencil=False), pdesolver="newton",
                        reduction=1e-10, max_iterations=20, min_linear_reduction=1e-6)
    x = V.zero()
    t, dt = 0.0, 0.05
    for _ in range(3):
        x = osm.apply(t, dt, x)
        t += dt
    return np.asarray(x)


def test_windowed_instationary_trajectory_parity(pool):
    """Three implicit-Euler steps of the heat equation through window-sharded
    go0 / go1 (OneStepMethod + Newton + CG unchanged) reproduce the JAX
    package's sequential trajectory."""
    task = pool.submit(ranks.instationary)
    x = _jax_instationary()
    out = task.result()[0]
    assert np.abs(out["par"] - out["seq"]).max() < 1e-13
    assert np.abs(out["par"] - x).max() < 1e-12


def test_config8_golden(pool):
    """config8_windowed_sharded on 8 ranks: tests/golden_parity.json."""
    gold = GOLDEN["config8_windowed_sharded"]
    out = pool.run(ranks.config8)[0]
    assert out["iterations"] == gold["iterations"]
    assert out["ndofs"] == gold["ndofs"] and out["ndevices"] == gold["ndevices"]
    assert abs(out["l2_error"] - gold["l2_error"]) < 1e-8 * gold["l2_error"]


# ---- __graft_entry__.dryrun_multichip modes at its sizes, 8 ranks ---------------
@REFS.memo
def _th_graft():
    """Modes 6 and 6b's JAX operator (8^2 Taylor-Hood), x0 = 0, the seeded
    x and b = R(x)."""
    W, go = _taylor_hood(8)
    xr = jnp.asarray(np.random.default_rng(7).standard_normal(W.ndofs))
    return go, W.zero(), xr, go.residual(xr)


def _th_true_rel(z):
    """The true relative residual of a solution, taken with the JAX operator."""
    go, x0, _, bs = _th_graft()
    return float(jnp.linalg.norm(go.jacobian_apply(x0, jnp.asarray(z)) - bs)
                 / jnp.linalg.norm(bs))


@REFS.reference()
def _jax_th_gmres():
    """Mode 6's J.v at x and unpreconditioned GMRES(80) iterations."""
    from dune_pdelab_tpu.linalg.krylov import restarted_gmres as jgmres
    go, x0, xr, bs = _th_graft()
    _, s1 = jax.jit(lambda b: jgmres(lambda p: go.jacobian_apply(x0, p), b, tol=1e-5,
                                     maxiter=400, restart=80))(bs)
    return np.asarray(go.jacobian_apply(x0, xr)), int(s1.iterations)


def test_multichip_taylor_hood_gmres(pool):
    """Mode 6: the 8^2 Taylor-Hood J.v and unpreconditioned GMRES(80) to
    1e-5 through the sharded operator: the JAX package's 400 iterations,
    the true relative residual (with the JAX operator) under 1e-3."""
    task = pool.submit(ranks.graft_stokes, False)
    y, its = _jax_th_gmres()
    out = task.result()[0]
    assert _rel(out["y"], y) < REL
    assert out["its"] == its
    assert _th_true_rel(out["z"]) < 1e-3


def test_multichip_gmg_schur_gmres(pool):
    """Mode 6b: StokesGMGSchur-preconditioned GMRES through the sharded
    operator: under 100 iterations, true relative residual (with the JAX
    operator) under 5e-5."""
    task = pool.submit(ranks.graft_stokes, True)
    out = task.result()[0]
    assert out["its"] < 100 and _th_true_rel(out["z"]) < 5e-5


def test_multichip_adaptive_and_twophase(pool):
    """Modes 8 and 11: the adaptive mesh refined at elements (0, 5) and the
    two-phase operator at x ~ N(0.5, 0.3) (seed 5), 8 ranks."""
    _parity(pool, "adaptive_unit", ((0, 5),), seed=2)
    _parity(pool, "twophase", seed=5, x_dist=(0.5, 0.3), unconstrained=True)


def test_sharded_context_mixin_matches_reference():
    """ShardedContextMixin's uniform-mesh volume and face contexts, built
    from element origins and face points, equal the JAX package's mixin's
    (volume) and the port GridOperator's own (faces)."""
    from dune_pdelab_tpu.parallel import ShardedContextMixin as JMixin
    from dune_pdelab_tpu_torch.parallel import ShardedContextMixin

    class J(JMixin):
        def __init__(self, go):
            self.go = go

    class T(ShardedContextMixin):
        def __init__(self, go):
            self.go = go

    jV, jgo = _cd_go(5, 2, 2)
    tV = tpt.FunctionSpace(tpt.StructuredMesh([0, 0], [1, 1], (5, 5)), tpt.QkFEM(2, 2))
    tgo = tpt.GridOperator(tV, ranks.ConvectionDiffusionFEM(ranks.Problem()))
    sel = np.array([0, 3, 7, 24])
    f64 = torch.float64
    jv = J(jgo)._vol_ctx(jnp.asarray(jgo.vol_geo.origins[sel]), 0.0, jnp.float64)
    tv = T(tgo)._vol_ctx(torch.as_tensor(tgo.vol_geo.origins[sel]), 0.0, f64)
    for name in ("x", "weights", "factor", "jac_inv_T", "cell_volume"):
        np.testing.assert_allclose(getattr(tv, name).numpy(), np.asarray(getattr(jv, name)),
                                   rtol=0, atol=1e-15)
    np.testing.assert_allclose(tv.tab.grad.numpy(), np.asarray(jv.tab.grad), rtol=0, atol=1e-12)
    m = T(tgo)
    assert m.space is tV and m.lop is tgo.lop
    for g in tgo.bnd_groups:
        full = tgo._face_ctx(g, 0.0, f64, "cpu")
        f = m._face_ctx(g, full.x[:2], 0.0, f64)
        assert torch.equal(f.x, full.x[:2]) and torch.equal(f.normal, full.normal)
        assert torch.equal(f.factor, full.factor) and torch.equal(f.h_inside, full.h_inside)
