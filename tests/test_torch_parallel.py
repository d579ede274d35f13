"""The port's parallel package (dune_pdelab_tpu_torch/parallel) against the
JAX package: the tests of tests/test_parallel.py and the DOF-sharded,
element-sharded, DG, geometric-multigrid and data-handle modes of
__graft_entry__.dryrun_multichip (MULTICHIP_r05.json), on gloo ranks.

One RankPool of 8 CPU ranks (gloo, FileStore rendezvous) serves the
module; a test that needs k ranks runs on the subgroup of the first k. The
rank halves live in tests/torch_parallel_ranks.py, which imports no JAX;
the test process computes the JAX package's sequential values on the same
seeded inputs (the reference's oracle: the sharded operator equals the
sequential one) and compares, fp64: residuals and J.v to 1e-10 relative,
solutions to the reference tests' bounds, iteration counts equal. The JAX
values are registered references (tests/torch_parallel_refs.py), computed
ahead in worker threads while the tests wait for their ranks.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import dune_pdelab_tpu as jpt
from dune_pdelab_tpu.linalg import cg as jcg
from dune_pdelab_tpu.ops import ConvectionDiffusionFEM as JFEM
from dune_pdelab_tpu.ops import ConvectionDiffusionProblem as JProblem
from dune_pdelab_tpu_torch.parallel import pad_partition, partition_weighted, imbalance
from dune_pdelab_tpu_torch.parallel.launch import RankError, RankPool
from dune_pdelab_tpu_torch.utils.common import set_default_device

import torch_parallel_ranks as ranks
from torch_parallel_refs import References

pytestmark = pytest.mark.fast
torch.set_num_threads(1)
set_default_device("cpu")
REL = 1e-10
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


class Unit(JProblem):
    def f(self, x):
        return jnp.ones(x.shape[:-1], x.dtype)


def _ops(n=10, dim=2, k=2):
    mesh = jpt.StructuredMesh([0] * dim, [1] * dim, (n,) * dim)
    V = jpt.FunctionSpace(mesh, jpt.QkFEM(k, dim))
    p = Problem()
    return V, jpt.GridOperator(V, JFEM(p), constraints=jpt.constraints(p.dirichlet_bctype(), V))


def _dg_ops(n, problem):
    from dune_pdelab_tpu.fe import QkDGFEM
    from dune_pdelab_tpu.ops.convectiondiffusiondg import ConvectionDiffusionDG, DGMethod
    mesh = jpt.StructuredMesh([0, 0], [1, 1], (n, n))
    V = jpt.FunctionSpace(mesh, QkDGFEM(1, 2))
    return V, jpt.GridOperator(V, ConvectionDiffusionDG(problem, method=DGMethod.SIPG))


@REFS.reference(("cd", 10, 0), ("cd8q1", 8, 1), ("cd", 10, 5), ("dg", 12, 6))
def _jax_residual_jvp(case, n, seed):
    """The JAX package's residual and J.v at the rank test's seeded x, z."""
    V, go = {"cd": lambda: _ops(n), "cd8q1": lambda: _ops(n, 2, 1),
             "dg": lambda: _dg_ops(n, Problem())}[case]()
    rng = np.random.default_rng(seed)
    x = jnp.asarray(rng.standard_normal(V.ndofs))
    z = jnp.asarray(rng.standard_normal(V.ndofs))
    return np.asarray(go.residual(x)), np.asarray(go.jacobian_apply(x, z))


@REFS.reference((8, 1), (12, 2))
def _jax_jacobi_cg(n, k):
    """Jacobi-CG to 1e-12 on _ops(n, 2, k) at zero: iterations and z."""
    V, go = _ops(n=n, dim=2, k=k)
    x0 = V.zero()
    b = go.residual(x0)
    d = go.jacobian_diagonal(x0)
    z1, s1 = jcg(lambda p: go.jacobian_apply(x0, p), b, M=lambda r: r / d, tol=1e-12)
    return int(s1.iterations), np.asarray(z1)


def test_pad_partition_mask():
    from dune_pdelab_tpu.parallel import pad_partition as j_pad
    a = np.arange(10)[:, None]
    (ap,), mask = pad_partition([a], 4)
    assert ap.shape == (4, 3, 1)
    assert mask.sum() == 10
    assert mask[-1, -1] == 0.0
    (jap,), jmask = j_pad([a], 4)
    np.testing.assert_array_equal(ap, jap)
    np.testing.assert_array_equal(mask, jmask)


def test_launcher_children_import_no_jax(pool):
    """No rank process holds a module of JAX or of the JAX package."""
    assert pool.run(ranks.imported_modules) == [[]] * 8


def test_launcher_reports_a_failing_rank(pool):
    with pytest.raises(RankError, match="fails on purpose"):
        pool.run(ranks.fail_on, 1, nranks=2)
    assert pool.run(ranks.fail_on, 99, nranks=3) == [0, 1, 2]   # the pool starts again
    pool.run(ranks.warm_up)


@pytest.mark.parametrize("ndev", [1, 2, 4, 8])
def test_sharded_residual_matches(pool, ndev):
    task = pool.submit(ranks.residual_jvp, "cd", (10, 2, 2), cls="sharded", nranks=ndev)
    r, j = _jax_residual_jvp("cd", 10, 0)
    out = task.result()[0]
    assert _rel(out["r"], r) < REL
    assert _rel(out["j"], j) < REL


def test_sharded_jacobian_apply_matches(pool):
    task = pool.submit(ranks.residual_jvp, "cd", (8, 2, 1), cls="sharded", seed=1)
    r, j = _jax_residual_jvp("cd8q1", 8, 1)
    out = task.result()[0]
    assert _rel(out["j"], j) < REL and _rel(out["r"], r) < REL


def test_sharded_cg_solve_matches_sequential(pool):
    """Iteration parity between the sequential JAX operator and the sharded
    port operator (reference: matrix_free_linear.cc:4-8)."""
    task = pool.submit(ranks.solve_windowed, "cd", (8, 2, 1), how="krylov")
    its, z1 = _jax_jacobi_cg(8, 1)
    out = task.result()[0]
    assert out["its"] == its
    assert float(np.linalg.norm(out["z"] - z1)) < 1e-10


def _lattice(cells, k, problem=None, bctype=True):
    """The JAX operator of a stencil test (all-Dirichlet unless `bctype`):
    its J.v at zero jitted (the operator compile_stencil probes and checks,
    so the stencil's apply), the right-hand side and the Jacobi diagonal."""
    dim = len(cells)
    mesh = jpt.StructuredMesh([0] * dim, [1] * dim, cells)
    V = jpt.FunctionSpace(mesh, jpt.QkFEM(k, dim))
    p = problem or Problem()
    go = jpt.GridOperator(V, JFEM(p), constraints=jpt.constraints(
        p.dirichlet_bctype() if bctype is None else bctype, V))
    x0 = V.zero()
    A = jax.jit(lambda z: go.jacobian_apply(x0, z))
    return V, A, jax.jit(go.residual)(x0), go.jacobian_diagonal(x0)


_STENCIL_CASES = [
    ((15, 15, 15), 1, None),       # divisible slabs, k=1
    ((13, 11, 9), 1, None),        # non-divisible slowest axis (padding)
    ((9, 9, 9), 2, None),          # Q2 residue classes, non-divisible
    ((11, 13, 9), 1, (4, 2)),      # 2D rank mesh (corner halo exchange)
    ((7, 9, 7), 2, (2, 2)),        # Q2 on a 2D rank mesh
]


@REFS.reference(*[(cells, k) for cells, k, _ in _STENCIL_CASES])
def _jax_stencil(cells, k):
    """A(z) at the rank test's seeded z and Jacobi-CG to 1e-12."""
    V, A, b, d = _lattice(cells, k)
    z = jnp.asarray(np.random.default_rng(3).standard_normal(V.ndofs))
    x_seq, s_seq = jcg(A, b, M=lambda r: r / d, tol=1e-12)
    return np.asarray(A(z)), int(s_seq.iterations), np.asarray(x_seq)


@pytest.mark.parametrize("cells,k,mesh_shape", _STENCIL_CASES)
def test_dof_sharded_stencil_matches(pool, cells, k, mesh_shape):
    """Lattice-sharded halo-exchange stencil == the sequential stencil, and
    the sharded CG == the sequential one (novlpistlsolverbackend.hh:96)."""
    n = 8 if mesh_shape is None else int(np.prod(mesh_shape))
    task = pool.submit(ranks.dof_stencil, cells, k, mesh_shape, nranks=n)
    y, its, x_seq = _jax_stencil(cells, k)
    out = task.result()[0]
    assert _rel(out["y"], y) < REL
    assert out["its"] == its
    assert float(np.linalg.norm(out["x"] - x_seq)) < 1e-9


@pytest.mark.parametrize("ndev", [1, 3, 8])
def test_novlp_residual_jvp_matches(pool, ndev):
    task = pool.submit(ranks.residual_jvp, "cd", (10, 2, 2), cls="novlp", seed=5, nranks=ndev)
    r, j = _jax_residual_jvp("cd", 10, 5)
    out = task.result()[0]
    assert _rel(out["r"], r) < REL and _rel(out["j"], j) < REL


def test_novlp_dg_skeleton_matches(pool):
    """DG skeleton + boundary terms through the halo-window path, 4 ranks."""
    task = pool.submit(ranks.residual_jvp, "dg", (12,), cls="novlp", seed=6, nranks=4)
    r, j = _jax_residual_jvp("dg", 12, 6)
    out = task.result()[0]
    assert _rel(out["r"], r) < REL and _rel(out["j"], j) < REL


def test_novlp_cg_iteration_parity(pool):
    """CG on padded blocks (solve_cg, global dots): the sequential count."""
    task = pool.submit(ranks.solve_windowed, "cd", (12, 2, 2), how="solve_cg", nranks=4)
    its, z1 = _jax_jacobi_cg(12, 2)
    out = task.result()[0]
    assert out["its"] == its
    assert float(np.linalg.norm(out["z"] - z1)) < 1e-9


@REFS.reference()
def _jax_gmg_solve():
    """The JAX package's GeometricMultigrid-CG at 32^2 (reduction 1e-10)."""
    from dune_pdelab_tpu.linalg.multigrid import GeometricMultigrid
    from dune_pdelab_tpu.solvers import LinearSolverBackend, StationaryLinearProblemSolver
    p = Problem()
    mesh = jpt.StructuredMesh([0, 0], [1, 1], (32, 32))
    fem = jpt.QkFEM(1, 2)
    V = jpt.FunctionSpace(mesh, fem)
    go = jpt.GridOperator(V, JFEM(p), constraints=jpt.constraints(p.dirichlet_bctype(), V))
    gmg = GeometricMultigrid(JFEM(p), mesh, fem, bctype=p.dirichlet_bctype())
    slp = StationaryLinearProblemSolver(go, LinearSolverBackend(solver="cg", precond=gmg),
                                        reduction=1e-10, verbose=0)
    x = slp.apply(V.zero())
    return slp.result.converged, slp.result.linear_solver_iterations, np.asarray(x)


def test_sharded_gmg_iteration_parity(pool):
    """ShardedGeometricMultigrid (window-sharded level operators) on 4 ranks
    takes the JAX package's sequential GeometricMultigrid iterations."""
    task = pool.submit(ranks.gmg_solve, 32, nranks=4)
    converged, its, x = _jax_gmg_solve()
    out = task.result()[0]
    assert out["converged"] and converged
    assert out["its"] == its
    assert float(np.linalg.norm(out["x"] - x)) < 1e-8


def test_comm_policies(pool):
    """Data-handle policies (genericdatahandle.hh:646-790): add/copy/min/max
    plane exchange, collectives and the owner-masked dot, 4 ranks holding
    4 (and 3) consecutive values each; and the windowed operator's
    owner-window Copy round trip."""
    res = pool.run(ranks.comm_policies, nranks=4)
    for d, out in enumerate(res):
        own = 4.0 * d
        prev = own - 1 if d > 0 else 0.0
        nxt = own + 4 if d < 3 else 0.0
        assert out["copy"] == (prev, nxt) and out["add"] == (prev, nxt)
        assert out["min"] == (min(prev, own), min(nxt, own + 3))
        assert out["max"] == (max(prev, own), max(nxt, own + 3))
        own3 = 3.0 * d
        p3, n3 = (own3 - 1 if d > 0 else 0.0), (own3 + 3 if d < 3 else 0.0)
        assert out["copy3"] == (p3, n3)
        assert out["min3"] == (min(p3, own3), min(n3, own3 + 2))
        assert out["all_sum"] == np.arange(16.0).sum()
        assert out["all_max"] == 15.0 and out["all_min"] == 0.0
        assert out["masked_dot"] == float((np.arange(16.0)[::2] ** 2).sum())
    V, _ = _ops(n=8, k=1)
    xx = np.random.default_rng(7).standard_normal(V.ndofs)
    np.testing.assert_array_equal(pool.run(ranks.roundtrip, nranks=4)[0], xx)


def test_partition_weighted():
    """Prefix-sum load balancing: the JAX package's ranges; skewed costs end
    up near-balanced, equal costs give equal ranges."""
    from dune_pdelab_tpu.parallel.loadbalance import partition_weighted as j_pw
    w = np.ones(100)
    assert partition_weighted(w, 4) == [(0, 25), (25, 50), (50, 75), (75, 100)]
    w2 = (np.arange(100) + 1.0) ** 2
    r2 = partition_weighted(w2, 4)
    assert r2 == j_pw(w2, 4)
    assert imbalance(r2, w2) < 1.15
    assert imbalance([(0, 25), (25, 50), (50, 75), (75, 100)], w2) > 1.5


@REFS.reference()
def _jax_rebalance_solution():
    V, A, b, d = _lattice((12, 12, 12), 1)
    x_ref, _ = jcg(A, b, M=lambda r: r / d, tol=1e-11)
    return np.asarray(x_ref)


def test_rebalance_mid_solve(pool):
    """A DOF-sharded CG state on 4 ranks, redistributed to 8 ranks on a (4, 2)
    mesh (a new group), finishes at the sequential solution
    (loadBalance(grid, gfs, x) analog)."""
    task = pool.submit(ranks.rebalance_mid_solve)
    x_ref = _jax_rebalance_solution()
    out = task.result()[0]
    assert float(np.linalg.norm(out["x"] - x_ref)) < 1e-8


@REFS.reference()
def _jax_newton():
    """The JAX package's Newton on the nonlinear 12^2 problem."""
    from dune_pdelab_tpu.ops.base import LocalOperator
    from dune_pdelab_tpu.solvers import NewtonMethod, SEQ_CG_Jacobi

    class NL(LocalOperator):
        def alpha_volume(self, ctx, u):
            tab = ctx.tab
            gu = self.gradient_at_qp(tab, u)
            uq = self.value_at_qp(tab, u)
            return (self.accumulate_gradient(tab, ctx.factor, gu)
                    + self.accumulate_value(tab, ctx.factor, uq ** 3))

        def lambda_volume(self, ctx):
            ue = jnp.sin(np.pi * ctx.x[..., 0]) * jnp.sin(np.pi * ctx.x[..., 1])
            f = 2 * np.pi ** 2 * ue + ue ** 3
            return self.accumulate_value(ctx.tab, ctx.factor, -f)

    mesh = jpt.StructuredMesh([0, 0], [1, 1], (12, 12))
    V = jpt.FunctionSpace(mesh, jpt.QkFEM(1, 2))
    go = jpt.GridOperator(V, NL(), constraints=jpt.constraints(True, V))
    n_seq = NewtonMethod(go, SEQ_CG_Jacobi(), reduction=1e-10, verbose=0)
    x_seq = n_seq.apply(V.zero())
    return n_seq.result.converged, n_seq.result.iterations, np.asarray(x_seq)


def test_novlp_newton_nonlinear_parity(pool):
    """Newton through the sharded operator on 4 ranks: the JAX package's
    sequential Newton iterations and solution."""
    task = pool.submit(ranks.newton_nonlinear, nranks=4)
    converged, its, x_seq = _jax_newton()
    out = task.result()[0]
    assert out["converged"] and converged
    assert out["its"] == its
    assert float(np.linalg.norm(out["x"] - x_seq)) < 1e-8


# ---- __graft_entry__.dryrun_multichip modes at its sizes, 8 ranks ------------
class GraftProblem(JProblem):
    """__graft_entry__._build_poisson's problem."""

    def f(self, x):
        return jnp.sin(3.0 * x[..., 0]) * x[..., 1] + 1.0


def _graft_poisson(cells):
    dim = len(cells)
    mesh = jpt.StructuredMesh([0.0] * dim, [1.0] * dim, cells)
    V = jpt.FunctionSpace(mesh, jpt.QkFEM(1, dim))
    p = GraftProblem()
    return V, jpt.GridOperator(V, JFEM(p), constraints=jpt.constraints(p.dirichlet_bctype(), V))


@REFS.reference()
def _jax_graft_residual_cg():
    V, go = _graft_poisson((8, 8, 8))
    x0 = V.zero()
    r = go.residual(x0)
    z, s = jcg(lambda p: go.jacobian_apply(x0, p), r, tol=1e-3, maxiter=5)
    return (int(s.iterations), float(jnp.linalg.norm(r)), np.asarray(x0 - z),
            float(jnp.linalg.norm(go.residual(x0 - z))))


def test_multichip_element_sharded_residual(pool):
    """Mode 1: the sharded residual at zero and after a 5-iteration CG
    correction, (8, 8, 8) Poisson, against the JAX operator."""
    task = pool.submit(ranks.graft_residual_cg)
    its, r0, x1, r1 = _jax_graft_residual_cg()
    out = task.result()[0]
    assert out["its"] == its
    assert abs(out["r0"] - r0) < REL * out["r0"]
    assert _rel(out["x1"], x1) < 1e-9
    assert abs(out["r1"] - r1) < 1e-9 * out["r0"]
    assert out["r1"] < out["r0"]


@REFS.reference()
def _jax_graft_dof():
    V, A, b, d = _lattice((8, 8, 15), 1, problem=GraftProblem(), bctype=None)
    x, s = jcg(A, b, M=lambda r: r / d, tol=1e-6, maxiter=50)
    return int(s.iterations), np.asarray(x), np.asarray(A(b))


def test_multichip_dof_sharded_cg_and_2d_mesh(pool):
    """Modes 2 and 3: DOF-sharded CG on (8, 8, 15) to 1e-6 (the JAX
    iterations and solution) and the (4, 2) rank-mesh apply."""
    task = pool.submit(ranks.graft_dof, (8, 8, 15), (4, 2))
    its, x, y = _jax_graft_dof()
    out = task.result()[0]
    assert out["its"] == its
    assert _rel(out["x"], x) < 1e-9
    assert _rel(out["y2"], y) < REL


@REFS.reference()
def _jax_graft_dg():
    V, go = _dg_ops(8, Unit())
    x = jnp.asarray(np.random.default_rng(0).standard_normal(V.ndofs))
    r = np.asarray(go.residual(x))
    b = go.residual(V.zero())
    z, s = jcg(lambda p: go.jacobian_apply(V.zero(), p), b, tol=1e-3, maxiter=20)
    return r, int(s.iterations), np.asarray(z)


def test_multichip_dg_window_modes(pool):
    """Modes 4 and 7: SIPG 8^2 residual (slab and (4, 2) block partitions)
    and the sharded CG to 1e-3 within 20 iterations."""
    task = pool.submit(ranks.graft_dg)
    r, its, z = _jax_graft_dg()
    out = task.result()[0]
    assert _rel(out["r"], r) < REL and _rel(out["r2"], r) < REL
    assert out["its"] == its
    assert _rel(out["z"], z) < 1e-9


def test_multichip_gmg_vcycle(pool):
    """Mode 5: one ShardedGeometricMultigrid V-cycle on 16^2 Q1 (the dry run
    only runs it) equals the port's sequential GeometricMultigrid cycle,
    which tests/test_torch_multigrid.py holds against the JAX package's."""
    out = pool.run(ranks.graft_gmg_vcycle)[0]
    assert _rel(out["z"], out["z_seq"]) < REL
