"""The port's distributed multigrid against the JAX package: ShardedAMG
(parallel/shardedamg.py, the tests of tests/test_shardedamg.py and the dry
run's AMG mode) and ShardedLatticeGMG (parallel/gmg_sharded.py, the tests
of tests/test_gmg_sharded.py and the dry run's lattice GMG-CG mode), on
gloo ranks.

One RankPool of 8 CPU ranks serves the module; the rank halves are in
tests/torch_parallel_ranks.py (no JAX). fp64: V-cycles to 1e-10 relative
of the JAX package's sequential cycles, iteration counts equal, solutions
to the reference tests' bounds. The communication counters show an AMG
cycle's halo windows plus one coarse all-gather, and a lattice GMG cycle
(Q1 and Q2) moving halo planes and one all-gather of the first replicated
level: no rank gathers a fine-level vector (the reference's Qk transfers,
gmg_sharded.py:107-109, replicated the fine vector). The JAX values are
registered references (tests/torch_parallel_refs.py), computed ahead in
worker threads while the tests wait for their ranks.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

import dune_pdelab_tpu as jpt
from dune_pdelab_tpu.linalg.amg import AlgebraicMultigrid
from dune_pdelab_tpu.linalg.gmg_lattice import LatticeGMG
from dune_pdelab_tpu.linalg.krylov import cg as jcg
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


class _Problem(JProblem):
    def f(self, x):
        return 5 * np.pi**2 * jnp.sin(np.pi * x[..., 0]) * jnp.cos(2 * np.pi * x[..., 1])

    def g(self, x):
        return jnp.sin(np.pi * x[..., 0]) * jnp.cos(2 * np.pi * x[..., 1]) + x[..., 0]


class Lap(JProblem):
    def A(self, x):
        return 1.0


@REFS.memo
def _amg(mesh_kind, n):
    """The JAX package's AMG of the reference tests' problem (mesh_kind
    "unit": the dry run's f = 1 problem)."""
    if mesh_kind == "simplex":
        from dune_pdelab_tpu.fe import PkFEM
        from dune_pdelab_tpu.mesh import SimplexMesh
        mesh = SimplexMesh.from_structured(jpt.StructuredMesh([0, 0], [1, 1], (n, n)))
        fem = PkFEM(1, 2)
    else:
        mesh, fem = jpt.StructuredMesh([0, 0], [1, 1], (n, n)), jpt.QkFEM(1, 2)
    p = Unit() if mesh_kind == "unit" else _Problem()
    V = jpt.FunctionSpace(mesh, fem)
    go = jpt.GridOperator(V, JFEM(p), constraints=jpt.constraints(p.dirichlet_bctype(), V))
    amg = AlgebraicMultigrid().setup_from_grid_operator(go, keep_host=True)
    return V, go, amg


class Unit(JProblem):
    def f(self, x):
        return jnp.ones(x.shape[:-1], x.dtype)


@REFS.reference(("cube", 48, 2), ("simplex", 24, 3), ("unit", 32, 6))
def _jax_amg_vcycle(mesh_kind, n, seed):
    """The JAX package's V-cycle on the rank test's seeded r."""
    V, go, amg = _amg(mesh_kind, n)
    r = jnp.asarray(np.random.default_rng(seed).standard_normal(V.ndofs))
    return np.asarray(amg.apply(r))


@REFS.reference()
def _jax_amg_cg():
    """AMG-preconditioned CG on go.jacobian_apply (48^2, seeded b, 1e-10)."""
    V, go, amg = _amg("cube", 48)
    x0 = V.zero()
    b = jnp.asarray(np.random.default_rng(1).standard_normal(V.ndofs))
    z1, s1 = jcg(lambda q: go.jacobian_apply(x0, q), b, M=amg.apply, tol=1e-10)
    return int(s1.iterations), np.asarray(z1)


# ---- ShardedAMG (tests/test_shardedamg.py) ---------------------------------------
@pytest.mark.parametrize("ndev", [2, 8])
def test_amg_vcycle_matches_sequential(pool, ndev):
    """The sharded V-cycle is the sequential one to rounding."""
    task = pool.submit(ranks.amg_vcycle, "cube", 48, 2, nranks=ndev)
    want = _jax_amg_vcycle("cube", 48, 2)
    out = task.result()[0]
    assert _rel(out["shard"], want) < REL
    assert _rel(out["shard"], out["seq"]) < REL


def test_amg_preconditioned_cg_iterations(pool):
    """CG preconditioned by the sharded cycle on 8 ranks: the JAX package's
    sequential iterations and solution."""
    task = pool.submit(ranks.amg_cg, 48)
    its, z1 = _jax_amg_cg()
    out = task.result()[0]
    assert out["its"] == its == out["its_seq"]
    assert float(np.linalg.norm(out["z"] - z1)) < 1e-8


def test_amg_simplex_vcycle(pool):
    """The same contract on a simplex mesh (where no geometric multigrid
    exists)."""
    task = pool.submit(ranks.amg_vcycle, "simplex", 24, 3)
    want = _jax_amg_vcycle("simplex", 24, 3)
    out = task.result()[0]
    assert _rel(out["shard"], want) < REL


def test_comm_is_sendrecv_plus_one_coarse_gather(pool):
    """A sharded V-cycle communicates by neighbour exchanges of windows and
    exactly one all-gather, of the coarse level (never a fine vector)."""
    res = pool.run(ranks.amg_comm, 32)
    for out in res:
        st = out["stats"]
        assert set(st) == {"sendrecv", "allgather"}, st
        assert st["allgather"]["calls"] == 1
        assert st["allgather"]["largest"] <= -(-out["sizes"][-1] // out["ndev"])
        assert st["sendrecv"]["largest"] < out["sizes"][0] // 2


def test_from_grid_operator_constructor(pool):
    out = pool.run(ranks.amg_from_go, 24, nranks=4)[0]
    assert out["shape"] == (625,)
    assert out["rz"] > 0 and out["levels"] >= 2


@REFS.reference()
def _jax_amg_solve():
    """The sequential assembled AMG-CG (48^2, b = R(0), 1e-11)."""
    V, go, amg = _amg("cube", 48)
    b = go.residual(V.zero())
    A = jnp.asarray(amg.host_levels[0][0].toarray())
    z1, s1 = jcg(lambda q: A @ q, b, M=amg.apply, tol=1e-11)
    return int(s1.iterations), np.asarray(z1)


def test_amg_solve_cg_iterations_match(pool):
    """The fully sharded assembled solve (matrix, Krylov vectors and cycle
    on row blocks, the NOVLP_CG_AMG analog) takes the sequential assembled
    AMG-CG's iterations and solution (the JAX package's)."""
    task = pool.submit(ranks.amg_solve, 48)
    its, z1 = _jax_amg_solve()
    out = task.result()[0]
    assert out["its"] == its == out["its_seq"]
    assert float(np.linalg.norm(out["z"] - z1)) < 1e-9


def test_multichip_amg_vcycle(pool):
    """The dry run's AMG mode: 32^2 Q1 (f = 1), 8 ranks, seed 6."""
    task = pool.submit(ranks.amg_vcycle, "unit", 32, 6)
    want = _jax_amg_vcycle("unit", 32, 6)
    out = task.result()[0]
    assert _rel(out["shard"], want) < REL


# ---- ShardedLatticeGMG (tests/test_gmg_sharded.py) --------------------------------
@REFS.memo
def _gmg(cells, coarsest=2):
    mesh = jpt.StructuredMesh([0] * 3, [1] * 3, (cells,) * 3)
    V = jpt.FunctionSpace(mesh, jpt.QkFEM(1, 3))
    return V, LatticeGMG(V, JFEM(Lap()), coarsest_cells=coarsest)


def _rhs(gmg, n, seed):
    b = jnp.asarray(np.random.default_rng(seed).standard_normal(n))
    return jnp.where(gmg.stencils[0].mask, 0.0, b)


@REFS.reference((16, 0), (16, 2))
def _jax_vcycle(cells, seed):
    """The JAX package's V-cycle on the rank test's seeded masked b."""
    V, gmg = _gmg(cells)
    return np.asarray(gmg.apply(_rhs(gmg, V.ndofs, seed)))


@REFS.reference((16, 2, 1, 1e-8, 50), (32, 4, 7, 1e-6, 30))
def _jax_gmg_cg(cells, coarsest, seed, tol, maxiter):
    """The JAX package's LatticeGMG.solve_host: (x, info)."""
    V, gmg = _gmg(cells, coarsest)
    x_seq, info = gmg.solve_host(_rhs(gmg, V.ndofs, seed), tol=tol, maxiter=maxiter)
    return np.asarray(x_seq), info


@REFS.reference((16, 2, None, 500), (16, 2, (4, 2), 500), (32, 4, None, 4000))
def _jax_padding(cells, coarsest, mesh_shape, gather_below):
    """The padded lattices of the JAX package's ShardedLatticeGMG on 8
    devices (2:1 aligned from its coarsest sharded level)."""
    import jax
    from dune_pdelab_tpu.parallel.gmg_sharded import ShardedLatticeGMG
    ref = ShardedLatticeGMG(_gmg(cells, coarsest)[1], devices=jax.devices()[:8],
                            mesh_shape=mesh_shape, gather_below=gather_below)
    return [s.padded_shape for s in ref.sstencils]


def _halo_only(out):
    """A cycle's counters: halo planes, one all-gather of (a block of) the
    first replicated level, nothing of fine-level size."""
    st = out["vcycle_stats"]
    assert st["allgather"]["calls"] == 1
    assert st["allgather"]["largest"] <= out["coarse_switch"]
    assert st["sendrecv"]["largest"] < out["fine"] // 4


def test_sharded_vcycle_matches_sequential(pool):
    """One V-cycle on 8 ranks (1D mesh) equals the sequential cycle, on the
    JAX package's padded lattices."""
    task = pool.submit(ranks.lattice_gmg, 16, gather_below=500, seed=0)
    want = _jax_vcycle(16, 0)
    out = task.result()[0]
    assert out["n_sharded"] >= 2
    assert _rel(out["z"], want) < REL
    _halo_only(out)
    assert out["padded"] == _jax_padding(16, 2, None, 500)


def test_sharded_cg_iteration_parity(pool):
    """GMG-CG on 8 ranks: the sequential solve_host iterations."""
    task = pool.submit(ranks.lattice_gmg, 16, gather_below=500, seed=1, solve=True)
    x_seq, info_seq = _jax_gmg_cg(16, 2, 1, 1e-8, 50)
    out = task.result()[0]
    info = out["info"]
    assert info["converged"] and info_seq["converged"]
    assert info["iterations"] == info_seq["iterations"]
    assert _rel(out["x"], x_seq) < 1e-9
    assert info["true_defect"] <= 2e-8 * info["defect0"]


def test_sharded_2d_mesh_parity(pool):
    """A (4, 2) rank mesh over (z, y): the same V-cycle."""
    task = pool.submit(ranks.lattice_gmg, 16, mesh_shape=(4, 2), gather_below=500, seed=2)
    want = _jax_vcycle(16, 2)
    out = task.result()[0]
    assert _rel(out["z"], want) < REL
    _halo_only(out)
    assert out["padded"] == _jax_padding(16, 2, (4, 2), 500)


def test_sharded_q2_transfers_stay_local(pool):
    """Q2 lattice (8^3 cells) on 8 ranks: the sharded transfers apply the
    sequential Qk maps to halo-extended blocks (no replicated fine vector),
    and the V-cycle equals the port's sequential LatticeGMG cycle (3D Q2 is
    not probed here on the JAX side: its proxy stencils take ~35 s)."""
    out = pool.run(ranks.lattice_gmg, 8, k=2, gather_below=1000, seed=3)[0]
    assert out["n_sharded"] == 1
    assert _rel(out["z"], out["z_seq"]) < REL
    _halo_only(out)


def test_multichip_lattice_gmg_cg(pool):
    """The dry run's lattice GMG-CG mode: 32^3 Q1, coarsest 4 cells,
    gather_below 4000, tol 1e-6: the sequential iterations, at least two
    sharded levels."""
    task = pool.submit(ranks.lattice_gmg, 32, gather_below=4000, seed=7, solve=True,
                       coarsest_cells=4, tol=1e-6, maxiter=30)
    _, info_seq = _jax_gmg_cg(32, 4, 7, 1e-6, 30)
    out = task.result()[0]
    assert out["n_sharded"] >= 2
    assert out["info"]["converged"] and info_seq["converged"]
    assert out["info"]["iterations"] == info_seq["iterations"]
    assert out["padded"] == _jax_padding(32, 4, None, 4000)
