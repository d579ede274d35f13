"""Parity of the port's DG preconditioners with the JAX package (fp64).

  * DGTwoLevel.apply, the flat and the mode-major cycle, against the JAX
    package's flat cycle on a 3D Q1 SIPG lattice (1e-10 relative);
  * config7_dg_twolevel (2D Q1 SIPG, CG + DGTwoLevel on the general-jvp
    tier, use_stencil=False): the JAX package's iterations and L2 error
    (1e-10), and the golden's L2 error within 1e-8 relative (see
    test_config7_golden for its iteration count);
  * CG with block Jacobi, BiCGStab with colored block Gauss-Seidel (one
    forward sweep, not symmetric) on the backend's block-stencil tier, and
    CG with Chebyshev (the same lambda_max start vector as the JAX
    package) take the JAX package's iteration counts;
  * coarse="amg" builds an AlgebraicMultigrid coarse solve and an unknown
    coarse space raises (the cycle's parity: tests/test_torch_amg.py);
    gmg_kwargs build the GeometricMultigrid coarse solve.
"""
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import jax.numpy as jnp
import torch

import dune_pdelab_tpu as jpt
import dune_pdelab_tpu_torch as tpt
from dune_pdelab_tpu.fe import QkDGFEM as JQkDG
from dune_pdelab_tpu.linalg import DGTwoLevel as JTwoLevel
from dune_pdelab_tpu.linalg import cg as j_cg
from dune_pdelab_tpu.linalg import preconditioners as jpre
from dune_pdelab_tpu.ops import ConvectionDiffusionFEM as JFEM
from dune_pdelab_tpu.ops import ConvectionDiffusionProblem as JProblem
from dune_pdelab_tpu.ops.convectiondiffusiondg import ConvectionDiffusionDG as JDG
from dune_pdelab_tpu.solvers import LinearSolverBackend as JBackend
from dune_pdelab_tpu_torch.assembly.blockstencil import compile_block_stencil
from dune_pdelab_tpu_torch.linalg import DGTwoLevel, cg
from dune_pdelab_tpu_torch.linalg import preconditioners as tpre
from dune_pdelab_tpu_torch.ops import ConvectionDiffusionDG as TDG
from dune_pdelab_tpu_torch.ops import ConvectionDiffusionFEM as TFEM
from dune_pdelab_tpu_torch.ops import ConvectionDiffusionProblem as TProblem
from dune_pdelab_tpu_torch.solvers import LinearSolverBackend, SEQ_CG_BlockJacobi
from dune_pdelab_tpu_torch.space.functions import l2_difference
from dune_pdelab_tpu_torch.utils.common import set_default_device

pytestmark = pytest.mark.fast
torch.set_num_threads(1)
set_default_device("cpu")

F64 = torch.float64
GOLDEN = json.loads((Path(__file__).parent / "golden_parity.json").read_text())


class JSource(JProblem):
    def f(self, x):
        return 1.0 + x[..., 0] * x[..., 1]


class TSource(TProblem):
    def f(self, x):
        return 1.0 + x[..., 0] * x[..., 1]


def _pair(dim, cells):
    lo, hi = [0.0] * dim, [1.0] * dim
    jV = jpt.FunctionSpace(jpt.StructuredMesh(lo, hi, cells), JQkDG(1, dim))
    tV = tpt.FunctionSpace(tpt.StructuredMesh(lo, hi, cells), tpt.QkDGFEM(1, dim))
    return jpt.GridOperator(jV, JDG(JSource())), tpt.GridOperator(tV, TDG(TSource()))


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.abs(got - want).max() / np.abs(want).max()


def test_two_level_cycles_match_jax_flat_cycle():
    jgo, tgo = _pair(3, (8, 8, 8))
    jtl = JTwoLevel(jgo, JFEM(JSource()))
    jtl.setup()
    r = np.random.default_rng(31).standard_normal(tgo.space.ndofs)
    want = np.asarray(jtl.apply(jnp.asarray(r)))
    x0 = torch.zeros(tgo.space.ndofs, dtype=F64)
    mm = DGTwoLevel(tgo, TFEM(TSource()))
    mm.setup(x0)                                     # compiles, lowers to mode-major
    flat = DGTwoLevel(tgo, TFEM(TSource()))
    flat.setup(x0, operator=compile_block_stencil(tgo, x0))
    assert "mm" in mm._apply.__qualname__ and "flat" in flat._apply.__qualname__
    for tl in (mm, flat):
        assert _rel(tl.apply(torch.from_numpy(r)).numpy(), want) <= 1e-10


class TSine2D(TProblem):
    """models/configs.py _Sine2D."""

    def exact(self, p):
        return torch.sin(np.pi * p[:, 0]) * torch.cos(2 * np.pi * p[:, 1]) + p[:, 0]

    def f(self, x):
        return 5 * np.pi**2 * torch.sin(np.pi * x[..., 0]) * torch.cos(2 * np.pi * x[..., 1])

    def g(self, x):
        return torch.sin(np.pi * x[..., 0]) * torch.cos(2 * np.pi * x[..., 1]) + x[..., 0]


def test_config7_golden():
    """config7_dg_twolevel (models/configs.py:268-291): 32^2 Q1 SIPG, CG +
    DGTwoLevel (LatticeGMG on the Q1 subspace, the element-major block
    stencil in the smoother) on the general-jvp tier.

    tests/golden_parity.json records 7 iterations from before the JAX
    package's smoother moved to the face-parity two-colouring (commit
    08f3c87, after the recording 729bda8); the JAX package now takes 6
    with an L2 error 1.05e-9 relative from the golden's. The port is held
    to the JAX package as it runs, and to the golden's L2 error."""
    from dune_pdelab_tpu.models.configs import config7_dg_twolevel

    want = GOLDEN["config7_dg_twolevel"]
    ref = config7_dg_twolevel()
    p = TSine2D()
    V = tpt.FunctionSpace(tpt.StructuredMesh([0, 0], [1, 1], (32, 32)), tpt.QkDGFEM(1, 2))
    go = tpt.GridOperator(V, TDG(p))
    pre = DGTwoLevel(go, TFEM(p), bctype=p.dirichlet_bctype())
    ls = LinearSolverBackend(solver="cg", precond=pre, use_stencil=False)
    slp = tpt.StationaryLinearProblemSolver(go, ls, reduction=1e-10, verbose=0)
    x = slp.apply(V.zero(F64))
    assert V.ndofs == want["ndofs"] and slp.result.converged
    assert "custom preconditioner DGTwoLevel" in ls.report(go)
    assert slp.result.linear_solver_iterations == ref["iterations"]
    l2 = float(l2_difference(V, x, p.exact))
    assert l2 == pytest.approx(ref["l2_error"], rel=1e-10)
    assert l2 == pytest.approx(want["l2_error"], rel=1e-8)


@pytest.fixture(scope="module")
def sipg2d():
    jgo, tgo = _pair(2, (8, 8))
    b = np.asarray(jgo.residual(jnp.zeros(jgo.space.ndofs)))
    return jgo, tgo, b


@pytest.mark.parametrize("precond,solver", [("block_jacobi", "cg"),
                                            ("block_gs", "bicgstab")])
def test_block_preconditioned_krylov_steps_match_jax(sipg2d, precond, solver):
    jgo, tgo, b = sipg2d
    _, js = JBackend(solver=solver, precond=precond).solve(
        jgo, jnp.zeros_like(b), jnp.asarray(b), 1e-10)
    ls = (SEQ_CG_BlockJacobi() if precond == "block_jacobi"
          else LinearSolverBackend(solver=solver, precond=precond))
    z, s = ls.solve(tgo, torch.zeros(b.shape, dtype=F64), torch.tensor(b), 1e-10)
    assert "BlockStencilOperator" in ls.report(tgo)
    assert bool(s.converged) and s.iterations == int(js.iterations)


def test_chebyshev_cg_iterations_match_jax(sipg2d):
    jgo, tgo, b = sipg2d
    n = tgo.space.ndofs
    jst = jpt.assembly.blockstencil.compile_block_stencil(jgo)
    jdiag = jst.diagonal(jnp.float64)
    jlmax = jpre.power_iteration(jst, jdiag, n, dtype=jnp.float64)
    _, js = j_cg(jst, jnp.asarray(b), M=jpre.chebyshev(jst, jdiag, jlmax), tol=1e-10)
    tst = compile_block_stencil(tgo, torch.zeros(n, dtype=F64))
    tdiag = tst.diagonal(F64)
    v0 = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (n,), jnp.float64))
    tlmax = tpre.power_iteration(tst, tdiag, n, dtype=F64, v0=v0)
    assert float(tlmax) == pytest.approx(float(jlmax), rel=1e-12)
    _, s = cg(tst, torch.from_numpy(b), M=tpre.chebyshev(tst, tdiag, tlmax), tol=1e-10)
    assert bool(s.converged) and s.iterations == int(js.iterations)
    # the backend's Chebyshev (its own start vector) solves as well
    ls = LinearSolverBackend(precond="chebyshev")
    _, s = ls.solve(tgo, torch.zeros(n, dtype=F64), torch.from_numpy(b), 1e-10)
    assert bool(s.converged) and abs(s.iterations - int(js.iterations)) <= 1


def test_unported_coarse_spaces_raise():
    """coarse="amg", which raised before AlgebraicMultigrid was ported,
    now builds that coarse solve; an unknown coarse space raises; gmg_kwargs,
    which raised before GeometricMultigrid was ported, build that one."""
    from dune_pdelab_tpu_torch.linalg.amg import AlgebraicMultigrid
    from dune_pdelab_tpu_torch.linalg.multigrid import GeometricMultigrid

    _, tgo = _pair(2, (8, 8))
    ta = DGTwoLevel(tgo, TFEM(TSource()), coarse="amg", amg_kwargs={"max_coarse": 20})
    assert isinstance(ta.amg, AlgebraicMultigrid) and ta.amg.max_coarse == 20
    assert ta.gmg is None and ta.gmg_lattice is None and ta.coarse_kind == "amg"
    with pytest.raises(ValueError, match="coarse"):
        DGTwoLevel(tgo, TFEM(TSource()), coarse="ilu")
    tl = DGTwoLevel(tgo, TFEM(TSource()), gmg_kwargs={"pre_sweeps": 3})
    assert tl.gmg_lattice is None and isinstance(tl.gmg, GeometricMultigrid)
    assert tl.gmg.pre == 3
