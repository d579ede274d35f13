"""Parity of the port's multigrid solve routes with the JAX package (fp64).

  * StructuredMesh.coarsen, _transfer_1d and the restriction maps equal the
    reference's; the coarse LU solve alone matches jax.scipy's lu_solve;
  * the V-cycle `apply` of a LatticeGMG built from the JAX one's numpy state
    (interop.lattice_gmg_from_numpy) equals the reference's to 1e-10;
  * LatticeGMG.solve_host / make_solver built by the port itself give the
    same iteration counts and solutions to 1e-8 on the 3D Q1 and 2D Q2
    cases of tests/test_gmg_lattice.py;
  * refine_solve and MixedPrecisionStationarySolver reach the reference's
    fp64 defect (tests/test_refinement.py, mirrored);
  * the config13_scale_lattice_gmg recipe at 32^3 (models/configs.py:525)
    matches the JAX run: equal iterations, L2 error to 1e-8 relative.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import jax.scipy.linalg as jsl
import torch

import dune_pdelab_tpu as jpt
import dune_pdelab_tpu_torch as tpt
from dune_pdelab_tpu.assembly.stencil import compile_stencil as j_compile
from dune_pdelab_tpu.linalg.gmg_lattice import LatticeGMG as JLatticeGMG
from dune_pdelab_tpu.linalg.gmg_lattice import _transpose_transfer_1d as j_transpose
from dune_pdelab_tpu.linalg.multigrid import _transfer_1d as j_transfer_1d
from dune_pdelab_tpu.ops import ConvectionDiffusionFEM as JFEM
from dune_pdelab_tpu.ops import ConvectionDiffusionProblem as JProblem
from dune_pdelab_tpu.solvers.refinement import (
    MixedPrecisionStationarySolver as JMPS, refine_solve as j_refine)
from dune_pdelab_tpu.space.functions import l2_difference as j_l2
from dune_pdelab_tpu_torch.assembly.stencil import compile_stencil
from dune_pdelab_tpu_torch.interop import lattice_gmg_from_numpy
from dune_pdelab_tpu_torch.linalg.gmg_lattice import (
    LatticeGMG, _transpose_transfer_1d, coarse_lu_factor)
from dune_pdelab_tpu_torch.linalg.multigrid import _transfer_1d
from dune_pdelab_tpu_torch.ops import ConvectionDiffusionFEM as TFEM
from dune_pdelab_tpu_torch.ops import ConvectionDiffusionProblem as TProblem
from dune_pdelab_tpu_torch.solvers.refinement import (
    MixedPrecisionStationarySolver, refine_solve)
from dune_pdelab_tpu_torch.space.functions import l2_difference

pytestmark = pytest.mark.fast
torch.set_num_threads(1)
F64 = torch.float64
PI = np.pi


class JP2(JProblem):
    def exact(self, p):
        return np.sin(PI * p[:, 0]) * np.cos(2 * PI * p[:, 1]) + p[:, 0]

    def f(self, x):
        return 5 * PI**2 * jnp.sin(PI * x[..., 0]) * jnp.cos(2 * PI * x[..., 1])

    def g(self, x):
        return jnp.sin(PI * x[..., 0]) * jnp.cos(2 * PI * x[..., 1]) + x[..., 0]


class TP2(TProblem):
    def exact(self, p):
        return torch.sin(PI * p[:, 0]) * torch.cos(2 * PI * p[:, 1]) + p[:, 0]

    def f(self, x):
        return 5 * PI**2 * torch.sin(PI * x[..., 0]) * torch.cos(2 * PI * x[..., 1])

    def g(self, x):
        return torch.sin(PI * x[..., 0]) * torch.cos(2 * PI * x[..., 1]) + x[..., 0]


class JP3(JProblem):
    def exact(self, p):
        return np.sin(PI * p[:, 0]) * np.sin(PI * p[:, 1]) * np.sin(PI * p[:, 2])

    def f(self, x):
        return 3 * PI**2 * (jnp.sin(PI * x[..., 0]) * jnp.sin(PI * x[..., 1])
                            * jnp.sin(PI * x[..., 2]))

    def g(self, x):
        return jnp.zeros(x.shape[:-1])


class TP3(TProblem):
    def exact(self, p):
        return torch.sin(PI * p[:, 0]) * torch.sin(PI * p[:, 1]) * torch.sin(PI * p[:, 2])

    def f(self, x):
        return 3 * PI**2 * (torch.sin(PI * x[..., 0]) * torch.sin(PI * x[..., 1])
                            * torch.sin(PI * x[..., 2]))

    def g(self, x):
        return torch.zeros(x.shape[:-1], dtype=x.dtype)


def _jax_case(Problem, n, k, dim):
    p = Problem()
    mesh = jpt.StructuredMesh([0] * dim, [1] * dim, (n,) * dim)
    V = jpt.FunctionSpace(mesh, jpt.QkFEM(k, dim))
    cg_ = jpt.constraints(p.dirichlet_bctype(), V)
    lop = JFEM(p)
    go = jpt.GridOperator(V, lop, constraints=cg_)
    gmg = JLatticeGMG(V, lop, fine_stencil=j_compile(go))
    x0 = jpt.interpolate_dirichlet(lambda q: np.asarray(p.g(jnp.asarray(q))),
                                   V, cg_, V.zero())
    return dict(p=p, V=V, go=go, gmg=gmg, x0=x0, b=-go.residual(x0, 0.0))


def _torch_case(Problem, n, k, dim):
    p = Problem()
    mesh = tpt.StructuredMesh([0] * dim, [1] * dim, (n,) * dim)
    V = tpt.FunctionSpace(mesh, tpt.QkFEM(k, dim))
    cg_ = tpt.constraints(p.dirichlet_bctype(), V)
    lop = TFEM(p)
    go = tpt.GridOperator(V, lop, constraints=cg_, skip_boundary=True)
    gmg = LatticeGMG(V, lop, fine_stencil=compile_stencil(go, dtype=F64))
    x0 = tpt.interpolate_dirichlet(p.g, V, cg_, V.zero(F64))
    return dict(p=p, V=V, go=go, gmg=gmg, x0=x0, b=-go.residual(x0, 0.0))


CASES = {"3d_q1": (JP3, TP3, 16, 1, 3), "2d_q2": (JP2, TP2, 16, 2, 2)}


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    JP, TP, n, k, dim = CASES[request.param]
    return _jax_case(JP, n, k, dim), _torch_case(TP, n, k, dim)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("cells", [(16, 8, 4), (12, 6)])
def test_coarsen_matches_reference(cells):
    jm = jpt.StructuredMesh([0] * len(cells), [1, 2, 3][:len(cells)], cells)
    tm = tpt.StructuredMesh([0] * len(cells), [1, 2, 3][:len(cells)], cells)
    jc, tc = jm.coarsen(2), tm.coarsen(2)
    assert tc.cells == jc.cells and np.array_equal(tc.h, jc.h)
    assert np.array_equal(tc.lower, jc.lower) and np.array_equal(tc.upper, jc.upper)
    with pytest.raises(ValueError, match="divisible"):
        tm.coarsen(8)


@pytest.mark.parametrize("k,nc", [(1, 4), (2, 3), (3, 2)])
def test_transfer_1d_matches_reference(k, nc):
    for periodic in (False, True):
        got, ref = _transfer_1d(k, nc, periodic), j_transfer_1d(k, nc, periodic)
        assert np.array_equal(got[0], ref[0]) and got[2:] == ref[2:]
        assert np.array_equal(got[1], ref[1])
    idx, w, _, ncd = got = _transfer_1d(k, nc, False)
    ridx, rw = _transpose_transfer_1d(idx, w, ncd)
    jridx, jrw = j_transpose(idx, w, ncd)
    assert np.array_equal(ridx, jridx) and np.array_equal(rw, jrw)


def test_coarse_lu_solve_matches_reference(case):
    jc, tc = case
    lu, piv = tc["gmg"]._coarse_lu
    jlu, jpiv = jc["gmg"]._coarse_lu
    assert np.allclose(lu.numpy(), jlu, rtol=0, atol=1e-12 * np.abs(jlu).max())
    assert np.array_equal(piv.numpy(), jpiv + 1)           # LAPACK 1-based
    r = np.random.default_rng(5).standard_normal(lu.shape[0])
    got = tc["gmg"]._coarse_solve(torch.as_tensor(r))
    ref = jsl.lu_solve((jnp.asarray(jlu), jnp.asarray(jpiv)), jnp.asarray(r))
    assert _rel(got, ref) <= 1e-12


def test_vcycle_from_carried_state_matches_reference(case):
    jc, tc = case
    jg = jc["gmg"]
    gmg = lattice_gmg_from_numpy(
        jg.dims, jg.stencils[0].k,
        [(st.weights, st.offsets, np.asarray(st.mask)) for st in jg.stencils],
        jg.transfers, jg._coarse_lu, pre=jg.pre, post=jg.post,
        smoother=jg.smoother, omega=jg.omega, cycle=jg.cycle, lmax=jg.lmax)
    assert gmg.nlevels == jg.nlevels
    mask = np.asarray(jg.stencils[0].mask)
    b = np.where(mask, 0.0, np.random.default_rng(0).standard_normal(mask.size))
    assert _rel(gmg.apply(torch.as_tensor(b)), jg.apply(jnp.asarray(b))) <= 1e-10
    # the Jacobi smoother and the W-cycle
    try:
        jg.smoother, jg.cycle, jg._vcycle_jit = "jacobi", "w", None
        gmg.smoother, gmg.cycle = "jacobi", "w"
        assert _rel(gmg.apply(torch.as_tensor(b)), jg.apply(jnp.asarray(b))) <= 1e-10
    finally:
        jg.smoother, jg.cycle, jg._vcycle_jit = "chebyshev", "v", None
    # the port's own hierarchy carries the same level data
    tg = tc["gmg"]
    assert tg.dims == jg.dims and np.allclose(tg.lmax, jg.lmax, rtol=1e-12)
    for st, jst in zip(tg.stencils, jg.stencils):
        assert np.allclose(st.weights, jst.weights, rtol=0, atol=1e-12)
        assert np.array_equal(st.mask.numpy(), np.asarray(jst.mask))


def test_solve_host_and_make_solver_match_reference(case):
    jc, tc = case
    x_j, info_j = jc["gmg"].solve_host(jc["b"], tol=1e-10)
    x_t, info_t = tc["gmg"].solve_host(tc["b"], tol=1e-10)
    assert info_t["converged"] and info_t["iterations"] == info_j["iterations"]
    assert _rel(x_t, x_j) <= 1e-8
    assert abs(info_t["true_defect"] - info_j["true_defect"]) <= 1e-6 * info_j["defect0"]
    z_j, s_j = jc["gmg"].make_solver(tol=1e-10)(jc["b"])
    z_t, s_t = tc["gmg"].make_solver(tol=1e-10)(tc["b"])
    assert bool(s_t.converged) and s_t.iterations == int(s_j.iterations)
    assert _rel(z_t, z_j) <= 1e-8
    err_j = float(j_l2(jc["V"], jc["x0"] + z_j, jc["p"].exact))
    err_t = float(l2_difference(tc["V"], tc["x0"] + z_t, tc["p"].exact))
    assert abs(err_t - err_j) <= 1e-8 * err_j


@pytest.fixture(scope="module")
def refine_case():
    return _jax_case(JP2, 64, 1, 2), _torch_case(TP2, 64, 1, 2)


def test_refine_reaches_reference_fp64_defect(refine_case):
    jc, tc = refine_case
    x_j, s_j = j_refine(jc["gmg"].stencils[0], jc["gmg"].make_solver(tol=1e-4, maxiter=50),
                        jc["b"], tol=1e-13)
    seen = []

    def inner(r32):
        seen.append(r32.dtype)
        return tc["gmg"].make_solver(tol=1e-4, maxiter=50)(r32)

    b = tc["b"]
    x, s = refine_solve(tc["gmg"].stencils[0], inner, b, tol=1e-13)
    assert s.converged and s_j.converged
    assert abs(s.outer_iterations - s_j.outer_iterations) <= 1
    assert all(d == torch.float32 for d in seen)
    for a, bb in zip(s.history[:-1], s.history[1:]):
        assert bb < 1e-3 * a
    true = float(torch.linalg.norm(b - tc["gmg"].stencils[0](x)))
    assert true < 1e-13 * float(torch.linalg.norm(b))
    assert _rel(x, x_j) <= 1e-11


def test_mixed_precision_stationary_solver_hits_golden_l2(refine_case):
    jc, tc = refine_case
    mps_j = JMPS(jc["go"], jc["gmg"], reduction=1e-12)
    err_j = float(j_l2(jc["V"], mps_j.apply(jc["x0"]), jc["p"].exact))
    mps = MixedPrecisionStationarySolver(tc["go"], tc["gmg"], reduction=1e-12)
    x = mps.apply(tc["x0"])
    assert mps.stats.converged
    assert mps.stats.defect <= 1e-12 * mps.stats.defect0
    err = float(l2_difference(tc["V"], x, tc["p"].exact))
    # the pure-fp64 solve of the port itself
    z64, _ = tc["gmg"].make_solver(tol=1e-12)(tc["b"])
    err64 = float(l2_difference(tc["V"], tc["x0"] + z64, tc["p"].exact))
    assert abs(err - err64) < 1e-9 * max(err64, 1.0)
    assert abs(err - err_j) < 1e-9 * max(err_j, 1.0)


def test_config13_recipe_at_32_matches_jax():
    """models/configs.py:525-562 without the sharded cross-check, at 32^3."""
    res = {}
    for case_fn, P in ((_jax_case, JP3), (_torch_case, TP3)):
        c = case_fn(P, 32, 1, 3)
        z, info = c["gmg"].solve_host(c["b"], tol=1e-10, maxiter=60)
        l2 = (j_l2 if case_fn is _jax_case else l2_difference)(c["V"], c["x0"] + z,
                                                              c["p"].exact)
        res[case_fn] = (int(info["iterations"]), float(l2), c["gmg"].nlevels)
    (it_j, l2_j, lv_j), (it_t, l2_t, lv_t) = res[_jax_case], res[_torch_case]
    assert it_t == it_j and lv_t == lv_j == 4
    assert abs(l2_t - l2_j) <= 1e-8 * l2_j


def test_coarse_lu_factor_is_the_assembled_jacobian():
    """coarse_lu_factor factors go.jacobian: LU reproduces A x."""
    tc = _torch_case(TP3, 8, 1, 3)
    goc = tc["go"]
    A = goc.jacobian(torch.zeros(goc.space.ndofs, dtype=F64)).to_dense()
    lu, piv = coarse_lu_factor(goc)
    x = torch.as_tensor(np.random.default_rng(1).standard_normal(A.shape[0]))
    assert _rel(torch.linalg.lu_solve(lu, piv, (A @ x)[:, None])[:, 0], x) <= 1e-12
