"""Parity of the port's residue names with the JAX package (fp64).

The public names that the port's modules lacked, held against the JAX
package on the same seeded inputs:
  * space/functions.py: l2_norm (real for a complex vector),
    h1_seminorm_difference, integrate_grid_function (1e-12 relative) and
    DiscreteGridFunction (point values, combinators, norms; 1e-12);
  * GridOperator.linear_operator, no_constraints, FunctionSpace.dof_coords,
    StructuredMesh.vertex_coords and refine (exact or 1e-14);
  * multicolor SSOR: dof_lattice_colors equal to the reference's classes,
    one SSOR apply to 1e-12, SEQ_CG_SSOR / SEQ_BCGS_SSOR taking the JAX
    package's iteration counts, and SSOR-CG beating Jacobi-CG (the
    counterpart of tests/test_krylov.py:115);
  * solvers/utilities.py: SolverStatistics, GridOperatorPreconditioner
    (1e-12), check_lop_interface and dense_jacobian (1e-13).
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

import dune_pdelab_tpu as jpt
import dune_pdelab_tpu_torch as tpt
from dune_pdelab_tpu.constraints.dirichlet import no_constraints as j_no_constraints
from dune_pdelab_tpu.fe import QkDGFEM as JQkDG
from dune_pdelab_tpu.linalg import preconditioners as jpre
from dune_pdelab_tpu.ops import ConvectionDiffusionFEM as JFEM
from dune_pdelab_tpu.ops import ConvectionDiffusionProblem as JProblem
from dune_pdelab_tpu.solvers import LinearSolverBackend as JBackend
from dune_pdelab_tpu.solvers import utilities as jutil
from dune_pdelab_tpu.space import functions as jfun
from dune_pdelab_tpu_torch.constraints import no_constraints
from dune_pdelab_tpu_torch.linalg import preconditioners as tpre
from dune_pdelab_tpu_torch.ops import ConvectionDiffusionFEM as TFEM
from dune_pdelab_tpu_torch.ops import ConvectionDiffusionProblem as TProblem
from dune_pdelab_tpu_torch.ops import LocalOperator
from dune_pdelab_tpu_torch.solvers import (
    SEQ_BCGS_SSOR, SEQ_CG_Jacobi, SEQ_CG_SSOR, LinearSolverBackend,
)
from dune_pdelab_tpu_torch.solvers import utilities as tutil
from dune_pdelab_tpu_torch.space import functions as tfun
from dune_pdelab_tpu_torch.utils.common import set_default_device

pytestmark = pytest.mark.fast
torch.set_num_threads(1)
set_default_device("cpu")
F64 = torch.float64


def _spaces(dim, n, k, dg=False):
    lo, hi = [0.0] * dim, [1.0] * dim
    jfem = JQkDG(k, dim) if dg else jpt.QkFEM(k, dim)
    tfem = tpt.QkDGFEM(k, dim) if dg else tpt.QkFEM(k, dim)
    return (jpt.FunctionSpace(jpt.StructuredMesh(lo, hi, (n,) * dim), jfem),
            tpt.FunctionSpace(tpt.StructuredMesh(lo, hi, (n,) * dim), tfem))


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)


def test_norms_and_integrals_match_jax():
    jV, tV = _spaces(2, 6, 2)
    x = np.random.default_rng(3).standard_normal(tV.ndofs)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    pairs = [(jfun.l2_norm(jV, jx), tfun.l2_norm(tV, tx)),
             (jfun.integrate_grid_function(jV, jx), tfun.integrate_grid_function(tV, tx))]
    jg = lambda p: np.stack([np.cos(p[:, 0]), p[:, 0] * p[:, 1]], axis=-1)
    tg = lambda p: torch.stack([torch.cos(p[:, 0]), p[:, 0] * p[:, 1]], dim=-1)
    pairs.append((jfun.h1_seminorm_difference(jV, jx, jg),
                  tfun.h1_seminorm_difference(tV, tx, tg)))
    for want, got in pairs:
        assert float(got) == pytest.approx(float(want), rel=1e-12)


def test_complex_l2_norm_is_real():
    """tests/test_complex.py:94-102: ||(1+i) x||_L2 = sqrt(2) ||x||, real."""
    _, V = _spaces(2, 8, 1)
    x = V.interpolate(lambda q: q[:, 0], dtype=F64).to(torch.complex128) * (1.0 + 1.0j)
    nrm = tfun.l2_norm(V, x)
    assert not nrm.is_complex()
    assert abs(float(nrm) - np.sqrt(2.0 / 3.0)) < 1e-10


def test_discrete_grid_function_matches_jax():
    jV, tV = _spaces(2, 5, 2)
    x = np.random.default_rng(4).standard_normal(tV.ndofs)
    jf = jfun.DiscreteGridFunction(jV, jnp.asarray(x))
    tf = tfun.DiscreteGridFunction(tV, torch.from_numpy(x))
    pts = np.random.default_rng(5).uniform(0.0, 1.0, (40, 2))
    pts[0] = [1.0, 1.0]                                 # the upper corner
    assert _rel(tf(pts).numpy(), jf(pts)) <= 1e-12
    assert _rel(tf(torch.from_numpy(pts)).numpy(), jf(pts)) <= 1e-12
    for jh, th in ((jf + 2.0, tf + 2.0), (jf - jf.squared(), tf - tf.squared()),
                   (3.0 * jf, 3.0 * tf), (jf * jf, tf * tf)):
        assert _rel(th(pts).numpy(), jh(pts)) <= 1e-12
    assert float(tf.l2_norm()) == pytest.approx(float(jf.l2_norm()), rel=1e-12)
    assert float(tf.integrate()) == pytest.approx(float(jf.integrate()), rel=1e-12)


def test_linear_operator_and_no_constraints():
    jV, tV = _spaces(2, 6, 1)
    jgo = jpt.GridOperator(jV, JFEM(JProblem()), constraints=jpt.constraints(True, jV))
    tgo = tpt.GridOperator(tV, TFEM(TProblem()), constraints=tpt.constraints(True, tV))
    z = np.random.default_rng(6).standard_normal(tV.ndofs)
    want = jgo.linear_operator(dtype=jnp.float64)(jnp.asarray(z))
    got = tgo.linear_operator(dtype=F64)(torch.from_numpy(z))
    assert _rel(got.numpy(), want) <= 1e-13
    nc, jnc = no_constraints(tV), j_no_constraints(jV)
    assert nc.nconstrained == 0 and np.array_equal(nc.mask_np, jnc.mask_np)
    go = tpt.GridOperator(tV, TFEM(TProblem()), constraints=nc)
    x = torch.from_numpy(z)
    assert torch.equal(go.residual(x), go.residual_unconstrained(x))


@pytest.mark.parametrize("dim,n,k,dg", [(2, 3, 2, False), (3, 2, 2, False),
                                        (2, 3, 1, True)])
def test_dof_coords_match_jax(dim, n, k, dg):
    jV, tV = _spaces(dim, n, k, dg)
    want = jV.dof_coords()
    got = tV.dof_coords()
    assert got.shape == want.shape and np.abs(got - want).max() <= 1e-14


def test_vertex_coords_and_refine_match_jax():
    lo, hi, cells = [0.5, -1.0, 0.0], [2.0, 1.0, 0.25], (3, 2, 4)
    jm, tm = jpt.StructuredMesh(lo, hi, cells), tpt.StructuredMesh(lo, hi, cells)
    assert np.array_equal(tm.vertex_coords(), jm.vertex_coords())
    jr, tr = jm.refine(), tm.refine(3)
    assert tr.cells == jm.refine(3).cells and jr.cells == tm.refine().cells
    assert np.array_equal(tr.vertex_coords(), jm.refine(3).vertex_coords())
    assert tm.refine().coarsen(2).cells == cells


class JOnes(JProblem):
    def f(self, x):
        return jnp.ones(x.shape[:-1], x.dtype)


class TOnes(TProblem):
    def f(self, x):
        return 1.0


@pytest.fixture(scope="module")
def poisson16():
    jV, tV = _spaces(2, 16, 1)
    jgo = jpt.GridOperator(jV, JFEM(JOnes()), constraints=jpt.constraints(True, jV))
    tgo = tpt.GridOperator(tV, TFEM(TOnes()), constraints=tpt.constraints(True, tV))
    b = np.array(jgo.residual(jnp.zeros(jV.ndofs)))
    return jV, tV, jgo, tgo, b


def test_dof_lattice_colors_and_ssor_apply_match_jax(poisson16):
    jV, tV, jgo, tgo, b = poisson16
    jc, tc = jpre.dof_lattice_colors(jV), tpre.dof_lattice_colors(tV)
    assert len(jc) == len(tc) == 4
    for a, c in zip(jc, tc):
        assert np.array_equal(np.asarray(a), c.numpy())
    x0 = torch.zeros(tV.ndofs, dtype=F64)
    M = tpre.ssor_preconditioner(tgo, x0, omega=1.2, sweeps=2)
    Mj = jpre.ssor_preconditioner(jgo, jnp.zeros(jV.ndofs), omega=1.2, sweeps=2)
    assert _rel(M(torch.from_numpy(b)).numpy(), Mj(jnp.asarray(b))) <= 1e-12
    A = lambda z: tgo.jacobian_apply(x0, z)
    d = tgo.jacobian_diagonal(x0)
    Aj = lambda z: jgo.jacobian_apply(jnp.zeros(jV.ndofs), z)
    want = jpre.ssor_like(Aj, jnp.asarray(d.numpy()), omega=0.8)(jnp.asarray(b))
    assert _rel(tpre.ssor_like(A, d, omega=0.8)(torch.from_numpy(b)).numpy(), want) <= 1e-12


def test_ssor_backends_take_jax_iterations(poisson16):
    jV, tV, jgo, tgo, b = poisson16
    x0 = torch.zeros(tV.ndofs, dtype=F64)
    its = {}
    for name, ls in (("cg", SEQ_CG_SSOR()), ("bicgstab", SEQ_BCGS_SSOR()),
                     ("jacobi", SEQ_CG_Jacobi())):
        z, s = ls.solve(tgo, x0, torch.from_numpy(b), 1e-10)
        assert bool(s.converged)
        its[name] = int(s.iterations)
        if name != "jacobi":
            assert "custom preconditioner partial" in ls.report(tgo)
            jb = JBackend(solver=name, precond=jpre.ssor_preconditioner)
            zj, sj = jb.solve(jgo, jnp.zeros(jV.ndofs), jnp.asarray(b), 1e-10)
            assert its[name] == int(sj.iterations)
            assert _rel(z.numpy(), zj) <= 1e-8
    # the counterpart of tests/test_krylov.py:115: SSOR-CG needs fewer steps
    assert its["cg"] < 0.8 * its["jacobi"], its


class TNoKernels(LocalOperator):
    pass


def test_solver_utilities_match_jax(poisson16):
    jV, tV, jgo, tgo, b = poisson16
    ls = SEQ_CG_Jacobi()
    x0 = torch.zeros(tV.ndofs, dtype=F64)
    for red in (1e-4, 1e-8):
        ls.solve(tgo, x0, torch.from_numpy(b), red)
    st = tutil.SolverStatistics().observe(ls)
    assert st.size == 2 and st.min() < st.max() and st.total() == sum(st.counts)
    assert st.avg() == pytest.approx(np.mean(st.counts))
    jprec = jutil.GridOperatorPreconditioner(jgo, sweeps=3)(jgo, jnp.zeros(jV.ndofs), 0.0)
    tprec = tutil.GridOperatorPreconditioner(tgo, sweeps=3)(tgo, x0, 0.0)
    assert _rel(tprec(torch.from_numpy(b)).numpy(), jprec(jnp.asarray(b))) <= 1e-12
    assert tutil.check_lop_interface(TFEM(TOnes())) == []
    with pytest.raises(TypeError, match="no kernel methods"):
        tutil.check_lop_interface(TNoKernels())
    assert tutil.check_lop_interface(TNoKernels(), raise_on_error=False) == [
        "local operator defines no kernel methods"]
    jV6, tV6 = _spaces(2, 4, 2)
    jgo6 = jpt.GridOperator(jV6, JFEM(JOnes()), constraints=jpt.constraints(True, jV6))
    tgo6 = tpt.GridOperator(tV6, TFEM(TOnes()), constraints=tpt.constraints(True, tV6))
    want = np.asarray(jutil.dense_jacobian(jgo6, jnp.zeros(jV6.ndofs)))
    got = tutil.dense_jacobian(tgo6, torch.zeros(tV6.ndofs, dtype=F64)).numpy()
    assert np.abs(got - want).max() <= 1e-13 * np.abs(want).max()
