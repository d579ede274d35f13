"""Parity of the port's hanging-node AdaptiveMesh path with the JAX package
(fp64).

  * AdaptiveMesh refine/coarsen leaves, vertices, `locate`, and the hanging
    constraint rows (rows, cols, weights in the reference's sorted order),
    equal, in 2D and 3D, including the level-0/1/2 transitive chain of
    tests/test_adaptive.py:86;
  * affine constraints: `prolong`, `restrict_transpose` and the parent
    tables, to 1e-14;
  * the Q1 GridOperator on a hanging mesh: residual, J.v, the assembled
    Jacobian (`_affine_expand`) and jacobian_diagonal, to 1e-12 of max|y|,
    and the stationary solve (linear exactness, the prolong step);
  * `adapt_local` (refine and coarsen) against the reference's transfer;
  * the fast tiers decline the affine-constrained operator.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

import dune_pdelab_tpu as jpt
import dune_pdelab_tpu_torch as tpt
from dune_pdelab_tpu.adaptivity.local import adapt_local as j_adapt_local
from dune_pdelab_tpu.mesh.adaptive import AdaptiveMesh as JAM
from dune_pdelab_tpu.ops import ConvectionDiffusionFEM as JFEM
from dune_pdelab_tpu.ops import ConvectionDiffusionProblem as JProblem
from dune_pdelab_tpu_torch.adaptivity.local import adapt_local as t_adapt_local
from dune_pdelab_tpu_torch.interop import adaptive_mesh_from_numpy
from dune_pdelab_tpu_torch.mesh import AdaptiveMesh as TAM
from dune_pdelab_tpu_torch.ops import ConvectionDiffusionFEM as TFEM
from dune_pdelab_tpu_torch.ops import ConvectionDiffusionProblem as TProblem
from dune_pdelab_tpu_torch.space.functions import l2_difference as t_l2
from dune_pdelab_tpu_torch.utils.common import set_default_device

pytestmark = pytest.mark.fast
torch.set_num_threads(1)
set_default_device("cpu")
F64 = torch.float64


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _chain(cls):
    """tests/test_adaptive.py:86: a level-0/1/2 chain across cell faces."""
    m = cls([0, 0], [1, 1], (2, 1)).refine([True, False])
    marks = np.zeros(m.nelements, bool)
    lvl1 = np.nonzero(m.levels == 1)[0]
    xs = m.origins[lvl1, 0]
    marks[lvl1[xs == xs.max()]] = True
    return m.refine(marks)


def _meshes(case):
    if case == "chain":
        return _chain(JAM), _chain(TAM)
    if case == "2d":
        out = []
        for cls in (JAM, TAM):
            m = cls([0, 0], [1, 1], (4, 4))
            marks = np.zeros(m.nelements, bool)
            marks[[0, 5, 10]] = True
            m = m.refine(marks)
            marks = np.zeros(m.nelements, bool)
            marks[:3] = True
            out.append(m.refine(marks))
        return tuple(out)
    out = []
    for cls in (JAM, TAM):
        m = cls([0, 0, 0], [1, 1, 1], (2, 2, 2)).refine([True] + [False] * 7)
        marks = np.zeros(m.nelements, bool)
        marks[:2] = True
        out.append(m.refine(marks))
    return tuple(out)


@pytest.mark.parametrize("case", ["chain", "2d", "3d"])
def test_mesh_and_hanging_rows_equal(case):
    jm, tm = _meshes(case)
    assert jm.max_level == tm.max_level and jm.nelements == tm.nelements
    np.testing.assert_array_equal(tm.levels, jm.levels)
    np.testing.assert_array_equal(tm.origins, jm.origins)
    for a, b in zip(tm.vertices(), jm.vertices()):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tm.element_corner_coords(), jm.element_corner_coords())
    np.testing.assert_array_equal(tm.boundary_vertex_mask(), jm.boundary_vertex_mask())
    jr, tr = jm.hanging_constraints(), tm.hanging_constraints()
    assert len(jr[0]) > 0
    for a, b in zip(tr, jr):
        np.testing.assert_array_equal(a, b)
    if case == "chain":
        # transitive resolution: no parent is itself hanging
        assert not np.isin(tr[1], tr[0]).any()
        assert np.allclose(np.bincount(tr[0], tr[2])[np.unique(tr[0])], 1.0)
    pts = np.random.default_rng(1).random((20, jm.dim))
    for a, b in zip(tm.locate(pts), jm.locate(pts)):
        np.testing.assert_array_equal(a, b)
    rt = adaptive_mesh_from_numpy(jm.lower, jm.upper, jm.coarse_cells, jm.levels,
                                  jm.origins, jm.max_level)
    for a, b in zip(rt.hanging_constraints(), jr):
        np.testing.assert_array_equal(a, b)


def test_refine_coarsen_equal():
    jm, tm = _meshes("2d")
    cm = np.zeros(jm.nelements, bool)
    cm[::2] = True
    cm[-8:] = True
    jc, tc = jm.coarsen(cm), tm.coarsen(cm)
    np.testing.assert_array_equal(tc.levels, jc.levels)
    np.testing.assert_array_equal(tc.origins, jc.origins)
    jc2, tc2 = jm.coarsen(np.ones(jm.nelements, bool)), tm.coarsen(np.ones(tm.nelements, bool))
    np.testing.assert_array_equal(tc2.origins, jc2.origins)
    assert tc2.max_level == jc2.max_level


class JSmooth(JProblem):
    def f(self, x):
        return 5 * np.pi ** 2 * jnp.sin(np.pi * x[..., 0]) * jnp.cos(2 * np.pi * x[..., 1])

    def g(self, x):
        return jnp.sin(np.pi * x[..., 0]) * jnp.cos(2 * np.pi * x[..., 1])


class TSmooth(TProblem):
    def f(self, x):
        return 5 * np.pi ** 2 * torch.sin(np.pi * x[..., 0]) * torch.cos(2 * np.pi * x[..., 1])

    def g(self, x):
        return torch.sin(np.pi * x[..., 0]) * torch.cos(2 * np.pi * x[..., 1])


def _ops(case):
    jm, tm = _meshes(case)
    dim = jm.dim
    jV, tV = jpt.FunctionSpace(jm, jpt.QkFEM(1, dim)), tpt.FunctionSpace(tm, tpt.QkFEM(1, dim))
    jc, tc = jpt.constraints(True, jV), tpt.constraints(True, tV)
    jgo = jpt.GridOperator(jV, JFEM(JSmooth()), constraints=jc, skip_boundary=True)
    tgo = tpt.GridOperator(tV, TFEM(TSmooth()), constraints=tc, skip_boundary=True)
    return jgo, tgo


@pytest.mark.parametrize("case", ["chain", "2d", "3d"])
def test_affine_operator_matches_jax(case):
    jgo, tgo = _ops(case)
    jc, tc = jgo.cg, tgo.cg
    assert tc.has_affine and jc.has_affine
    np.testing.assert_array_equal(tc.mask_np, jc.mask_np)
    np.testing.assert_array_equal(tc._parent_indptr, jc._parent_indptr)
    np.testing.assert_array_equal(tc._parent_idx, jc._parent_idx)
    np.testing.assert_array_equal(tc._parent_w, jc._parent_w)
    rng = np.random.default_rng(7)
    n = tgo.space.ndofs
    x, z = rng.standard_normal(n), rng.standard_normal(n)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    assert _rel(tc.prolong(tx).numpy(), np.asarray(jc.prolong(jx))) <= 1e-14
    assert _rel(tc.restrict_transpose(tx).numpy(),
                np.asarray(jc.restrict_transpose(jx))) <= 1e-14
    assert _rel(tgo.residual(tx).numpy(), np.asarray(jgo.residual(jx))) <= 1e-12
    jz, tz = jnp.asarray(z), torch.from_numpy(z)
    y = tgo.jacobian_apply(tx, tz)
    assert _rel(y.numpy(), np.asarray(jgo.jacobian_apply(jx, jz))) <= 1e-12
    A = tgo.jacobian_csr(tx)
    Aj = np.asarray(jgo.jacobian(jx).todense())
    assert _rel(A.toarray(), Aj) <= 1e-12
    assert _rel(A @ z, y.numpy()) <= 1e-12          # assembled == matrix-free
    assert _rel(tgo.jacobian_diagonal(tx).numpy(),
                np.asarray(jgo.jacobian_diagonal(jx))) <= 1e-12
    # deterministic sums: two calls give the same bits
    assert torch.equal(tgo.residual(tx), tgo.residual(tx))


def test_linear_exactness_and_solver_prolong():
    class TLin(TProblem):
        def g(self, x):
            return 2.0 * x[..., 0] - 3.0 * x[..., 1] + 1.0

    _, tm = _meshes("chain")
    V = tpt.FunctionSpace(tm, tpt.QkFEM(1, 2))
    cg = tpt.constraints(True, V)
    go = tpt.GridOperator(V, TFEM(TLin()), constraints=cg, skip_boundary=True)
    x0 = tpt.interpolate_dirichlet(TLin().g, V, cg, V.zero(F64))
    x = tpt.StationaryLinearProblemSolver(go, tpt.SEQ_CG_Jacobi(), reduction=1e-12,
                                          verbose=0).apply(x0)
    err = float(t_l2(V, x, lambda p: 2.0 * p[:, 0] - 3.0 * p[:, 1] + 1.0))
    assert err < 1e-10
    # the returned vector is hanging-consistent
    assert torch.equal(cg.prolong(x), x)


def test_adapt_local_matches_jax():
    jm, tm = _meshes("2d")
    jV, tV = jpt.FunctionSpace(jm, jpt.QkFEM(1, 2)), tpt.FunctionSpace(tm, tpt.QkFEM(1, 2))
    rng = np.random.default_rng(3)
    x = np.asarray(jpt.constraints(True, jV).prolong(jnp.asarray(rng.standard_normal(jV.ndofs))))
    marks = np.zeros(jm.nelements, bool)
    marks[[1, 4, 9]] = True
    cmarks = np.zeros(jm.nelements, bool)
    cmarks[-12:] = True
    for cm in (None, cmarks):
        jV2, jx2 = j_adapt_local(jV, jnp.asarray(x), marks, cm)
        tV2, tx2 = t_adapt_local(tV, torch.from_numpy(x), marks, cm)
        np.testing.assert_array_equal(tV2.mesh.origins, jV2.mesh.origins)
        assert _rel(tx2.numpy(), np.asarray(jx2)) <= 1e-13
    # first adapt from a StructuredMesh
    jV0 = jpt.FunctionSpace(jpt.StructuredMesh([0, 0], [1, 1], (3, 3)), jpt.QkFEM(1, 2))
    tV0 = tpt.FunctionSpace(tpt.StructuredMesh([0, 0], [1, 1], (3, 3)), tpt.QkFEM(1, 2))
    x0 = rng.standard_normal(jV0.ndofs)
    m0 = np.arange(9) % 4 == 0
    jV1, jx1 = j_adapt_local(jV0, jnp.asarray(x0), m0)
    tV1, tx1 = t_adapt_local(tV0, torch.from_numpy(x0), m0)
    assert _rel(tx1.numpy(), np.asarray(jx1)) <= 1e-13


@pytest.mark.parametrize("case", ["2d", "3d"])
def test_fast_tiers_decline_hanging_operator(case):
    from dune_pdelab_tpu_torch.assembly.ell import assemble_ell, assemble_ell_direct
    from dune_pdelab_tpu_torch.assembly.slabbed import residual_slabbed
    from dune_pdelab_tpu_torch.assembly.stencil import compile_stencil
    from dune_pdelab_tpu_torch.assembly.structured_fused import (
        make_fused_japply, make_fused_residual,
    )
    from dune_pdelab_tpu_torch.linalg.gmg_lattice import LatticeGMG
    from dune_pdelab_tpu_torch.linalg.gmg_varcoeff import VarCoeffGMG

    _, tgo = _ops(case)
    V = tgo.space
    x = V.zero(F64)
    assert compile_stencil(tgo, x) is None
    assert assemble_ell(tgo, x) is None and assemble_ell_direct(tgo, x) is None
    assert make_fused_residual(tgo) is None and make_fused_japply(tgo) is None
    with pytest.raises(ValueError, match="uniform non-periodic"):
        residual_slabbed(V, tgo.lop, tgo.cg, x)
    with pytest.raises(ValueError, match="uniform non-periodic"):
        LatticeGMG(V, tgo.lop)
    with pytest.raises(ValueError, match="uniform non-periodic"):
        VarCoeffGMG(tgo)
    with pytest.raises(NotImplementedError, match="Q1"):
        tpt.FunctionSpace(V.mesh, tpt.QkDGFEM(1, V.mesh.dim))   # no DG: no block stencil
    ls = tpt.SEQ_CG_Jacobi()
    _, s = ls.solve(tgo, x, tgo.residual(x), 1e-10)
    assert bool(s.converged) and "general-jvp" in ls.report()
    assert "compile_stencil declined" in ls.report()
    ell = tpt.SEQ_CG_Jacobi(matrix_free=False)
    ell.solve(tgo, x, tgo.residual(x), 1e-10)
    assert "assemble_ell declined" in ell.report()
