"""Parity of the port's DG block stencil with the JAX package.

  * compile_block_stencil's W_taps and dD_sides against the JAX package's,
    direct branch (2D Q2, 3D Q1) and the port's proxy branch (threshold
    lowered, above the 6^3 proxy so it does not recurse) against the JAX
    direct branch on the same mesh (1e-12);
  * the plain element-major apply and the diagonal against the JAX
    BlockStencilOperator, 2D and 3D (1e-12 relative), also on an operator
    carried across with interop.block_stencil_from_numpy;
  * the plain mode-major and element-major applies (kernels/blockstencil.py)
    against the Pallas kernels they replace, try_mm_block_stencil(mode=
    "mxu2") (K5b) and try_pallas_block_stencil (K6) in interpret mode, at
    the smallest shape, fp32 (1e-5 max|y|);
  * assemble_block_ell and its apply against the JAX package's (1e-12);
  * the two layouts agree, the wrappers check their inputs, and the
    backend's block-stencil tier runs CG mode-major resident with the same
    iterations and solution as CG on the element-major apply.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

import dune_pdelab_tpu as jpt
import dune_pdelab_tpu_torch as tpt
from dune_pdelab_tpu.assembly import blockstencil as jbs
from dune_pdelab_tpu.assembly.blockstencil_mm import try_mm_block_stencil as j_try_mm
from dune_pdelab_tpu.assembly.blockstencil_pallas import (
    try_pallas_block_stencil as j_try_pallas,
)
from dune_pdelab_tpu.fe import QkDGFEM as JQkDG
from dune_pdelab_tpu.ops import ConvectionDiffusionProblem as JProblem
from dune_pdelab_tpu.ops.convectiondiffusiondg import ConvectionDiffusionDG as JDG
from dune_pdelab_tpu_torch.assembly import blockstencil as tbs
from dune_pdelab_tpu_torch.assembly import stencil as tstencil
from dune_pdelab_tpu_torch.assembly.blockstencil_mm import (
    MMBlockStencil, try_mm_block_stencil,
)
from dune_pdelab_tpu_torch.assembly.blockstencil_pallas import try_pallas_block_stencil
from dune_pdelab_tpu_torch.interop import block_stencil_from_numpy
from dune_pdelab_tpu_torch.kernels import blockstencil as bk
from dune_pdelab_tpu_torch.ops import ConvectionDiffusionDG as TDG
from dune_pdelab_tpu_torch.ops import ConvectionDiffusionProblem as TProblem
from dune_pdelab_tpu_torch.linalg import cg
from dune_pdelab_tpu_torch.solvers import LinearSolverBackend
from dune_pdelab_tpu_torch.utils.common import set_default_device

pytestmark = pytest.mark.fast
torch.set_num_threads(1)
set_default_device("cpu")

F64 = torch.float64


class JConv(JProblem):
    def A(self, x):
        return 1.5

    def b(self, x):
        return jnp.broadcast_to(jnp.asarray([1.0, -0.5, 0.25][:x.shape[-1]]), x.shape)

    def c(self, x):
        return 0.2


class TConv(TProblem):
    def A(self, x):
        return 1.5

    def b(self, x):
        v = torch.tensor([1.0, -0.5, 0.25][:x.shape[-1]], dtype=x.dtype)
        return torch.broadcast_to(v, x.shape)

    def c(self, x):
        return 0.2


def _pair(dim, k, cells):
    lo, hi = [0.0] * dim, [1.0] * dim
    jV = jpt.FunctionSpace(jpt.StructuredMesh(lo, hi, cells), JQkDG(k, dim))
    tV = tpt.FunctionSpace(tpt.StructuredMesh(lo, hi, cells), tpt.QkDGFEM(k, dim))
    return jpt.GridOperator(jV, JDG(JConv())), tpt.GridOperator(tV, TDG(TConv()))


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.fixture(scope="module", params=[(2, 2, (6, 5)), (3, 1, (5, 6, 5))],
                ids=["2d_q2", "3d_q1"])
def compiled(request):
    dim, k, cells = request.param
    jgo, tgo = _pair(dim, k, cells)
    jst = jbs.compile_block_stencil(jgo)
    tst = tbs.compile_block_stencil(tgo, dtype=F64)
    return jgo, tgo, jst, tst


def test_compile_direct_matches_jax(compiled):
    _, _, jst, tst = compiled
    np.testing.assert_array_equal(tst.offsets, jst.offsets)
    assert np.abs(tst.W_taps - jst.W_taps).max() <= 1e-12
    assert np.abs(tst.dD_sides - jst.dD_sides).max() <= 1e-12


def test_plain_apply_and_diagonal_match_jax(compiled):
    _, tgo, jst, tst = compiled
    z = np.random.default_rng(21).standard_normal(tgo.space.ndofs)
    want = np.asarray(jst(jnp.asarray(z)))
    carried = block_stencil_from_numpy(jst.cells, jst.nb, jst.W_taps, jst.offsets,
                                       jst.dD_sides)
    for op in (tst, carried):
        assert _rel(op(torch.from_numpy(z)).numpy(), want) <= 1e-12
    assert _rel(tst.diagonal(F64).numpy(), np.asarray(jst.diagonal(jnp.float64))) <= 1e-12
    # the operator is the Jacobian: plain apply against jacobian_apply
    zt = torch.from_numpy(z)
    assert _rel(tst(zt).numpy(), tgo.jacobian_apply(torch.zeros_like(zt), zt).numpy()) <= 1e-12


def test_compile_proxy_branch_matches_jax_direct(monkeypatch):
    monkeypatch.setattr(tstencil, "PROXY_MIN_ELEMENTS", 300)   # 8^3 > 300 >= 6^3
    jgo, tgo = _pair(3, 1, (8, 8, 8))
    jst = jbs.compile_block_stencil(jgo)
    tst = tbs.compile_block_stencil(tgo, dtype=F64)
    assert tst.cells == (8, 8, 8)
    assert np.abs(tst.W_taps - jst.W_taps).max() <= 1e-12
    assert np.abs(tst.dD_sides - jst.dD_sides).max() <= 1e-12


@pytest.fixture(scope="module")
def smallest():
    jgo, tgo = _pair(3, 1, (5, 5, 5))
    jst = jbs.compile_block_stencil(jgo)
    tst = block_stencil_from_numpy(jst.cells, jst.nb, jst.W_taps, jst.offsets,
                                   jst.dD_sides, dtype=torch.float32)
    z = np.random.default_rng(22).standard_normal(tgo.space.ndofs).astype(np.float32)
    return jst, tst, z


def test_mode_major_plain_matches_pallas_mxu2(smallest):
    jst, tst, z = smallest
    apply_flat = j_try_mm(jst, interpret=True, mode="mxu2")[0]
    want = np.asarray(apply_flat(jnp.asarray(z)))
    mm = try_mm_block_stencil(tst)
    zt = torch.from_numpy(z)
    got = mm.from_mm(bk.block_stencil_mm_reference(
        mm.to_mm(zt), *tst.taps(torch.float32, "cpu"), tst.cells))
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    assert torch.equal(mm(zt), got)


def test_element_major_plain_matches_pallas_k6(smallest):
    jst, tst, z = smallest
    want = np.asarray(j_try_pallas(jst, interpret=True)(jnp.asarray(z)))
    zt = torch.from_numpy(z)
    got = bk.block_stencil_em_reference(zt, *tst.taps(torch.float32, "cpu"), tst.cells)
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    assert torch.equal(try_pallas_block_stencil(tst)(zt), got)


def test_assemble_block_ell_matches_jax():
    jgo, tgo = _pair(2, 1, (5, 4))
    jell = jbs.assemble_block_ell(jgo)
    tell = tbs.assemble_block_ell(tgo, torch.zeros(tgo.space.ndofs, dtype=F64))
    assert np.abs(tell.values.numpy() - np.asarray(jell.values)).max() <= 1e-12
    z = np.random.default_rng(23).standard_normal(tgo.space.ndofs)
    assert _rel(tell(torch.from_numpy(z)).numpy(), np.asarray(jell(jnp.asarray(z)))) <= 1e-12
    assert tell.pattern_stats()["nnz_stored"] == jell.pattern_stats()["nnz_stored"]


@pytest.mark.parametrize("cells,nb", [((4, 3, 5), 8), ((3, 4, 2), 27), ((5, 3, 4), 5)])
def test_layouts_agree(cells, nb):
    """Mode-major and element-major plain versions of one random stencil
    (random W and dD, any nb) give the same values."""
    rng = np.random.default_rng(nb)
    W = torch.from_numpy(rng.standard_normal((7, nb, nb)))
    dD = torch.from_numpy(rng.standard_normal((3, 2, nb, nb)))
    z = torch.from_numpy(rng.standard_normal(int(np.prod(cells)) * nb))
    op = MMBlockStencil(tbs.BlockStencilOperator(cells, nb, np.zeros((7, nb, nb)),
                                                 tbs.face_offsets(3), np.zeros((3, 2, nb, nb))))
    em = bk.block_stencil_em(z, W, dD, cells)
    mm = op.from_mm(bk.block_stencil_mm(op.to_mm(z), W, dD, cells))
    assert _rel(mm.numpy(), em.numpy()) <= 1e-14


def test_2d_ignores_z_taps_and_wrappers_check_inputs():
    rng = np.random.default_rng(24)
    nb, cells = 4, (5, 3)
    W = torch.from_numpy(rng.standard_normal((7, nb, nb)))
    dD = torch.from_numpy(rng.standard_normal((3, 2, nb, nb)))
    z = torch.from_numpy(rng.standard_normal(15 * nb))
    W0, dD0 = W.clone(), dD.clone()
    W0[5:], dD0[2] = 0.0, 0.0
    assert torch.equal(bk.block_stencil_em(z, W, dD, cells),
                       bk.block_stencil_em(z, W0, dD0, cells))
    with pytest.raises(ValueError, match="shape"):
        bk.block_stencil_em(z[:-1], W, dD, cells)
    with pytest.raises(TypeError, match="dtype"):
        bk.block_stencil_em(z.float(), W, dD, cells)
    with pytest.raises(ValueError, match="3D"):
        bk.block_stencil_mm(z, W, dD, cells)
    with pytest.raises(ValueError, match="face tap"):
        bk.tap_tensors(np.zeros((1, nb, nb)), [[1, 1]], np.zeros((2, 2, nb, nb)),
                       F64, "cpu")


@pytest.mark.parametrize("precond", ["jacobi", "richardson"])
def test_backend_runs_block_stencil_mode_major_resident(precond):
    _, tgo = _pair(3, 1, (5, 6, 5))
    b = tgo.residual(torch.from_numpy(
        np.random.default_rng(25).standard_normal(tgo.space.ndofs)))
    x0 = torch.zeros_like(b)
    ls = LinearSolverBackend(precond=precond)
    z, s = ls.solve(tgo, x0, b, 1e-10)
    assert ("compiled block stencil MMBlockStencil [mode-major resident; blockstencil "
            "plain torch (CPU tensor)]") in ls.report(tgo)
    # the same CG on the element-major plain apply
    st = ls._stencil_for(tgo, x0, 0.0).source
    diag = st.diagonal(F64) if precond == "jacobi" else torch.ones_like(b)
    z_ref, s_ref = cg(st, b, M=lambda r: r / diag, tol=1e-10)
    assert bool(s.converged) and s.iterations == s_ref.iterations
    assert _rel(z.numpy(), z_ref.numpy()) <= 1e-9
