"""Parity of the PyTorch port's stencil compilation and apply with JAX.

compile_stencil weights (k = 1 and k = 2, direct and proxy branch),
StencilOperator apply and `.diagonal`, and stencil27's plain version against
the JAX package's Pallas stencil kernels run in interpret mode (as
tests/test_stencil.py runs them on the CPU).
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

import dune_pdelab_tpu as jpt
import dune_pdelab_tpu_torch as tpt
from dune_pdelab_tpu.assembly.stencil import compile_stencil as j_compile
from dune_pdelab_tpu.assembly.stencil_pallas import try_pallas_stencil
from dune_pdelab_tpu.assembly.stencil_pallas_tile import try_pallas_tiled_stencil
from dune_pdelab_tpu.ops import ConvectionDiffusionFEM as JFEM
from dune_pdelab_tpu.ops import ConvectionDiffusionProblem as JProblem
from dune_pdelab_tpu_torch.assembly import stencil as tst
from dune_pdelab_tpu_torch.interop import stencil_from_numpy, vector_from_numpy
from dune_pdelab_tpu_torch.kernels import stencil27 as sk
from dune_pdelab_tpu_torch.ops import ConvectionDiffusionFEM as TFEM
from dune_pdelab_tpu_torch.ops import ConvectionDiffusionProblem as TProblem
from dune_pdelab_tpu_torch.utils.common import set_default_device

pytestmark = pytest.mark.fast
torch.set_num_threads(1)
set_default_device("cpu")


class JConst(JProblem):
    def A(self, x):
        return 2.0

    def b(self, x):
        return jnp.broadcast_to(jnp.asarray([0.5, -0.25, 0.1][:x.shape[-1]]), x.shape)

    def c(self, x):
        return 0.3


class TConst(TProblem):
    def A(self, x):
        return 2.0

    def b(self, x):
        v = torch.tensor([0.5, -0.25, 0.1][:x.shape[-1]], dtype=x.dtype)
        return torch.broadcast_to(v, x.shape)

    def c(self, x):
        return 0.3


class TVarA(TProblem):
    def A(self, x):
        return 1.0 + x[..., 0]


def _pair(dim, k, cells, bc=True):
    lo, hi = [0.0] * dim, [1.0] * dim
    jV = jpt.FunctionSpace(jpt.StructuredMesh(lo, hi, cells), jpt.QkFEM(k, dim))
    tV = tpt.FunctionSpace(tpt.StructuredMesh(lo, hi, cells), tpt.QkFEM(k, dim))
    jgo = jpt.GridOperator(jV, JFEM(JConst()), constraints=jpt.constraints(bc, jV),
                           skip_boundary=True)
    tgo = tpt.GridOperator(tV, TFEM(TConst()), constraints=tpt.constraints(bc, tV),
                           skip_boundary=True)
    return jgo, tgo


CASES = [(3, 1, (6, 6, 7)), (2, 2, (7, 6)), (3, 2, (6, 6, 6))]


@pytest.mark.parametrize("dim,k,cells", CASES)
def test_compiled_weights_match_jax(dim, k, cells):
    jgo, tgo = _pair(dim, k, cells)
    jst, tst_ = j_compile(jgo), tst.compile_stencil(tgo, dtype=torch.float64)
    assert jst is not None and tst_ is not None
    np.testing.assert_array_equal(tst_.offsets, jst.offsets)
    assert tst_.dims == jst.dims and tst_.k == jst.k
    scale = np.abs(jst.weights).max()
    assert np.abs(tst_.weights - jst.weights).max() <= 1e-12 * scale


@pytest.mark.parametrize("dim,k,cells", [(3, 1, (10, 10, 11)), (2, 2, (24, 22))])
def test_proxy_branch_matches_direct_probe(dim, k, cells, monkeypatch):
    jgo, tgo = _pair(dim, k, cells)
    jst = j_compile(jgo)          # JAX: below its 200k threshold -> direct probe
    calls = []
    real_go = tst.compile_stencil

    def spy(go, *a, **kw):
        calls.append(go.mesh.cells)
        return real_go(go, *a, **kw)
    monkeypatch.setattr(tst, "PROXY_MIN_ELEMENTS", 520)
    monkeypatch.setattr(tst, "compile_stencil", spy)
    st = tst.compile_stencil(tgo, dtype=torch.float64)
    assert len(calls) == 2 and calls[1] != cells      # recursed on the proxy
    assert st.dims == jst.dims and st.mask is not None
    scale = np.abs(jst.weights).max()
    assert np.abs(st.weights - jst.weights).max() <= 1e-12 * scale


@pytest.mark.parametrize("dim,k,cells", CASES[:2])
def test_interior_classes_match_jax(dim, k, cells, monkeypatch):
    """StencilOperator stores the residue classes as the reference does,
    and the proxy branch of compile_stencil passes them on."""
    jgo, tgo = _pair(dim, k, cells)
    want = [tuple(c) for c in j_compile(jgo).interior_classes]
    st = tst.compile_stencil(tgo, dtype=torch.float64)
    assert [tuple(c) for c in st.interior_classes] == want
    assert len(want) == st.weights.shape[0] == k**dim
    # threshold = the proxy mesh's own element count, so the proxy does
    # not recurse (see Queue 3 of ROADMAP.md)
    monkeypatch.setattr(tst, "PROXY_MIN_ELEMENTS", max(8, 4 * k + 4) ** dim)
    _, tgo_big = _pair(dim, k, tuple(2 * c + 1 for c in cells))
    st_p = tst.compile_stencil(tgo_big, dtype=torch.float64)
    assert [tuple(c) for c in st_p.interior_classes] == want


@pytest.mark.parametrize("dim,k,cells", CASES)
def test_apply_and_diagonal_match_jax(dim, k, cells):
    jgo, tgo = _pair(dim, k, cells)
    jst, tst_ = j_compile(jgo), tst.compile_stencil(tgo, dtype=torch.float64)
    assert tst_.uses_stencil27 == (dim == 3 and k == 1)
    rng = np.random.default_rng(dim + 7 * k)
    for _ in range(2):
        z = rng.standard_normal(tgo.space.ndofs)
        want = np.asarray(jst(jnp.asarray(z)))
        got = tst_(torch.from_numpy(z)).numpy()
        assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
        plain = tst_._apply_impl(torch.from_numpy(z)).numpy()
        assert np.abs(plain - want).max() <= 1e-12 * np.abs(want).max()
        jz = np.asarray(jgo.jacobian_apply(jnp.zeros(tgo.space.ndofs), jnp.asarray(z)))
        assert np.abs(got - jz).max() <= 1e-11 * np.abs(jz).max()
    d_t = tst_.diagonal(dtype=torch.float64).numpy()
    d_j = np.asarray(jst.diagonal(dtype=jnp.float64))
    np.testing.assert_allclose(d_t, d_j, rtol=1e-13, atol=0)


def test_interop_stencil_equals_compiled():
    jgo, tgo = _pair(3, 1, (6, 7, 6))
    jst = j_compile(jgo)
    st = stencil_from_numpy(jst.dims, jst.k, jst.weights, jst.offsets,
                            np.asarray(jst.mask), dtype=torch.float64)
    z = np.random.default_rng(1).standard_normal(tgo.space.ndofs)
    got = st(vector_from_numpy(z)).numpy()
    want = np.asarray(jst(jnp.asarray(z)))
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


@pytest.mark.parametrize("lowering", ["tiled", "flat"])
def test_stencil27_reference_matches_pallas_interpret(lowering):
    """stencil27's plain version against the JAX Pallas kernels it replaces
    (K2a tiled, K2b flat), interpret mode, f32, unaligned grid."""
    jgo, _ = _pair(3, 1, (6, 8, 7))
    jst = j_compile(jgo)
    if lowering == "tiled":
        pal = try_pallas_tiled_stencil(jst, interpret=True, row_block=24)
    else:
        pal = try_pallas_stencil(jst, interpret=True)
    assert pal is not None
    z = np.random.default_rng(11).standard_normal(jgo.space.ndofs).astype(np.float32)
    want = np.asarray(pal(jnp.asarray(z)))
    st = stencil_from_numpy(jst.dims, jst.k, jst.weights, jst.offsets,
                            np.asarray(jst.mask), dtype=torch.float32)
    got = sk.stencil27_reference(torch.from_numpy(z), st.mask, st.w27, st.dims)
    assert got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    assert torch.equal(sk.stencil27(torch.from_numpy(z), st.mask, st.w27, st.dims), got)


def test_stencil27_wrapper_checks_inputs():
    dims = (4, 5, 3)
    z = torch.zeros(60)
    w = np.ones((3, 3, 3))
    with pytest.raises(ValueError, match="shape"):
        sk.stencil27(torch.zeros(59), None, w, dims)
    with pytest.raises(ValueError, match="contiguous"):
        sk.stencil27(torch.zeros(120)[::2], None, w, dims)
    with pytest.raises(TypeError, match="dtype"):
        sk.stencil27(z, torch.zeros(60, dtype=torch.uint8), w, dims)
    with pytest.raises(ValueError, match=">= 3"):
        sk.stencil27(torch.zeros(40), None, w, (4, 5, 2))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        sk.stencil27(z.to("meta"), None, w, dims)
    before = sk.launches
    sk.stencil27(z, None, w, dims)              # CPU tensor: plain version
    assert sk.launches == before


def test_stencil27_fault_raises_instead_of_declining(monkeypatch):
    """A stencil27 result that disagrees with the plain stencil raises from
    compile_stencil; it does not read as a declined (non-invariant) operator."""
    _, tgo = _pair(3, 1, (6, 6, 7))
    real = tst.stencil27
    monkeypatch.setattr(tst, "stencil27",
                        lambda z, mask, w27, dims: 1.001 * real(z, mask, w27, dims))
    with pytest.raises(RuntimeError, match="stencil27 .* disagrees"):
        tst.compile_stencil(tgo, dtype=torch.float64)


def test_compile_stencil_declines_like_jax():
    V = tpt.FunctionSpace(tpt.StructuredMesh([0, 0], [1, 1], (10, 10)), tpt.QkFEM(1, 2))
    go = tpt.GridOperator(V, TFEM(TVarA()), constraints=tpt.constraints(True, V),
                          skip_boundary=True)
    assert tst.compile_stencil(go, dtype=torch.float64) is None
    part = tpt.constraints(lambda x: np.isclose(x[:, 0], 0.0), V)
    go = tpt.GridOperator(V, TFEM(TConst()), constraints=part, skip_boundary=True)
    assert tst.compile_stencil(go, dtype=torch.float64) is None
    assert not tst._coefficients_spatially_constant(TFEM(TVarA()), V.mesh)
    assert tst._coefficients_spatially_constant(TFEM(TConst()), V.mesh)
