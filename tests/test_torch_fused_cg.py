"""Parity of the PyTorch port's fused CG with the JAX package.

The plain versions of fused_cg_k1/k2 (what the CUDA kernels compute) against
JAX build_fused_cg_kernels in interpret mode, with the checks of
tests/test_fused_cg.py; the port's make_fused_cg against JAX make_fused_cg
(f32, interpret mode) and against JAX linalg.cg on the stencil (fp64).
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

import dune_pdelab_tpu as jpt
import dune_pdelab_tpu_torch as tpt
from dune_pdelab_tpu.assembly.fused_cg_pallas import (
    build_fused_cg_kernels, make_fused_cg as j_make_fused_cg,
)
from dune_pdelab_tpu.assembly.stencil import compile_stencil as j_compile
from dune_pdelab_tpu.linalg import cg as j_cg
from dune_pdelab_tpu.ops import ConvectionDiffusionFEM as JFEM
from dune_pdelab_tpu.ops import ConvectionDiffusionProblem as JProblem
from dune_pdelab_tpu_torch.assembly.fused_cg import make_fused_cg, qualifies
from dune_pdelab_tpu_torch.assembly.stencil import compile_stencil
from dune_pdelab_tpu_torch.interop import stencil_from_numpy, vector_from_numpy
from dune_pdelab_tpu_torch.kernels import fused_cg as fk
from dune_pdelab_tpu_torch.ops import ConvectionDiffusionFEM as TFEM
from dune_pdelab_tpu_torch.ops import ConvectionDiffusionProblem as TProblem

pytestmark = pytest.mark.fast
torch.set_num_threads(1)


class JP(JProblem):
    def f(self, x):
        return jnp.sin(3.0 * x[..., 0]) * x[..., 1] + 1.0


class TP(TProblem):
    def f(self, x):
        return torch.sin(3.0 * x[..., 0]) * x[..., 1] + 1.0


@pytest.fixture(scope="module")
def setup():
    """11^3-cell 3D Poisson: JAX grid operator + stencil, port stencil
    built from the JAX one's numpy data (f32 weights and fp64 weights)."""
    mesh = jpt.StructuredMesh([0, 0, 0], [1, 1, 1], (11, 11, 11))
    V = jpt.FunctionSpace(mesh, jpt.QkFEM(1, 3))
    go = jpt.GridOperator(V, JFEM(JP()), constraints=jpt.constraints(True, V))
    st = j_compile(go)
    args = (st.dims, st.k, st.weights, st.offsets, np.asarray(st.mask))
    return go, st, stencil_from_numpy(*args, dtype=torch.float32), \
        stencil_from_numpy(*args, dtype=torch.float64)


def test_plain_kernels_match_jax_interpret(setup):
    go, st, tst32, _ = setup
    nx, ny, nz = st.dims
    k1, k2 = build_fused_cg_kernels(st.dims, st.offsets, st.weights[0],
                                    interpret=True)
    rng = np.random.default_rng(0)
    zf = rng.standard_normal(go.space.ndofs).astype(np.float32)
    m = np.asarray(st.mask)
    zf[m] = 0.0
    y_ref = np.asarray(st(jnp.asarray(zf))).copy()
    y_ref[m] = 0.0
    zg_j = jnp.asarray(zf).reshape(nz, ny, nx)
    zg = torch.from_numpy(zf).reshape(nz, ny, nx)
    zero = torch.zeros_like(zg)

    # K2 with x=r=0, alpha=-1 exposes the raw operator: r' = A p
    _, rn_j, rr_j = k2(jnp.zeros_like(zg_j), jnp.zeros_like(zg_j), zg_j,
                       jnp.float32(-1.0))
    _, rn, rr = fk.fused_cg_k2(zero, zero, zg, torch.tensor(-1.0), tst32.w27)
    assert rn.dtype == torch.float32 and rr.dtype == torch.float32
    assert np.abs(rn.numpy().reshape(-1) - y_ref).max() < 1e-5 * max(1.0, np.abs(y_ref).max())
    assert np.abs(rn.numpy() - np.asarray(rn_j)).max() < 1e-5 * np.abs(y_ref).max()
    yy = float(np.dot(y_ref, y_ref))
    assert abs(float(rr) - yy) < 1e-3 * yy and abs(float(rr) - float(rr_j)) < 1e-3 * yy

    # K1 with beta=0: p' = r, dot <r, Ar>
    pn_j, pap_j = k1(zg_j, zg_j, jnp.float32(0.0))
    pn, pap = fk.fused_cg_k1(zg, zg, torch.tensor(0.0), tst32.w27)
    assert np.abs(pn.numpy().reshape(-1) - zf).max() == 0.0
    np.testing.assert_array_equal(pn.numpy(), np.asarray(pn_j))
    zy = float(np.dot(zf, y_ref))
    assert abs(float(pap) - zy) < 1e-3 * abs(zy)
    assert abs(float(pap) - float(pap_j)) < 1e-3 * abs(zy)

    # general beta / alpha: the two passes agree with JAX elementwise
    r = torch.from_numpy(np.where(m, 0.0, rng.standard_normal(zf.size)).astype(np.float32))
    p = torch.from_numpy(np.where(m, 0.0, rng.standard_normal(zf.size)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal(zf.size).astype(np.float32))
    g = lambda v: v.reshape(nz, ny, nx)
    jg = lambda v: jnp.asarray(v.numpy()).reshape(nz, ny, nx)
    pn, pap = fk.fused_cg_k1(g(r), g(p), torch.tensor(0.37), tst32.w27)
    pn_j, pap_j = k1(jg(r), jg(p), jnp.float32(0.37))
    assert np.abs(pn.numpy() - np.asarray(pn_j)).max() <= 1e-6
    assert abs(float(pap) - float(pap_j)) <= 1e-4 * abs(float(pap_j))
    xn, rn, rr = fk.fused_cg_k2(g(x), g(r), g(p), torch.tensor(0.21), tst32.w27)
    xn_j, rn_j, rr_j = k2(jg(x), jg(r), jg(p), jnp.float32(0.21))
    assert np.abs(xn.numpy() - np.asarray(xn_j)).max() <= 1e-6
    assert np.abs(rn.numpy() - np.asarray(rn_j)).max() <= 1e-5
    assert abs(float(rr) - float(rr_j)) <= 1e-4 * float(rr_j)


def test_fused_cg_f32_matches_jax_interpret(setup):
    go, st, tst32, _ = setup
    b = go.residual(jnp.zeros(go.space.ndofs))
    z_j, s_j = j_make_fused_cg(st, maxiter=200, tol=1e-8, interpret=True)(b)
    z, s = make_fused_cg(tst32, maxiter=200, tol=1e-8)(
        vector_from_numpy(b, dtype=torch.float32))
    assert z.dtype == torch.float32 and bool(s.converged)
    z_j = np.asarray(z_j)
    rel = np.linalg.norm(z.numpy() - z_j) / np.linalg.norm(z_j)
    assert rel < 1e-4, rel
    assert abs(s.iterations - int(s_j.iterations)) <= 3


def test_fused_cg_fp64_matches_jax_cg(setup):
    go, st, _, tst64 = setup
    b = go.residual(jnp.zeros(go.space.ndofs))
    z_j, s_j = j_cg(st, b, tol=1e-10, maxiter=500)
    z, s = make_fused_cg(tst64, maxiter=500, tol=1e-10)(vector_from_numpy(b))
    assert z.dtype == torch.float64 and bool(s.converged)
    assert s.iterations == int(s_j.iterations)
    z_j = np.asarray(z_j)
    assert np.linalg.norm(z.numpy() - z_j) <= 1e-10 * np.linalg.norm(z_j)


def test_tol_zero_runs_maxiter(setup):
    go, st, _, tst64 = setup
    b = vector_from_numpy(go.residual(jnp.zeros(go.space.ndofs)))
    _, s = make_fused_cg(tst64, maxiter=7, tol=0.0)(b)
    assert s.iterations == 7 and not bool(s.converged)


def test_qualifies_gates(setup):
    _, st, tst32, _ = setup
    assert qualifies(tst32)
    partial = np.asarray(st.mask).copy()
    partial[np.nonzero(partial)[0][:5]] = False
    assert not qualifies(stencil_from_numpy(st.dims, st.k, st.weights, st.offsets,
                                            partial))
    assert not qualifies(stencil_from_numpy(st.dims, st.k, st.weights, st.offsets, None))
    with pytest.raises(ValueError):
        make_fused_cg(stencil_from_numpy(st.dims, st.k, st.weights, st.offsets, partial))
    V = tpt.FunctionSpace(tpt.StructuredMesh([0, 0], [1, 1], (7, 6)), tpt.QkFEM(2, 2))
    go2 = tpt.GridOperator(V, TFEM(TP()), constraints=tpt.constraints(True, V),
                           skip_boundary=True)
    st2 = compile_stencil(go2, dtype=torch.float64)
    assert st2 is not None and not qualifies(st2)


def test_kernel_wrappers_check_inputs():
    w = np.ones((3, 3, 3))
    g = torch.zeros(4, 5, 6)
    with pytest.raises(ValueError, match="shape"):
        fk.fused_cg_k1(g, torch.zeros(4, 5, 7), torch.tensor(0.0), w)
    with pytest.raises(TypeError, match="dtype"):
        fk.fused_cg_k2(g, g, g.double(), torch.tensor(0.0), w)
    with pytest.raises(ValueError, match="dims >= 3"):
        fk.fused_cg_k1(torch.zeros(2, 5, 6), torch.zeros(2, 5, 6), 0.0, w)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        m = g.to("meta")
        fk.fused_cg_k1(m, m, torch.tensor(0.0, device="meta"), w)
    before = (fk.launches_k1, fk.launches_k2)
    fk.fused_cg_k1(g, g, torch.tensor(0.0), w)
    assert (fk.launches_k1, fk.launches_k2) == before
