"""Parity of the port's assembled lattice-ELL path with the JAX package.

  * EllMatrix plain apply against the JAX EllMatrix on random values and a
    random mask, 2D/3D, k = 1/2 (1e-12 relative);
  * ell27's plain version against the JAX Pallas kernels it replaces
    (try_plane_ell K4a and try_pallas_tiled_ell K4b in interpret mode, fp32,
    1e-5 relative) on assembled values;
  * assemble_ell / assemble_ell_device / assemble_ell_direct against the
    JAX assemble_ell (1e-12), the decline cases of the direct assembly, its
    dtypes and check, ell_to_csr and pattern_stats;
  * BiCGStab on the ELL and on the matrix-free apply (tests/test_ell.py
    :95-109) and the backend's assembled tier: the same iterations as the
    JAX package and the same report() path.
Problems copied from tests/test_ell.py.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

import dune_pdelab_tpu as jpt
import dune_pdelab_tpu_torch as tpt
from dune_pdelab_tpu.assembly import ell as jell
from dune_pdelab_tpu.assembly.ell_pallas import try_plane_ell as j_try_plane
from dune_pdelab_tpu.linalg.krylov import bicgstab as j_bicgstab
from dune_pdelab_tpu.ops import ConvectionDiffusionFEM as JFEM
from dune_pdelab_tpu.ops import ConvectionDiffusionProblem as JProblem
from dune_pdelab_tpu.solvers import LinearSolverBackend as JBackend
from dune_pdelab_tpu_torch.assembly import ell as tell
from dune_pdelab_tpu_torch.assembly.ell_pallas import try_plane_ell
from dune_pdelab_tpu_torch.interop import ell_from_numpy, vector_from_numpy
from dune_pdelab_tpu_torch.kernels import ell27 as ek
from dune_pdelab_tpu_torch.linalg import bicgstab
from dune_pdelab_tpu_torch.ops import ConvectionDiffusionFEM as TFEM
from dune_pdelab_tpu_torch.ops import ConvectionDiffusionProblem as TProblem
from dune_pdelab_tpu_torch.ops.base import LocalOperator
from dune_pdelab_tpu_torch.solvers import LinearSolverBackend
from dune_pdelab_tpu_torch.utils.common import set_default_device

pytestmark = pytest.mark.fast
torch.set_num_threads(1)
set_default_device("cpu")
F64 = torch.float64


class JVarCoeff(JProblem):
    """x-dependent diffusion + convection: not translation invariant."""

    def A(self, x):
        a = 1.0 + 0.5 * jnp.sin(3 * x[..., 0]) * x[..., 1]
        return a[..., None, None] * jnp.eye(x.shape[-1], dtype=x.dtype)

    def b(self, x):
        v = jnp.stack([0.5 + x[..., 1], -0.3 * x[..., 0]], axis=-1)
        if x.shape[-1] == 3:
            v = jnp.concatenate([v, 0.1 * x[..., 2:3]], axis=-1)
        return v

    def c(self, x):
        return 0.7 + x[..., 0]

    def f(self, x):
        return jnp.ones(x.shape[:-1], x.dtype)


class TVarCoeff(TProblem):
    def A(self, x):
        a = 1.0 + 0.5 * torch.sin(3 * x[..., 0]) * x[..., 1]
        return a[..., None, None] * torch.eye(x.shape[-1], dtype=x.dtype)

    def b(self, x):
        v = torch.stack([0.5 + x[..., 1], -0.3 * x[..., 0]], dim=-1)
        if x.shape[-1] == 3:
            v = torch.cat([v, 0.1 * x[..., 2:3]], dim=-1)
        return v

    def c(self, x):
        return 0.7 + x[..., 0]

    def f(self, x):
        return torch.ones(x.shape[:-1], dtype=x.dtype)


def _pair(cells, k):
    out = []
    for pkg, P, FEM in ((jpt, JVarCoeff, JFEM), (tpt, TVarCoeff, TFEM)):
        dim = len(cells)
        V = pkg.FunctionSpace(pkg.StructuredMesh([0] * dim, [1] * dim, cells),
                              pkg.QkFEM(k, dim))
        out.append(pkg.GridOperator(V, FEM(P()), constraints=pkg.constraints(True, V),
                                    skip_boundary=True))
    return out


def _port(jmat, dtype=F64):
    mask = None if jmat.mask is None else np.asarray(jmat.mask)
    return ell_from_numpy(jmat.dims, jmat.k, jmat.offsets, np.asarray(jmat.values),
                          mask, dtype=dtype)


CASES = [((9, 7), 1), ((6, 5), 2), ((7, 6, 5), 1), ((4, 4, 4), 2)]


@pytest.mark.parametrize("cells,k", CASES)
def test_ell_apply_matches_jax_random_values(cells, k):
    """Any values (no zero couplings at the domain edge), a random mask."""
    dim = len(cells)
    dims = tuple(k * c + 1 for c in cells)
    offsets = tell.lattice_offsets(k, dim)
    rng = np.random.default_rng(5)
    values = rng.standard_normal((len(offsets),) + tuple(reversed(dims)))
    n = int(np.prod(dims))
    for mask in (rng.random(n) < 0.3, None):
        jm = jell.EllMatrix(dims, k, offsets, jnp.asarray(values),
                            None if mask is None else jnp.asarray(mask))
        tm = ell_from_numpy(dims, k, offsets, values, mask)
        assert tm.uses_ell27 == (k == 1 and dim == 3)
        z = rng.standard_normal(n)
        want = np.asarray(jm(jnp.asarray(z)))
        for got in (tm(vector_from_numpy(z)), tm._apply_impl(vector_from_numpy(z))):
            assert np.abs(got.numpy() - want).max() <= 1e-12 * np.abs(want).max()


@pytest.mark.parametrize("cells,lowering", [((7, 5, 6), "plane"), ((7, 5, 5), "tiled")])
def test_ell27_reference_matches_pallas_interpret(cells, lowering):
    """ell27's plain version against the JAX Pallas kernels it replaces
    (K4a plane-streamed, K4b row-tiled), interpret mode, fp32."""
    jgo, _ = _pair(cells, 1)
    jm = jell.assemble_ell(jgo)
    pal = (j_try_plane(jm, interpret=True) if lowering == "plane"
           else jell.try_pallas_tiled_ell(jm, interpret=True))
    assert pal is not None
    z = np.random.default_rng(4).standard_normal(jgo.space.ndofs).astype(np.float32)
    want = np.asarray(pal(jnp.asarray(z)))
    tm = _port(jm, torch.float32)
    got = ek.ell27_reference(tm.values, torch.from_numpy(z), tm.mask, tm.dims)
    assert got.dtype == torch.float32
    assert np.linalg.norm(got.numpy() - want) <= 1e-5 * np.linalg.norm(want)
    for apply in (try_plane_ell(tm), tell.try_pallas_tiled_ell(tm), tm):
        assert torch.equal(apply(torch.from_numpy(z)), got)


@pytest.mark.parametrize("cells,k", CASES)
def test_assembly_matches_jax(cells, k):
    jgo, tgo = _pair(cells, k)
    jm = jell.assemble_ell(jgo)
    want = np.asarray(jm.values)
    x = tgo.space.zero(F64)
    for fn in (tell.assemble_ell, tell.assemble_ell_device, tell.assemble_ell_direct):
        got = fn(tgo, x)
        assert got.values.dtype == F64 and np.array_equal(got.offsets, jm.offsets)
        assert np.abs(got.values.numpy() - want).max() <= 1e-12 * np.abs(want).max()
    if len(cells) == 3 and k == 1:
        assert try_plane_ell(got) is not None
    else:
        assert try_plane_ell(got) is None and tell.try_pallas_tiled_ell(got) is None


def test_direct_declines_like_jax():
    """A lop without alpha_volume declines in both; face terms decline in
    JAX (the port's GridOperator refuses such a lop); a lop flagged
    nonlinear is assembled at its linearization point (which waited for
    slice 8 before it was ported; its JAX parity:
    tests/test_torch_newton.py)."""
    class JSource:
        is_linear = True
        quadrature_factor, quadrature_add = 2, 0

        def quad_order(self, degree):
            return 2 * degree

        def set_time(self, t):
            return self

        def lambda_volume(self, ctx):
            return jnp.zeros((ctx.x.shape[0], 8), ctx.x.dtype)

    class TSource(LocalOperator):
        is_linear = True

        def lambda_volume(self, ctx):
            return torch.zeros((ctx.x.shape[0], 8), dtype=ctx.x.dtype)

    cells = (3, 3, 3)
    jV = jpt.FunctionSpace(jpt.StructuredMesh([0] * 3, [1] * 3, cells), jpt.QkFEM(1, 3))
    tV = tpt.FunctionSpace(tpt.StructuredMesh([0] * 3, [1] * 3, cells), tpt.QkFEM(1, 3))
    jgo = jpt.GridOperator(jV, JSource(), constraints=jpt.constraints(True, jV))
    tgo = tpt.GridOperator(tV, TSource(), constraints=tpt.constraints(True, tV))
    assert jell.assemble_ell_direct(jgo) is None
    assert tell.assemble_ell_direct(tgo, tV.zero(F64)) is None
    jface = jpt.GridOperator(jV, JFEM(JVarCoeff()), constraints=jpt.constraints(True, jV))
    assert jell.assemble_ell_direct(jface) is None
    tface = tpt.GridOperator(tV, TFEM(TVarCoeff()), constraints=tpt.constraints(True, tV))
    assert tface.has["alpha_boundary"]
    assert tell.assemble_ell_direct(tface, tV.zero(F64)) is None

    class TNonlinear(TFEM):
        is_linear = False

    tgo = tpt.GridOperator(tV, TNonlinear(TVarCoeff()),
                           constraints=tpt.constraints(True, tV), skip_boundary=True)
    x_lin = torch.from_numpy(np.random.default_rng(8).standard_normal(tV.ndofs))
    direct = tell.assemble_ell_direct(tgo, x_lin, check=True)
    probed = tell.assemble_ell(tgo, x_lin)
    assert float((direct.values - probed.values).abs().max()) <= (
        1e-12 * float(probed.values.abs().max()))


def test_direct_cache_and_check(monkeypatch):
    """No cache: a repeated call rebuilds the same values; the dtype follows
    x_lin; check=True passes in both dtypes and catches a wrong apply."""
    _, tgo = _pair((5, 4, 6), 1)
    x = tgo.space.zero(F64)
    a = tell.assemble_ell_direct(tgo, x, check=True)
    b = tell.assemble_ell_direct(tgo, x.to(torch.float32), check=True)
    c = tell.assemble_ell_direct(tgo, x, time=0.0, check=True)
    assert not hasattr(tgo, "_ell_direct_cache") and a.values is not c.values
    assert torch.equal(a.values, c.values) and b.values.dtype == torch.float32
    assert torch.allclose(b.values.double(), a.values, rtol=1e-6,
                          atol=1e-6 * float(a.values.abs().max()))
    monkeypatch.setattr(tell.EllMatrix, "__call__", lambda self, z: 1.01 * self._apply_impl(z))
    with pytest.raises(AssertionError, match="direct ELL parity failure"):
        tell.assemble_ell_direct(tgo, x, check=True)


@pytest.mark.parametrize("cells,k", CASES)
def test_jacobian_diagonal_sums_element_diagonals(cells, k):
    """go.jacobian_diagonal (per-basis jvp probes, DOF-map slice-adds)
    equals the element Jacobians' diagonals summed by index, and the ELL's
    zero-offset tap; a second call repeats it bit for bit."""
    _, tgo = _pair(cells, k)
    x = vector_from_numpy(np.random.default_rng(3).standard_normal(tgo.space.ndofs))
    J = tgo.element_jacobians(x)
    want = torch.zeros(tgo.space.ndofs, dtype=F64).index_add(
        0, torch.as_tensor(tgo.space.element_dofs).reshape(-1),
        torch.diagonal(J, dim1=1, dim2=2).reshape(-1))
    mask = tgo.cg.mask_on(x.device)
    want = torch.where(mask, 1.0, want)
    got = tgo.jacobian_diagonal(x)
    assert torch.allclose(got, want, rtol=1e-13, atol=1e-15)
    assert torch.equal(got, tgo.jacobian_diagonal(x))
    ell = tell.assemble_ell(tgo, x)
    centre = ell.values[len(ell.offsets) // 2].reshape(-1)
    assert torch.allclose(torch.where(mask, 1.0, centre), got, rtol=1e-13, atol=1e-15)


@pytest.mark.parametrize("cells,k", [((8, 8), 1), ((4, 3, 5), 1), ((3, 2), 2)])
def test_csr_and_pattern_stats_match_jax(cells, k):
    jgo, tgo = _pair(cells, k)
    jm = jell.assemble_ell(jgo)
    tm = tell.assemble_ell(tgo, tgo.space.zero(F64))
    assert tm.pattern_stats() == jm.pattern_stats()
    A_j, A_t = jell.ell_to_csr(jm), tell.ell_to_csr(tm)
    assert np.array_equal(A_t.indptr, A_j.indptr) and np.array_equal(A_t.indices, A_j.indices)
    assert np.abs(A_t.data - A_j.data).max() <= 1e-12 * np.abs(A_j.data).max()
    z = np.random.default_rng(7).standard_normal(tgo.space.ndofs)
    want = tm(vector_from_numpy(z)).numpy()
    assert np.abs(A_t @ z - want).max() <= 1e-12 * np.abs(want).max()


def test_bicgstab_ell_vs_matrix_free_iteration_parity():
    """tests/test_ell.py:95-109 on both packages: BiCGStab + Jacobi on the
    ELL and on jacobian_apply take the same iterations as JAX's."""
    jgo, tgo = _pair((12, 10), 1)
    x0 = jnp.zeros(jgo.space.ndofs)
    b_j = jgo.residual(x0)
    d_j = jgo.jacobian_diagonal(x0)
    _, s_j = j_bicgstab(jell.assemble_ell(jgo), b_j, M=lambda r: r / d_j, tol=1e-12)
    x = tgo.space.zero(F64)
    b = tgo.residual(x)
    d = tgo.jacobian_diagonal(x)
    ell = tell.assemble_ell(tgo, x)
    centre = ell.values[len(ell.offsets) // 2].reshape(-1)
    assert torch.allclose(torch.where(ell.mask, 1.0, centre), d, rtol=1e-13, atol=0)
    z1, s1 = bicgstab(lambda p: tgo.jacobian_apply(x, p), b, M=lambda r: r / d, tol=1e-12)
    z2, s2 = bicgstab(ell, b, M=lambda r: r / d, tol=1e-12)
    assert s1.iterations == s2.iterations == int(s_j.iterations)
    assert float(torch.linalg.norm(z1 - z2)) < 1e-8


@pytest.mark.parametrize("cells,solver", [((6, 5, 7), "bicgstab"), ((10, 10), "gmres")])
def test_backend_assembled_tier_matches_jax(cells, solver):
    jgo, tgo = _pair(cells, 1)
    jbe = JBackend(solver=solver, precond="jacobi", matrix_free=False)
    x0 = jnp.zeros(jgo.space.ndofs)
    z_j, s_j = jbe.solve(jgo, x0, jgo.residual(x0), 1e-11)
    be = LinearSolverBackend(solver=solver, precond="jacobi", matrix_free=False)
    x = tgo.space.zero(F64)
    b = tgo.residual(x)
    z, s = be.solve(tgo, x, b, 1e-11)
    rep, jrep = be.report(tgo).splitlines(), jbe.report(jgo).splitlines()
    assert rep[0].startswith(jrep[0]) and rep[1:] == jrep[1:]
    how = "ell27 plain torch (CPU tensor)" if len(cells) == 3 else "no kernel"
    assert how in rep[0]
    assert bool(s.converged) and s.iterations == int(s_j.iterations)
    assert np.linalg.norm(z.numpy() - np.asarray(z_j)) <= 1e-9 * np.linalg.norm(z_j)
    coo = LinearSolverBackend(solver=solver, precond="jacobi", matrix_free=False,
                              use_ell=False)
    z2, s2 = coo.solve(tgo, x, b, 1e-11)
    assert "assembled sparse COO" in coo.report(tgo)
    assert "declined lattice-ELL: use_ell=False" in coo.report(tgo)
    assert s2.iterations == s.iterations
    assert float(torch.linalg.norm(z2 - z)) <= 1e-9 * float(torch.linalg.norm(z))


def test_ell27_wrapper_checks_inputs():
    dims = (4, 5, 3)
    vals = torch.zeros((27, 3, 5, 4))
    z = torch.zeros(60)
    with pytest.raises(ValueError, match="shape"):
        ek.ell27(vals, torch.zeros(59), None, dims)
    with pytest.raises(ValueError, match="shape"):
        ek.ell27(vals[:26], z, None, dims)
    with pytest.raises(TypeError, match="dtype"):
        ek.ell27(vals.double(), z, None, dims)
    with pytest.raises(TypeError, match="dtype"):
        ek.ell27(vals, z, torch.zeros(60, dtype=torch.uint8), dims)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        ek.ell27(vals.to("meta"), z.to("meta"), None, dims)
    before = ek.launches
    ek.ell27(vals, z, None, dims)               # CPU tensor: plain version
    assert ek.launches == before
