"""Mimetic finite differences of the port against the JAX package (fp64,
CPU).

Tolerances: DiffusionMFD residual and J.v 1e-12 relative; Dirichlet masks
exactly equal and the Dirichlet interpolant 1e-14 absolute; the convergence
solve's errors 1e-8 relative to the JAX package's. The reference's four
tests (tests/test_mimetic.py) run on the port with their own bounds and
sizes.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

import dune_pdelab_tpu as jpt
import dune_pdelab_tpu_torch as tpt
from dune_pdelab_tpu.fe.mimetic import DiffusionMFD as JDiffusionMFD
from dune_pdelab_tpu.fe.mimetic import MimeticFEM as JMimeticFEM
from dune_pdelab_tpu.ops import ConvectionDiffusionProblem as JProblem
from dune_pdelab_tpu.solvers import SEQ_CG_Jacobi as JSEQ_CG_Jacobi
from dune_pdelab_tpu.space.functions import l2_difference as j_l2_difference
from dune_pdelab_tpu_torch.fe.mimetic import DiffusionMFD, MimeticFEM
from dune_pdelab_tpu_torch.ops import ConvectionDiffusionProblem
from dune_pdelab_tpu_torch.solvers import SEQ_CG_Jacobi
from dune_pdelab_tpu_torch.space.functions import l2_difference
from dune_pdelab_tpu_torch.utils.common import set_default_device

pytestmark = pytest.mark.fast
torch.set_num_threads(1)
set_default_device("cpu")
F64 = torch.float64


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _m(x):
    return torch if isinstance(x, torch.Tensor) else jnp


class _Linear(ConvectionDiffusionProblem):
    def f(self, x):
        return 0.0 * x[..., 0]


class _Sin(ConvectionDiffusionProblem):
    """tests/test_mimetic.py SinProblem."""

    def exact(self, p):
        return np.sin(np.pi * p[:, 0]) * np.sin(np.pi * p[:, 1]) + p[:, 0]

    def f(self, x):
        m = _m(x)
        return 2 * np.pi**2 * m.sin(np.pi * x[..., 0]) * m.sin(np.pi * x[..., 1])

    def g(self, x):
        m = _m(x)
        return m.sin(np.pi * x[..., 0]) * m.sin(np.pi * x[..., 1]) + x[..., 0]


class _JSin(JProblem):
    exact = _Sin.exact
    f = _Sin.f
    g = _Sin.g


class _Field(ConvectionDiffusionProblem):
    def A(self, x):
        return 1.0 + 0.5 * x[..., 0] - 0.2 * x[..., -1] ** 2

    def f(self, x):
        return _m(x).sin(3 * x[..., 0]) + x[..., 1]


class _JField(JProblem):
    A = _Field.A
    f = _Field.f


def _pair(dim, cells):
    Vj = jpt.FunctionSpace(jpt.StructuredMesh([0] * dim, [1] * dim, cells), JMimeticFEM(dim))
    Vt = tpt.FunctionSpace(tpt.StructuredMesh([0] * dim, [1] * dim, cells), MimeticFEM(dim))
    return Vj, Vt


@pytest.mark.parametrize("dim,cells", [(2, (5, 4)), (3, (3, 2, 4))])
def test_diffusion_mfd_residual_and_jv_match_reference(dim, cells):
    """A field K and a source, Dirichlet on the whole boundary."""
    Vj, Vt = _pair(dim, cells)
    goj = jpt.GridOperator(Vj, JDiffusionMFD(_JField()), constraints=jpt.constraints(True, Vj))
    got = tpt.GridOperator(Vt, DiffusionMFD(_Field()), constraints=tpt.constraints(True, Vt))
    rng = np.random.default_rng(dim)
    x, z = rng.standard_normal(Vt.ndofs), rng.standard_normal(Vt.ndofs)
    assert _rel(got.residual(torch.from_numpy(x)), goj.residual(jnp.asarray(x))) < 1e-12
    assert _rel(got.jacobian_apply(torch.from_numpy(x), torch.from_numpy(z)),
                goj.jacobian_apply(jnp.asarray(x), jnp.asarray(z))) < 1e-12


@pytest.mark.parametrize("dim", [2, 3])
def test_mimetic_dirichlet_interpolation_matches_reference(dim):
    """Boundary masks (whole boundary and a callable bctype) and the
    face-centroid Dirichlet interpolant equal the reference's."""
    Vj, Vt = _pair(dim, (4,) * dim)

    def g(q):
        q = np.atleast_2d(np.asarray(q))
        return 1.0 + 2.0 * q[:, 0] - q[:, 1] ** 2

    def left(q):
        return np.asarray(q)[..., 0] < 0.5

    for bc in (True, left):
        cj, ct = jpt.constraints(bc, Vj), tpt.constraints(bc, Vt)
        assert np.array_equal(ct.mask_np, np.asarray(cj.mask))
        xj = jpt.interpolate_dirichlet(g, Vj, cj, Vj.zero())
        xt = tpt.interpolate_dirichlet(g, Vt, ct, Vt.zero(dtype=F64))
        assert np.abs(xt.numpy() - np.asarray(xj)).max() <= 1e-14


def test_diffusion_mfd_refuses_mapped_mesh():
    """Uniform cube meshes only, as in the reference."""
    n = 3
    idx = np.arange((n + 1) ** 2)
    coords = np.stack([(idx % (n + 1)) / n, (idx // (n + 1)) / n], axis=-1) ** 1.1
    V = tpt.FunctionSpace(tpt.StructuredMesh([0, 0], [1, 1], (n, n), coords=coords),
                          MimeticFEM(2))
    with pytest.raises(NotImplementedError):
        tpt.GridOperator(V, DiffusionMFD(_Linear())).residual(V.zero(dtype=F64))


# ------------------------------------------- tests/test_mimetic.py (4)
def test_element_partition_of_unity_and_linears():
    for dim in (2, 3):
        el = MimeticFEM(dim)
        pts = np.random.default_rng(0).uniform(0, 1, (10, dim))
        vals, grads = el.tabulate(pts)
        assert np.allclose(vals.sum(axis=1), 1.0)
        a = np.arange(1, dim + 1, dtype=float)
        u_f = 3.0 + el.nodes @ a
        assert np.allclose(vals @ u_f, 3.0 + pts @ a)
        assert np.allclose(np.einsum("pbd,b->pd", grads, u_f), np.broadcast_to(a, (10, dim)))
        ref = JMimeticFEM(dim).tabulate(pts)
        assert np.abs(vals - ref[0]).max() <= 1e-14 and np.abs(grads - ref[1]).max() <= 1e-14


def test_patch_test_exact():
    """Affine solutions are reproduced exactly (7 x 5 cells)."""
    mesh = tpt.StructuredMesh([0, 0], [1, 1], (7, 5))
    V = tpt.FunctionSpace(mesh, MimeticFEM(2))
    cgm = tpt.constraints(True, V)
    go = tpt.GridOperator(V, DiffusionMFD(_Linear()), constraints=cgm)

    def gfun(q):
        q = np.atleast_2d(np.asarray(q))
        return 1.0 + 2.0 * q[:, 0] - q[:, 1]

    x0 = tpt.interpolate_dirichlet(gfun, V, cgm, V.zero(dtype=F64))
    x = tpt.StationaryLinearProblemSolver(go, SEQ_CG_Jacobi(maxiter=5000),
                                          reduction=1e-13, verbose=0).apply(x0)
    assert float((x - V.interpolate(gfun, dtype=F64)).abs().max()) < 1e-10


def _mfd_error(pkg, n):
    mod, fem, lop, problem, backend = (
        (jpt, JMimeticFEM, JDiffusionMFD, _JSin(), JSEQ_CG_Jacobi) if pkg == "jax"
        else (tpt, MimeticFEM, DiffusionMFD, _Sin(), SEQ_CG_Jacobi))
    V = mod.FunctionSpace(mod.StructuredMesh([0, 0], [1, 1], (n, n)), fem(2))
    cgm = mod.constraints(True, V)
    go = mod.GridOperator(V, lop(problem), constraints=cgm)
    g = (lambda q: np.asarray(problem.g(jnp.asarray(np.atleast_2d(q))))) if pkg == "jax" \
        else (lambda q: problem.g(torch.as_tensor(np.atleast_2d(np.asarray(q)))))
    x0 = mod.interpolate_dirichlet(g, V, cgm, V.zero() if pkg == "jax" else V.zero(dtype=F64))
    x = mod.StationaryLinearProblemSolver(go, backend(maxiter=20000), reduction=1e-13,
                                          verbose=0).apply(x0)
    return float((j_l2_difference if pkg == "jax" else l2_difference)(V, x, problem.exact))


def test_mimetic_order2():
    """test_mimetic_convergence_order2 (8, 16): L2 order > 1.8, errors
    equal to the JAX package's."""
    errs = [_mfd_error("torch", n) for n in (8, 16)]
    assert np.log2(errs[0] / errs[1]) > 1.8, errs
    assert _rel(errs, [_mfd_error("jax", n) for n in (8, 16)]) < 1e-8


def test_mimetic_operator_spd_3d():
    """3^3 cells, no constraints: symmetric, singular only in the
    constant mode."""
    V = tpt.FunctionSpace(tpt.StructuredMesh([0, 0, 0], [1, 1, 1], (3, 3, 3)), MimeticFEM(3))
    A = tpt.GridOperator(V, DiffusionMFD(_Linear())).jacobian(V.zero(dtype=F64))
    A = A.to_dense().numpy()
    assert np.allclose(A, A.T, atol=1e-10)
    eig = np.linalg.eigvalsh(A)
    assert eig[0] > -1e-9 and eig[1] > 1e-9
