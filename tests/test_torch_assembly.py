"""Parity of the PyTorch port's volume assembly with the JAX package (fp64).

`residual`, `jacobian_apply` (torch.func.jvp against jax.jvp) and
`residual_slabbed` of dune_pdelab_tpu_torch must equal dune_pdelab_tpu's on
the same inputs, with a spatially varying source and coefficients, in 2D and
3D, Q1 and Q2: relative tolerance 1e-12 (only the summation order of the
contractions differs).
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

import dune_pdelab_tpu as jpt
import dune_pdelab_tpu_torch as tpt
from dune_pdelab_tpu.assembly.slabbed import residual_slabbed as j_slabbed
from dune_pdelab_tpu.ops import ConvectionDiffusionFEM as JFEM
from dune_pdelab_tpu.ops import ConvectionDiffusionProblem as JProblem
from dune_pdelab_tpu_torch.assembly.geometry import VolumeGeometry
from dune_pdelab_tpu_torch.assembly.slabbed import residual_slabbed as t_slabbed
from dune_pdelab_tpu_torch.fe.quadrature import cube_rule
from dune_pdelab_tpu_torch.ops import ConvectionDiffusionFEM as TFEM
from dune_pdelab_tpu_torch.ops import ConvectionDiffusionProblem as TProblem
from dune_pdelab_tpu_torch.utils.common import set_default_device

pytestmark = pytest.mark.fast
torch.set_num_threads(1)
set_default_device("cpu")

CASES = [(2, 1, (6, 5)), (2, 2, (4, 3)), (3, 1, (4, 3, 5)), (3, 2, (2, 3, 2))]
REL = 1e-12


class JVar(JProblem):
    def A(self, x):
        return 1.0 + 0.5 * x[..., 0]

    def b(self, x):
        return jnp.broadcast_to(jnp.asarray([0.3, -0.2, 0.1][:x.shape[-1]]), x.shape)

    def c(self, x):
        return 0.25

    def f(self, x):
        return jnp.sin(3.0 * x[..., 0]) * x[..., 1] + 1.0


class TVar(TProblem):
    def A(self, x):
        return 1.0 + 0.5 * x[..., 0]

    def b(self, x):
        v = torch.tensor([0.3, -0.2, 0.1][:x.shape[-1]], dtype=x.dtype)
        return torch.broadcast_to(v, x.shape)

    def c(self, x):
        return 0.25

    def f(self, x):
        return torch.sin(3.0 * x[..., 0]) * x[..., 1] + 1.0


def _pair(dim, k, cells, bc=True):
    lo, hi = [0.0] * dim, [1.0] * dim
    jV = jpt.FunctionSpace(jpt.StructuredMesh(lo, hi, cells), jpt.QkFEM(k, dim))
    tV = tpt.FunctionSpace(tpt.StructuredMesh(lo, hi, cells), tpt.QkFEM(k, dim))
    jc = jpt.constraints(True, jV) if bc else None
    tc = tpt.constraints(True, tV) if bc else None
    jgo = jpt.GridOperator(jV, JFEM(JVar()), constraints=jc, skip_boundary=True)
    tgo = tpt.GridOperator(tV, TFEM(TVar()), constraints=tc, skip_boundary=True)
    return jgo, tgo


def _close(got, want):
    want = np.asarray(want)
    err = np.abs(np.asarray(got) - want).max()
    assert err <= REL * max(np.abs(want).max(), 1e-300), err


@pytest.mark.parametrize("dim,k,cells", CASES)
def test_residual_matches_jax(dim, k, cells):
    jgo, tgo = _pair(dim, k, cells)
    x = np.random.default_rng(dim * 10 + k).standard_normal(tgo.space.ndofs)
    _close(tgo.residual(torch.from_numpy(x)).numpy(), jgo.residual(jnp.asarray(x)))
    _close(tgo.residual_unconstrained(torch.from_numpy(x)).numpy(),
           jgo.residual_unconstrained(jnp.asarray(x)))


@pytest.mark.parametrize("dim,k,cells", CASES)
def test_jacobian_apply_matches_jax(dim, k, cells):
    jgo, tgo = _pair(dim, k, cells)
    rng = np.random.default_rng(dim * 10 + k + 1)
    x, z = rng.standard_normal((2, tgo.space.ndofs))
    got = tgo.jacobian_apply(torch.from_numpy(x), torch.from_numpy(z)).numpy()
    _close(got, jgo.jacobian_apply(jnp.asarray(x), jnp.asarray(z)))
    # linear operator: J z (constrained columns dropped) equals the residual
    # difference up to roundoff
    m = tgo.cg.mask_np
    r0 = tgo.residual(torch.zeros(tgo.space.ndofs, dtype=torch.float64))
    rz = tgo.residual(torch.from_numpy(np.where(m, 0.0, z)))
    np.testing.assert_allclose(got[~m], (rz - r0).numpy()[~m], rtol=0,
                               atol=1e-12 * np.abs(got).max())
    np.testing.assert_array_equal(got[m], z[m])


@pytest.mark.parametrize("dim,k,cells", [(2, 1, (6, 7)), (2, 2, (4, 5)),
                                         (3, 1, (3, 4, 7)), (3, 2, (2, 2, 5))])
@pytest.mark.parametrize("nslabs", [2, 3])
def test_residual_slabbed_matches_jax(dim, k, cells, nslabs):
    jgo, tgo = _pair(dim, k, cells)
    x = np.random.default_rng(nslabs).standard_normal(tgo.space.ndofs)
    got = t_slabbed(tgo.space, TFEM(TVar()), tgo.cg, torch.from_numpy(x),
                    nslabs=nslabs).numpy()
    _close(got, j_slabbed(jgo.space, JFEM(JVar()), jgo.cg, jnp.asarray(x),
                          nslabs=nslabs))
    _close(got, tgo.residual(torch.from_numpy(x)).numpy())


def test_fp32_residual_close_to_fp64():
    jgo, tgo = _pair(3, 1, (5, 4, 3))
    x = np.random.default_rng(9).standard_normal(tgo.space.ndofs)
    r32 = tgo.residual(torch.from_numpy(x).float())
    assert r32.dtype == torch.float32
    want = np.asarray(jgo.residual(jnp.asarray(x)))
    assert np.abs(r32.numpy() - want).max() <= 1e-5 * np.abs(want).max()


def test_origins_match_reference():
    jgo, tgo = _pair(3, 1, (3, 4, 2))
    want = jgo.vol_geo.origins
    got = tgo.vol_geo.origins_tensor(torch.float64, "cpu").numpy()
    np.testing.assert_array_equal(got, want)


def _mixed_bc(base):
    """base problem with outflow on x = 1, Neumann on y = 0 (elsewhere
    Dirichlet), a Neumann flux j and an outflow term o."""

    class Mixed(base):
        def bctype(self, x):
            right = x[..., 0] > 1 - 1e-9
            bottom = x[..., 1] < 1e-9
            return 1 + 1 * right - 1 * (bottom & ~right)

        def j(self, x):
            return 0.3 + x[..., 0]

        def o(self, x):
            return 0.1 * x[..., 1]

    return Mixed()


@pytest.mark.parametrize("dim,k,cells", [(2, 1, (4, 4)), (3, 2, (2, 3, 2))])
def test_boundary_kernels_need_skip_boundary(dim, k, cells):
    """Boundary kernels run on the boundary face groups unless
    skip_boundary=True: residual and J.v of a Neumann/outflow/Dirichlet
    problem against the JAX package (1e-12 relative)."""
    lo, hi = [0.0] * dim, [1.0] * dim
    jV = jpt.FunctionSpace(jpt.StructuredMesh(lo, hi, cells), jpt.QkFEM(k, dim))
    tV = tpt.FunctionSpace(tpt.StructuredMesh(lo, hi, cells), tpt.QkFEM(k, dim))
    jp, tp = _mixed_bc(JVar), _mixed_bc(TVar)
    jgo = jpt.GridOperator(jV, JFEM(jp), constraints=jpt.constraints(jp.dirichlet_bctype(), jV))
    tgo = tpt.GridOperator(tV, TFEM(tp), constraints=tpt.constraints(tp.dirichlet_bctype(), tV))
    assert tgo.has["alpha_boundary"] and len(tgo.bnd_groups) == 2 * dim
    rng = np.random.default_rng(5)
    x, z = rng.standard_normal((2, tV.ndofs))
    for got, want in ((tgo.residual(torch.from_numpy(x)), jgo.residual(jnp.asarray(x))),
                      (tgo.jacobian_apply(torch.from_numpy(x), torch.from_numpy(z)),
                       jgo.jacobian_apply(jnp.asarray(x), jnp.asarray(z)))):
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= REL * np.abs(want).max()
    go = tpt.GridOperator(tV, TFEM(tp), skip_boundary=True)
    assert go.has["alpha_volume"] and not go.has["alpha_boundary"] and not go.bnd_groups


def test_volume_geometry_is_lazy():
    mesh = tpt.StructuredMesh([0, 0, 0], [1, 1, 1], (64, 64, 64))
    geo = VolumeGeometry(mesh, *cube_rule(3, 2))
    assert all(np.asarray(v).size < 100 for v in vars(geo).values()
               if isinstance(v, np.ndarray))
    assert geo.factor.shape == (1, 8) and geo.jac_inv_T.shape == (1, 1, 3, 3)
