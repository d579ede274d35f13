"""Parity of the port's DG path with the JAX package (fp64).

  * face lists of the structured mesh, element_dofs of the DG space and the
    GridOperator's face groups (equal);
  * residual and J.v of ConvectionDiffusionDG, SIPG and NIPG, with b != 0
    and Dirichlet / Neumann / outflow faces, 2D Q2 and 3D Q1 (1e-12
    relative);
  * jacobian_diagonal and element_diagonal_blocks (2D Q2, 3D Q1) (1e-12
    relative); the assembled sparse jacobian against jacobian_apply columns;
  * the slab and index face transfers give the same residual;
  * the config3_convdiff_sipg golden (2D Q2 SIPG convection, SEQ_BCGS_Jacobi
    on the element-major block-stencil tier): the L2 error within 1e-8
    relative of tests/golden_parity.json, the BiCGStab steps within
    CONFIG3_STEPS_BAND of its 265 (the count is set by rounding; below).
"""
import json
from pathlib import Path

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import dune_pdelab_tpu as jpt
import dune_pdelab_tpu_torch as tpt
from dune_pdelab_tpu.fe import QkDGFEM as JQkDG
from dune_pdelab_tpu.ops import ConvectionDiffusionProblem as JProblem
from dune_pdelab_tpu.ops.convectiondiffusiondg import ConvectionDiffusionDG as JDG
from dune_pdelab_tpu.ops.convectiondiffusiondg import DGMethod
from dune_pdelab_tpu_torch.ops import ConvectionDiffusionDG as TDG
from dune_pdelab_tpu_torch.ops import ConvectionDiffusionProblem as TProblem
from dune_pdelab_tpu_torch.utils.common import set_default_device

pytestmark = pytest.mark.fast
torch.set_num_threads(1)
set_default_device("cpu")

F64 = torch.float64
REL = 1e-12
GOLDEN = json.loads((Path(__file__).parent / "golden_parity.json").read_text())
CASES = [(2, 2, (4, 3)), (3, 1, (3, 2, 4))]


def _bctype(x):
    """Outflow on x = 1, Neumann on y = 0, Dirichlet elsewhere (numpy,
    jax and torch arrays alike)."""
    right = x[..., 0] > 1 - 1e-9
    bottom = x[..., 1] < 1e-9
    return 1 + 1 * right - 1 * (bottom & ~right)


class JMixed(JProblem):
    def A(self, x):
        return 1.0 + 0.5 * x[..., 0]

    def b(self, x):
        return jnp.broadcast_to(jnp.asarray([1.0, -0.5, 0.25][:x.shape[-1]]), x.shape)

    def c(self, x):
        return 0.3

    def f(self, x):
        return jnp.sin(3.0 * x[..., 0]) + x[..., 1]

    def bctype(self, x):
        return _bctype(x)

    def g(self, x):
        return x[..., 0] * x[..., 1] + 0.5

    def j(self, x):
        return 0.3 + x[..., 0]

    def o(self, x):
        return 0.1 * x[..., 1]


class TMixed(TProblem):
    def A(self, x):
        return 1.0 + 0.5 * x[..., 0]

    def b(self, x):
        v = torch.tensor([1.0, -0.5, 0.25][:x.shape[-1]], dtype=x.dtype)
        return torch.broadcast_to(v, x.shape)

    def c(self, x):
        return 0.3

    def f(self, x):
        return torch.sin(3.0 * x[..., 0]) + x[..., 1]

    def bctype(self, x):
        return _bctype(x)

    def g(self, x):
        return x[..., 0] * x[..., 1] + 0.5

    def j(self, x):
        return 0.3 + x[..., 0]

    def o(self, x):
        return 0.1 * x[..., 1]


def _pair(dim, k, cells, method=DGMethod.SIPG, **kw):
    lo, hi = [0.0] * dim, [1.0] * dim
    jV = jpt.FunctionSpace(jpt.StructuredMesh(lo, hi, cells), JQkDG(k, dim))
    tV = tpt.FunctionSpace(tpt.StructuredMesh(lo, hi, cells), tpt.QkDGFEM(k, dim))
    return (jpt.GridOperator(jV, JDG(JMixed(), method=method)),
            tpt.GridOperator(tV, TDG(TMixed(), method=method), **kw))


def _close(got, want, rel=REL):
    got = got.to_dense().numpy() if got.is_sparse else got.numpy()
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * np.abs(want).max()


@pytest.mark.parametrize("dim,cells", [(2, (5, 4)), (3, (3, 4, 2))])
def test_face_lists_and_groups(dim, cells):
    lo, hi = [0.0] * dim, [1.0] * dim
    jm = jpt.StructuredMesh(lo, hi, cells)
    tm = tpt.StructuredMesh(lo, hi, cells)
    for key, val in jm.interior_faces().items():
        np.testing.assert_array_equal(tm.interior_faces()[key], val)
    for key, val in jm.boundary_faces().items():
        np.testing.assert_array_equal(tm.boundary_faces()[key], val)
    np.testing.assert_allclose(tm.element_centers(), jm.element_centers(), rtol=0, atol=0)
    jV = jpt.FunctionSpace(jm, JQkDG(1, dim))
    tV = tpt.FunctionSpace(tm, tpt.QkDGFEM(1, dim))
    assert tV.ndofs == jV.ndofs
    np.testing.assert_array_equal(tV.element_dofs, jV.element_dofs)
    jgo, tgo = (jpt.GridOperator(jV, JDG(JMixed())),
                tpt.GridOperator(tV, TDG(TMixed())))
    assert len(tgo.bnd_groups) == len(jgo.bnd_groups) == 2 * dim
    for jg, tg in zip(jgo.bnd_groups, tgo.bnd_groups):
        assert (jg.axis, jg.side) == (tg.axis, tg.side)
        np.testing.assert_array_equal(tgo.group_elements(tg), jg.elements)
        np.testing.assert_array_equal(tg.normal, jg.normal)
    assert len(tgo.skel_groups) == len(jgo.skel_groups) == dim
    for jg, tg in zip(jgo.skel_groups, tgo.skel_groups):
        np.testing.assert_array_equal(tgo.group_elements(tg), jg.elements)
        np.testing.assert_array_equal(tgo.group_elements(tg, outside=True), jg.outside)


@pytest.mark.parametrize("method", [DGMethod.SIPG, DGMethod.NIPG])
@pytest.mark.parametrize("dim,k,cells", CASES)
def test_dg_residual_and_jv_match_jax(dim, k, cells, method):
    jgo, tgo = _pair(dim, k, cells, method)
    rng = np.random.default_rng(11)
    x, z = rng.standard_normal((2, tgo.space.ndofs))
    _close(tgo.residual(torch.from_numpy(x)), jgo.residual(jnp.asarray(x)))
    _close(tgo.jacobian_apply(torch.from_numpy(x), torch.from_numpy(z)),
           jgo.jacobian_apply(jnp.asarray(x), jnp.asarray(z)))


@pytest.mark.parametrize("dim,k,cells", CASES)
def test_dg_diagonal_and_blocks_match_jax(dim, k, cells):
    jgo, tgo = _pair(dim, k, cells)
    x = np.random.default_rng(12).standard_normal(tgo.space.ndofs)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    _close(tgo.jacobian_diagonal(xt), jgo.jacobian_diagonal(xj))
    _close(tgo.element_diagonal_blocks(xt), jgo.element_diagonal_blocks(xj))


def test_dg_sparse_jacobian_matches_jv_columns():
    """The assembled sparse Jacobian (volume, boundary and two-sided
    skeleton blocks) against its columns J e_j from jacobian_apply."""
    _, tgo = _pair(2, 1, (3, 2))
    n = tgo.space.ndofs
    x = torch.from_numpy(np.random.default_rng(14).standard_normal(n))
    cols = torch.stack([tgo.jacobian_apply(x, e) for e in torch.eye(n, dtype=F64)], 1)
    _close(tgo.jacobian(x), cols.numpy())


def test_slab_and_index_face_transfers_agree():
    _, slab = _pair(3, 1, (3, 2, 4))
    _, index = _pair(3, 1, (3, 2, 4), face_transfer="index")
    assert type(slab.skel_groups[0].tr_in).__name__ == "SlabFaceTransfer"
    assert type(index.skel_groups[0].tr_in).__name__ == "IndexFaceTransfer"
    x = torch.from_numpy(np.random.default_rng(13).standard_normal(slab.space.ndofs))
    _close(index.residual(x), slab.residual(x).numpy(), rel=1e-14)


# BiCGStab on config3 stalls near its 1e-10 target for ~30 steps (the
# relative defect moves between 1e-10 and 4e-9 from step ~245 on), so the
# step at which it first falls below the target, and the algebraic error
# left in the iterate, are set by rounding. With the port's operator and
# right-hand side, five orders of the dot-product sums (torch.dot, sum,
# np.dot, a sequential sum, exact fsum) stop after 261-274 steps with L2
# errors within 1.2e-5 relative of the golden (recorded after the JAX
# package's 265); solved to 1e-13, port and JAX package agree to 6e-10.
CONFIG3_STEPS_BAND = 20
CONFIG3_L2_BAND = 2e-5


def _config3(reduction):
    """The port's models/configs.py config3_convdiff_sipg at `reduction`."""
    from dune_pdelab_tpu_torch.models import ALL_CONFIGS

    info = {}
    got = ALL_CONFIGS["config3"](reduction=reduction, info=info)
    return (info["space"], info["ls"].report(info["go"]), info["solver"].result,
            got["l2_error"])


def test_config3_golden():
    """config3_convdiff_sipg (models/configs.py:85-110): 32^2 Q2 DG SIPG,
    BiCGStab + Jacobi on the block-stencil tier. At the golden's 1e-10:
    steps and L2 error within the bands above; solved to 1e-13: the L2
    error of the JAX package's config3 at 1e-13 to 1e-8 relative."""
    from dune_pdelab_tpu.models.configs import config3_convdiff_sipg

    want = GOLDEN["config3_convdiff_sipg"]
    V, report, res, l2 = _config3(1e-10)
    assert V.ndofs == want["ndofs"] and res.converged
    assert "compiled block stencil BlockStencilOperator [element-major; blockstencil" \
        in report
    assert abs(res.linear_solver_iterations - want["iterations"]) <= CONFIG3_STEPS_BAND
    assert l2 == pytest.approx(want["l2_error"], rel=CONFIG3_L2_BAND)
    _, _, res, l2 = _config3(1e-13)
    assert res.converged
    assert l2 == pytest.approx(config3_convdiff_sipg(reduction=1e-13)["l2_error"], rel=1e-8)
