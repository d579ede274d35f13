"""Parity of the PyTorch port's foundations with the JAX package.

Quadrature, QkFEM tabulation, element DOF maps, DOF-grid dims, the sliced
and index DOF transfers, boundary masks, Dirichlet masks and interpolation
of dune_pdelab_tpu_torch must equal dune_pdelab_tpu's on the same inputs
(2D and 3D, Q1 and Q2). The port's numpy setup code is a translation of the
reference's, so host-side arrays must agree exactly; transfers agree to
fp64 roundoff.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

import dune_pdelab_tpu as jpt
import dune_pdelab_tpu_torch as tpt
from dune_pdelab_tpu.assembly import dofmaps as jdm
from dune_pdelab_tpu.fe import quadrature as jq
from dune_pdelab_tpu_torch.assembly import dofmaps as tdm
from dune_pdelab_tpu_torch.fe import quadrature as tq
from dune_pdelab_tpu_torch.utils.common import set_default_device

pytestmark = pytest.mark.fast
torch.set_num_threads(1)
set_default_device("cpu")

CASES = [(2, 1, (5, 4)), (2, 2, (3, 4)), (3, 1, (3, 2, 4)), (3, 2, (2, 3, 2))]


def _spaces(dim, k, cells):
    lo, hi = [0.0] * dim, [1.0 + 0.5 * d for d in range(dim)]
    jV = jpt.FunctionSpace(jpt.StructuredMesh(lo, hi, cells), jpt.QkFEM(k, dim))
    tV = tpt.FunctionSpace(tpt.StructuredMesh(lo, hi, cells), tpt.QkFEM(k, dim))
    return jV, tV


@pytest.mark.parametrize("order", range(7))
def test_gauss_legendre(order):
    for a, b in zip(jq.gauss_legendre(order), tq.gauss_legendre(order)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dim,order", [(1, 3), (2, 2), (2, 4), (3, 2), (3, 5)])
def test_cube_rule(dim, order):
    for a, b in zip(jq.quadrature_rule("cube", dim, order),
                    tq.quadrature_rule("cube", dim, order)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dim,k", [(2, 1), (2, 2), (3, 1), (3, 2)])
def test_qk_tabulation(dim, k):
    pts = np.random.default_rng(k + 10 * dim).random((9, dim))
    jf, tf = jpt.QkFEM(k, dim), tpt.QkFEM(k, dim)
    np.testing.assert_array_equal(jf._mi, tf._mi)
    np.testing.assert_array_equal(jf.nodes, tf.nodes)
    for a, b in zip(jf.tabulate(pts), tf.tabulate(pts)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dim,k,cells", CASES)
def test_dof_layout(dim, k, cells):
    jV, tV = _spaces(dim, k, cells)
    assert jV.ndofs == tV.ndofs
    assert jV._dof_grid_dims == tV._dof_grid_dims
    assert tV._element_dofs is None              # lazy until first use
    np.testing.assert_array_equal(jV.element_dofs, tV.element_dofs)
    np.testing.assert_array_equal(jV.boundary_dof_mask(), tV.boundary_dof_mask())
    idx = np.arange(0, tV.ndofs, 3)
    np.testing.assert_array_equal(jV.dof_coords_at(idx), tV.dof_coords_at(idx))


@pytest.mark.parametrize("dim,k,cells", CASES)
def test_sliced_dof_map(dim, k, cells):
    jV, tV = _spaces(dim, k, cells)
    jm = jdm.make_leaf_dof_map(jV, None, offset=0)
    tm = tdm.make_leaf_dof_map(tV, None, offset=0)
    assert isinstance(jm, jdm.SlicedDofMap) and isinstance(tm, tdm.SlicedDofMap)
    rng = np.random.default_rng(3)
    x = rng.standard_normal(tV.ndofs)
    g = tm.gather(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(np.asarray(jm.gather(jnp.asarray(x))), g)
    np.testing.assert_array_equal(g, x[tV.element_dofs])
    r0 = rng.standard_normal(tV.ndofs)
    rl = rng.standard_normal(g.shape)
    rj = np.asarray(jm.scatter_add(jnp.asarray(r0), jnp.asarray(rl)))
    rt = tm.scatter_add(torch.from_numpy(r0), torch.from_numpy(rl)).numpy()
    np.testing.assert_allclose(rt, rj, rtol=0, atol=1e-14)


@pytest.mark.parametrize("dim,k,cells", CASES[:2])
def test_index_dof_map(dim, k, cells):
    jV, tV = _spaces(dim, k, cells)
    jm, tm = jdm.IndexDofMap(jV.element_dofs), tdm.IndexDofMap(tV.element_dofs)
    rng = np.random.default_rng(5)
    x = rng.standard_normal(tV.ndofs)
    np.testing.assert_array_equal(np.asarray(jm.gather(jnp.asarray(x))),
                                  tm.gather(torch.from_numpy(x)).numpy())
    rl = rng.standard_normal((tV.mesh.nelements, tV.fem.nbasis))
    rj = np.asarray(jm.scatter_add(jnp.zeros(tV.ndofs), jnp.asarray(rl)))
    rt = tm.scatter_add(torch.zeros(tV.ndofs, dtype=torch.float64),
                        torch.from_numpy(rl)).numpy()
    np.testing.assert_allclose(rt, rj, rtol=0, atol=1e-14)


@pytest.mark.parametrize("dim,k,cells", CASES)
def test_dirichlet_masks(dim, k, cells):
    jV, tV = _spaces(dim, k, cells)
    np.testing.assert_array_equal(jpt.constraints(True, jV).mask_np,
                                  tpt.constraints(True, tV).mask_np)

    def left_or_top(x):
        return np.isclose(x[:, 0], 0.0) | np.isclose(x[:, -1], x[:, -1].max())
    jc, tc = jpt.constraints(left_or_top, jV), tpt.constraints(left_or_top, tV)
    np.testing.assert_array_equal(jc.mask_np, tc.mask_np)
    assert tc.mask.dtype == torch.bool and tc.nconstrained == jc.nconstrained
    np.testing.assert_array_equal(jpt.constraints(None, jV).mask_np,
                                  tpt.constraints(None, tV).mask_np)


@pytest.mark.parametrize("dim,k,cells", CASES)
def test_interpolate_and_helpers(dim, k, cells):
    jV, tV = _spaces(dim, k, cells)
    xj = np.asarray(jV.interpolate(lambda p: np.sin(3 * p[:, 0]) + p[:, -1] ** 2))
    xt = tV.interpolate(lambda p: torch.sin(3 * p[:, 0]) + p[:, -1] ** 2,
                        dtype=torch.float64)
    np.testing.assert_allclose(xt.numpy(), xj, rtol=0, atol=1e-15)
    jc, tc = jpt.constraints(True, jV), tpt.constraints(True, tV)
    z = tV.zero(torch.float64)
    got = tpt.interpolate_dirichlet(lambda p: p[:, 0] + 1.0, tV, tc, z).numpy()
    want = np.asarray(jpt.interpolate_dirichlet(
        lambda p: p[:, 0] + 1.0, jV, jc, jV.zero()))
    np.testing.assert_array_equal(got, want)
    v = torch.from_numpy(xj.copy())
    np.testing.assert_array_equal(
        tpt.set_constrained_dofs(tc, 0.0, v).numpy(),
        np.asarray(jpt.set_constrained_dofs(jc, 0.0, jnp.asarray(xj))))
    np.testing.assert_array_equal(
        tpt.set_nonconstrained_dofs(tc, 0.0, v).numpy(),
        np.asarray(jpt.set_nonconstrained_dofs(jc, 0.0, jnp.asarray(xj))))


def test_default_device_is_the_card():
    """With no device named, the entry points put their tensors on
    default_device(): the card unless set_default_device chose another,
    with no CPU fallback. Here the routing is shown with the meta device,
    and, without a card, torch's own error at the first CUDA tensor."""
    from dune_pdelab_tpu_torch.assembly.stencil import compile_stencil
    from dune_pdelab_tpu_torch.linalg.gmg_lattice import LatticeGMG
    from dune_pdelab_tpu_torch.ops import ConvectionDiffusionFEM as TFEM
    from dune_pdelab_tpu_torch.utils.common import default_device

    V = tpt.FunctionSpace(tpt.StructuredMesh([0] * 3, [1] * 3, (8, 8, 8)), tpt.QkFEM(1, 3))
    try:
        set_default_device(None)
        assert default_device() == torch.device("cuda")
        if not torch.cuda.is_available():
            for make in (V.zero, lambda: tpt.constraints(True, V),
                         lambda: V.interpolate(lambda x: x[:, 0])):
                with pytest.raises((AssertionError, RuntimeError)):
                    make()
        set_default_device("meta")
        assert V.zero().device.type == "meta"
        assert V.interpolate(lambda x: x[:, 0]).device.type == "meta"
        cg = tpt.constraints(True, V)
        assert cg.mask.device.type == "meta"
        go = tpt.GridOperator(V, TFEM(tpt.ops.ConvectionDiffusionProblem()),
                              constraints=cg, skip_boundary=True)
        gmg = LatticeGMG(V, go.lop)
        assert all(st.mask.device.type == "meta" for st in gmg.stencils)
        with pytest.raises(NotImplementedError):
            compile_stencil(go)          # probes run on the mask's (meta) device
    finally:
        set_default_device("cpu")
    assert V.zero().device.type == "cpu"


def test_device_key_normalises_cuda_spellings():
    """The device-keyed caches (GridOperator contexts, DOF maps, constraint
    masks, LatticeGMG levels, backend diagonals, fused operators) share one
    key per device; no CUDA device is needed to compute it."""
    from dune_pdelab_tpu_torch.utils.common import device_key

    keys = {device_key(d) for d in ("cuda", "cuda:0", torch.device("cuda", 0),
                                    torch.device("cuda"))}
    if not torch.cuda.is_available():
        assert keys == {torch.device("cuda", 0)}
    assert len(keys) == 1 and device_key("cuda:1") != device_key("cuda:0")
    assert device_key("cpu") == device_key(torch.device("cpu")) == torch.device("cpu")
    _, tV = _spaces(3, 1, (2, 2, 2))
    tc = tpt.constraints(True, tV)
    assert tc.mask_on("cpu") is tc.mask_on(torch.device("cpu")) is tc.mask


def test_unported_mesh_options_raise():
    """Periodic and mapped StructuredMesh construct (tests/
    test_torch_mapped.py holds them against the JAX package); a bad
    coordinate array raises; an H(curl) space builds on a mapped mesh (its
    covariant Piola map, ROADMAP slice 13b; tests/test_torch_hcurl.py holds
    it against the JAX package) and an unknown continuity raises."""
    from dune_pdelab_tpu_torch.fe.basis import FiniteElement
    from dune_pdelab_tpu_torch.fe.hcurl import N0Cube

    m = tpt.StructuredMesh([0, 0], [1, 1], (4, 4), periodic=(True, False))
    assert m.periodic == (True, False) and m.nvertices == 4 * 5
    V = tpt.FunctionSpace(m, tpt.QkFEM(1, 2))
    bmask = V.boundary_dof_mask()          # y = 0 and y = 1 only: x wraps
    assert V.ndofs == 4 * 5 and bmask[:4].all() and not bmask[4:16].any()
    mapped = tpt.StructuredMesh([0, 0], [1, 1], (1, 1),
                                coords=np.array([[0, 0], [1, 0], [0, 1], [1.2, 1.1]]))
    assert not mapped.uniform and mapped.element_corner_coords()[0, 3, 0] == 1.2
    with pytest.raises(ValueError, match="coords must cover"):
        tpt.StructuredMesh([0, 0], [1, 1], (1, 1), coords=np.zeros((3, 2)))

    Ve = tpt.FunctionSpace(mapped, N0Cube(2))
    assert Ve.ndofs == 4 and Ve.boundary_edge_mask().all()

    class Unknown(FiniteElement):
        geometry, continuity, dim, degree, nbasis, nodes = "cube", "L2 only", 2, 1, 4, None

    with pytest.raises(ValueError, match="continuity"):
        tpt.FunctionSpace(mapped, Unknown())


def test_lazy_mesh_and_space_at_scale():
    """Nothing of size E or N is built at construction (512^3 DOFs)."""
    mesh = tpt.StructuredMesh([0, 0, 0], [1, 1, 1], (511, 511, 511))
    V = tpt.FunctionSpace(mesh, tpt.QkFEM(1, 3))
    assert V.ndofs == 512**3 and V._element_dofs is None
    from dune_pdelab_tpu_torch.assembly.geometry import VolumeGeometry
    geo = VolumeGeometry(mesh, *tq.cube_rule(3, 2))
    assert all(np.asarray(v).size < 100 for v in vars(geo).values()
               if isinstance(v, np.ndarray))
