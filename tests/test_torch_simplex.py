"""Parity of the port's simplex volume path with the JAX package (fp64).

  * simplex_rule (dim 2 and 3, orders 1-6) and the simplex branch of
    quadrature_rule to 1e-14; PkFEM tabulation (k = 1, 2, 3) to 1e-14;
  * SimplexMesh.from_structured: vertices, cells, edges, faces, interior
    and boundary faces and the three boundary masks, exactly;
  * the simplex C0 DOF map, exactly, and the boundary DOF mask, DOF
    coordinates, interpolation and constraints built on it;
  * the per-element VolumeGeometry (J^-T, factor, cell volume, qp_phys) to
    1e-14;
  * residual and jacobian of P1/P2 Poisson on a triangulated 8^2 and of P1
    on 4^3 tetrahedra, to 1e-12 of max|y|; l2_difference and
    DiscreteGridFunction on those spaces;
  * the structured fast paths decline a simplex mesh with the documented
    answer (compile_stencil, assemble_ell and the fused operator: None;
    residual_slabbed: ValueError); face kernels, gmsh input, submesh and
    bisection now work (tests/test_torch_simplex_faces.py,
    test_torch_bisection.py and test_torch_gmsh.py hold them against the
    JAX package), and the stubs still left name ROADMAP slice 13.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

import dune_pdelab_tpu as jpt
import dune_pdelab_tpu_torch as tpt
from dune_pdelab_tpu.assembly.geometry import VolumeGeometry as JGeo
from dune_pdelab_tpu.fe import PkFEM as JPk
from dune_pdelab_tpu.fe.quadrature import quadrature_rule as j_rule, simplex_rule as j_simplex
from dune_pdelab_tpu.mesh import SimplexMesh as JSimplex
from dune_pdelab_tpu.ops import ConvectionDiffusionFEM as JFEM
from dune_pdelab_tpu.ops import ConvectionDiffusionProblem as JProblem
from dune_pdelab_tpu.space.functions import l2_difference as j_l2
from dune_pdelab_tpu_torch.assembly.ell import assemble_ell, assemble_ell_direct
from dune_pdelab_tpu_torch.assembly.geometry import VolumeGeometry as TGeo
from dune_pdelab_tpu_torch.assembly.slabbed import residual_slabbed
from dune_pdelab_tpu_torch.assembly.stencil import compile_stencil
from dune_pdelab_tpu_torch.assembly.structured_fused import (
    make_fused_japply, make_fused_residual,
)
from dune_pdelab_tpu_torch.fe import PkFEM as TPk
from dune_pdelab_tpu_torch.fe.quadrature import (
    quadrature_rule as t_rule, simplex_rule as t_simplex,
)
from dune_pdelab_tpu_torch.interop import simplex_mesh_from_numpy
from dune_pdelab_tpu_torch.mesh import SimplexMesh as TSimplex
from dune_pdelab_tpu_torch.ops import ConvectionDiffusionFEM as TFEM
from dune_pdelab_tpu_torch.ops import ConvectionDiffusionProblem as TProblem
from dune_pdelab_tpu_torch.space.functions import DiscreteGridFunction
from dune_pdelab_tpu_torch.space.functions import l2_difference as t_l2
from dune_pdelab_tpu_torch.utils.common import set_default_device

pytestmark = pytest.mark.fast
torch.set_num_threads(1)
set_default_device("cpu")
F64 = torch.float64


class JSrc(JProblem):
    def A(self, x):
        return 1.0 + 0.5 * x[..., 0]

    def f(self, x):
        return jnp.sin(3 * x[..., 0]) * jnp.cos(2 * x[..., -1])


class TSrc(TProblem):
    def A(self, x):
        return 1.0 + 0.5 * x[..., 0]

    def f(self, x):
        return torch.sin(3 * x[..., 0]) * torch.cos(2 * x[..., -1])


def _meshes(dim, n):
    sm_j = jpt.StructuredMesh([0] * dim, [1] * dim, (n,) * dim)
    sm_t = tpt.StructuredMesh([0] * dim, [1] * dim, (n,) * dim)
    return JSimplex.from_structured(sm_j), TSimplex.from_structured(sm_t)


def _spaces(dim, n, k):
    jm, tm = _meshes(dim, n)
    return jpt.FunctionSpace(jm, JPk(k, dim)), tpt.FunctionSpace(tm, TPk(k, dim))


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("order", [1, 2, 3, 4, 5, 6])
def test_simplex_rule(dim, order):
    jp, jw = j_simplex(dim, order)
    tp, tw = t_simplex(dim, order)
    assert tp.shape == jp.shape and tp.dtype == np.float64
    assert np.abs(tp - jp).max() <= 1e-14 and np.abs(tw - jw).max() <= 1e-14
    rp, rw = t_rule("simplex", dim, order)
    jrp, jrw = j_rule("simplex", dim, order)
    assert np.abs(rp - jrp).max() <= 1e-14 and np.abs(rw - jrw).max() <= 1e-14
    assert abs(tw.sum() - 1.0 / (2 if dim == 2 else 6)) <= 1e-14


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("k", [1, 2, 3])
def test_pk_tabulation(dim, k):
    jf, tf = JPk(k, dim), TPk(k, dim)
    assert tf.nbasis == jf.nbasis and np.array_equal(tf.nodes, jf.nodes)
    assert tf.geometry == "simplex" and tf.continuity == "C0"
    pts, _ = t_simplex(dim, 4)
    jv, jg = jf.tabulate(pts)
    tv, tg = tf.tabulate(pts)
    assert np.abs(tv - jv).max() <= 1e-14 and np.abs(tg - jg).max() <= 1e-14
    # a Lagrange basis: identity at the nodes
    assert np.abs(tf.tabulate(tf.nodes)[0] - np.eye(tf.nbasis)).max() <= 1e-12


@pytest.mark.parametrize("dim,n", [(2, 5), (3, 3)])
def test_mesh_from_structured(dim, n):
    jm, tm = _meshes(dim, n)
    assert np.array_equal(tm.vertices, jm.vertices)
    assert np.array_equal(tm.cells, jm.cells)
    for name in ("boundary_vertex_mask", "boundary_edge_mask", "boundary_face_mask",
                 "element_centers", "corner_offsets", "element_corner_coords"):
        assert np.array_equal(getattr(tm, name)(), getattr(jm, name)()), name
    for a, b in zip(tm.edges(), jm.edges()):
        assert np.array_equal(a, b)
    for a, b in zip(tm.faces(), jm.faces()):
        assert np.array_equal(a, b)
    for name in ("interior_faces", "boundary_faces"):
        tf, jf = getattr(tm, name)(), getattr(jm, name)()
        assert tf.keys() == jf.keys()
        assert all(np.array_equal(tf[key], jf[key]) for key in tf), name
    back = simplex_mesh_from_numpy(jm.vertices, jm.cells, jm.boundary_vertex_mask())
    assert np.array_equal(back.cells, tm.cells)
    assert np.array_equal(back.boundary_vertex_mask(), tm.boundary_vertex_mask())


@pytest.mark.parametrize("dim,n,k", [(2, 4, 1), (2, 4, 2), (2, 3, 3), (3, 2, 1),
                                     (3, 2, 2), (3, 2, 3)])
def test_simplex_c0_map(dim, n, k):
    jV, tV = _spaces(dim, n, k)
    assert tV.ndofs == jV.ndofs
    assert np.array_equal(tV.element_dofs, np.asarray(jV.element_dofs, np.int64))
    assert np.array_equal(tV.boundary_dof_mask(), jV.boundary_dof_mask())
    assert np.abs(tV.dof_coords() - jV.dof_coords()).max() <= 1e-15
    idx = np.arange(0, tV.ndofs, 3)
    assert np.array_equal(tV.dof_coords_at(idx), tV.dof_coords()[idx])

    def f_np(x):
        return np.sin(2 * x[:, 0]) + x[:, -1] ** 2

    xt = tV.interpolate(lambda x: f_np(x.numpy()), dtype=F64)
    xj = jV.interpolate(lambda x: f_np(np.asarray(x)))
    assert np.abs(xt.numpy() - np.asarray(xj)).max() <= 1e-15
    jc = jpt.constraints(lambda x: x[:, 0] < 0.5, jV)
    tc = tpt.constraints(lambda x: x[:, 0] < 0.5, tV)
    assert np.array_equal(tc.mask_np, np.asarray(jc.mask))
    xd = tpt.interpolate_dirichlet(lambda x: f_np(x.numpy()), tV, tc, tV.zero(F64))
    assert np.array_equal(xd.numpy() != 0, tc.mask_np & (xt.numpy() != 0))


@pytest.mark.parametrize("dim,n", [(2, 3), (3, 2)])
def test_volume_geometry(dim, n):
    jm, tm = _meshes(dim, n)
    qp, w = t_simplex(dim, 3)
    jg, tg = JGeo(jm, qp, w), TGeo(tm, qp, w)
    for name in ("jac_inv_T", "factor", "cell_volume", "qp_phys"):
        a, b = getattr(tg, name), np.asarray(getattr(jg, name))
        assert a.shape == b.shape and np.abs(a - b).max() <= 1e-14 * max(1, np.abs(b).max())
    _, grads = TPk(2, dim).tabulate(qp)
    assert np.abs(tg.transform_grad(grads) - jg.transform_grad(grads)).max() <= 1e-13
    assert abs(tg.cell_volume.sum() - 1.0) <= 1e-14
    x = tg.x_tensor(F64, "cpu")
    assert x.shape == (tm.nelements, len(w), dim) and np.array_equal(x.numpy(), tg.qp_phys)


@pytest.mark.parametrize("dim,n,k", [(2, 8, 1), (2, 8, 2), (3, 4, 1)])
def test_operator_parity(dim, n, k):
    jV, tV = _spaces(dim, n, k)
    jc, tc = jpt.constraints(True, jV), tpt.constraints(True, tV)
    jgo = jpt.GridOperator(jV, JFEM(JSrc()), constraints=jc)
    tgo = tpt.GridOperator(tV, TFEM(TSrc()), constraints=tc, skip_boundary=True)
    x = np.random.default_rng(7).standard_normal(jV.ndofs)
    rj = np.asarray(jgo.residual(jnp.asarray(x)))
    rt = tgo.residual(torch.from_numpy(x)).numpy()
    assert np.abs(rt - rj).max() <= 1e-12 * np.abs(rj).max()
    z = np.random.default_rng(8).standard_normal(jV.ndofs)
    yj = np.asarray(jgo.jacobian_apply(jnp.asarray(x), jnp.asarray(z)))
    yt = tgo.jacobian_apply(torch.from_numpy(x), torch.from_numpy(z)).numpy()
    assert np.abs(yt - yj).max() <= 1e-12 * np.abs(yj).max()
    Aj = jgo.jacobian(jnp.asarray(x)).todense()
    At = tgo.jacobian_csr(torch.from_numpy(x))
    assert At.has_canonical_format
    assert np.abs(At.toarray() - np.asarray(Aj)).max() <= 1e-12 * np.abs(np.asarray(Aj)).max()
    # the assembled matrix is the matrix-free one
    assert np.abs(At @ z - yt).max() <= 1e-12 * np.abs(yt).max()
    dt = tgo.jacobian_diagonal(torch.from_numpy(x)).numpy()
    assert np.abs(dt - At.diagonal()).max() <= 1e-12 * np.abs(dt).max()


@pytest.mark.parametrize("dim,n,k", [(2, 6, 1), (2, 4, 2), (3, 3, 1)])
def test_l2_and_grid_function(dim, n, k):
    jV, tV = _spaces(dim, n, k)

    def ex(p):
        return np.sin(np.pi * p[:, 0]) * np.cos(p[:, -1])

    x = np.random.default_rng(3).standard_normal(jV.ndofs)
    ej = float(j_l2(jV, jnp.asarray(x), ex))
    et = float(t_l2(tV, torch.from_numpy(x), lambda p: ex(p.numpy())))
    assert abs(et - ej) <= 1e-13 * ej
    def poly(p):                      # degree k: reproduced exactly by Pk
        return (0.3 + p[:, 0] - 2 * p[:, -1]) ** k + p[:, 0] * 0.5

    dgf = DiscreteGridFunction(tV, tV.interpolate(lambda p: poly(p.numpy()), dtype=F64))
    pts = np.random.default_rng(4).uniform(0.0, 1.0, (40, dim))
    assert np.abs(dgf(pts).numpy() - poly(pts)).max() <= 1e-12
    nodes = tV.dof_coords()[::5]
    assert np.abs(dgf(nodes).numpy() - poly(nodes)).max() <= 1e-12
    jnorm = float(jpt.space.functions.l2_norm(jV, jnp.asarray(dgf.x.numpy())))
    assert abs(float(dgf.l2_norm()) - jnorm) <= 1e-13 * jnorm


def test_fast_paths_decline_simplex():
    jV, tV = _spaces(3, 3, 1)
    tc = tpt.constraints(True, tV)
    tgo = tpt.GridOperator(tV, TFEM(TSrc()), constraints=tc, skip_boundary=True)
    x = tV.zero(F64)
    assert compile_stencil(tgo) is None
    assert compile_stencil(tgo, x) is None
    assert assemble_ell(tgo, x) is None
    assert assemble_ell_direct(tgo, x) is None
    assert make_fused_residual(tgo) is None and make_fused_japply(tgo) is None
    with pytest.raises(ValueError, match="structured cube"):
        residual_slabbed(tV, tgo.lop, tc, x)
    # the backend falls through to the general jvp, naming the declines
    ls = tpt.SEQ_CG_Jacobi()
    _, s = ls.solve(tgo, x, tgo.residual(x), 1e-10)
    assert bool(s.converged) and "general-jvp" in ls.report()
    assert "compile_stencil declined" in ls.report()
    ell_backend = tpt.SEQ_CG_Jacobi(matrix_free=False)
    _, s2 = ell_backend.solve(tgo, x, tgo.residual(x), 1e-10)
    assert "sparse COO" in ell_backend.report() and s2.iterations == s.iterations


def test_simplex_faces_and_stubs_raise():
    """Face kernels build on a simplex mesh (skip_boundary is no longer
    needed), submesh and bisection run; the native MSH reader names ROADMAP
    slice 13; an H(div) space builds on triangles."""
    from dune_pdelab_tpu_torch.fe.hdiv import RT0Simplex2D

    _, tV = _spaces(2, 3, 1)
    go = tpt.GridOperator(tV, TFEM(TSrc()), constraints=tpt.constraints(True, tV))
    assert go.bnd_groups and not go.skel_groups
    _, tm = _meshes(2, 3)
    with pytest.raises(NotImplementedError, match="slice 13"):
        TSimplex.from_gmsh("mesh.msh", reader="native")
    sub = tm.submesh(np.ones(tm.nelements, bool))
    np.testing.assert_array_equal(sub.cells, tm.cells)
    fine, (nv, mids, ends) = tm.oriented_for_bisection().refine_bisection(
        np.ones(tm.nelements, bool))
    assert nv == tm.nvertices and len(mids) == len(ends) > 0
    assert fine.nelements >= 2 * tm.nelements and len(fine.parent_cells) == fine.nelements

    # H(div) on simplices (slice 13b): one DOF per unique face, signed per
    # element; its boundary_dof_mask raises (tests/test_torch_hdiv.py)
    V_rt = tpt.FunctionSpace(tm, RT0Simplex2D())
    assert V_rt.ndofs == len(tm.faces()[0]) and set(np.unique(V_rt._hdiv_signs)) == {-1.0, 1.0}
    with pytest.raises(NotImplementedError, match="boundary_dof_mask"):
        V_rt.boundary_dof_mask()
    with pytest.raises(ValueError, match="geometry"):
        tpt.FunctionSpace(tm, tpt.QkFEM(1, 2))
