"""Parity of the port's periodic and mapped structured meshes with the JAX
package (fp64).

  * StructuredMesh with periodic axes and/or mapped coordinates: vertex and
    corner coordinates, face lists, refine/coarsen of a mapped mesh, the
    periodic closure check (rtol=0 in the port: a closure off by 1e-9
    relative raises, where the reference's rtol=1e-5 lets it pass) and
    structured_mesh_from_numpy;
  * periodic C0 (Q1/Q2, the wrapped SlicedDofMap) and DG (SIPG, the rolled
    SlabFaceTransfer, and the index transfer) residual and J.v to 1e-12;
  * mapped C0 with a Neumann arc (Nanson boundary faces), mapped SIPG
    (two-sided skeleton faces), and mapped-periodic (full annulus)
    residual and J.v to 1e-12; the identity map reproduces the uniform
    operator to 1e-12 of max|y|;
  * every fast tier declines periodic and mapped operators, and the
    backend's report names the decline.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

import dune_pdelab_tpu as jpt
import dune_pdelab_tpu_torch as tpt
from dune_pdelab_tpu.fe import QkDGFEM as JQkDG
from dune_pdelab_tpu.ops import ConvectionDiffusionFEM as JFEM
from dune_pdelab_tpu.ops import ConvectionDiffusionProblem as JProblem
from dune_pdelab_tpu.ops.convectiondiffusion import BCType as JBC
from dune_pdelab_tpu.ops.convectiondiffusiondg import ConvectionDiffusionDG as JDG
from dune_pdelab_tpu_torch.assembly.blockstencil import compile_block_stencil
from dune_pdelab_tpu_torch.assembly.ell import assemble_ell, assemble_ell_direct
from dune_pdelab_tpu_torch.assembly.slabbed import residual_slabbed
from dune_pdelab_tpu_torch.assembly.stencil import compile_stencil
from dune_pdelab_tpu_torch.assembly.structured_fused import make_fused_residual
from dune_pdelab_tpu_torch.interop import structured_mesh_from_numpy
from dune_pdelab_tpu_torch.linalg.gmg_lattice import LatticeGMG
from dune_pdelab_tpu_torch.linalg.gmg_varcoeff import VarCoeffGMG
from dune_pdelab_tpu_torch.ops import ConvectionDiffusionFEM as TFEM
from dune_pdelab_tpu_torch.ops import ConvectionDiffusionProblem as TProblem
from dune_pdelab_tpu_torch.ops.convectiondiffusion import BCType as TBC
from dune_pdelab_tpu_torch.ops.convectiondiffusiondg import ConvectionDiffusionDG as TDG
from dune_pdelab_tpu_torch.utils.common import set_default_device

pytestmark = pytest.mark.fast
torch.set_num_threads(1)
set_default_device("cpu")
F64 = torch.float64


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _wavy_coords(cells):
    """A smooth non-affine map of the unit box (every axis bent)."""
    uni = jpt.StructuredMesh([0] * len(cells), [1] * len(cells), cells)
    v = uni.vertex_coords()
    bend = 0.04 * np.sin(np.pi * v).prod(axis=1)
    return v + bend[:, None] * np.arange(1, len(cells) + 1)


def _mesh_pair(kind):
    """(jax mesh, port mesh) of one configuration."""
    if kind == "periodic2":
        args = ([0, 0], [1, 2], (4, 3)), dict(periodic=(True, False))
    elif kind == "periodic3":
        args = ([0, 0, 0], [1, 1, 1], (3, 2, 4)), dict(periodic=(False, True, True))
    elif kind == "annulus":
        c = np.stack(np.meshgrid(1.0 + np.arange(6) / 5, 0.5 * np.pi * np.arange(5) / 4,
                                 indexing="xy"), -1).reshape(-1, 2)
        coords = np.stack([c[:, 0] * np.cos(c[:, 1]), c[:, 0] * np.sin(c[:, 1])], -1)
        args = ([0, 0], [1, 1], (5, 4)), dict(coords=coords)
    elif kind == "full_annulus":
        args = ([0, 0], [1, 1], (4, 6)), dict(periodic=(False, True))
        c = np.stack(np.meshgrid(1.0 + np.arange(5) / 4, 2 * np.pi * np.arange(7) / 6,
                                 indexing="xy"), -1).reshape(-1, 2)
        args[1]["coords"] = np.stack([c[:, 0] * np.cos(c[:, 1]),
                                      c[:, 0] * np.sin(c[:, 1])], -1)
    elif kind == "wavy3":
        args = ([0, 0, 0], [1, 1, 1], (3, 2, 2)), dict(coords=_wavy_coords((3, 2, 2)))
    else:
        raise ValueError(kind)
    return jpt.StructuredMesh(*args[0], **args[1]), tpt.StructuredMesh(*args[0], **args[1])


KINDS = ["periodic2", "periodic3", "annulus", "full_annulus", "wavy3"]


@pytest.mark.parametrize("kind", KINDS)
def test_mesh_arrays_equal(kind):
    jm, tm = _mesh_pair(kind)
    assert tm.nvertices == jm.nvertices and tm.uniform == jm.uniform
    np.testing.assert_array_equal(tm.vertex_coords(), jm.vertex_coords())
    np.testing.assert_array_equal(tm.element_corner_coords(), jm.element_corner_coords())
    np.testing.assert_array_equal(tm.element_vertex_indices(), jm.element_vertex_indices())
    for a, b in ((tm.interior_faces(), jm.interior_faces()),
                 (tm.boundary_faces(), jm.boundary_faces())):
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])
    for op in ("refine", "coarsen"):
        if op == "coarsen" and any(c % 2 for c in jm.cells):
            continue
        ja, ta = getattr(jm, op)(), getattr(tm, op)()
        assert ta.cells == ja.cells and ta.periodic == ja.periodic
        np.testing.assert_array_equal(ta.element_corner_coords(), ja.element_corner_coords())
    rt = structured_mesh_from_numpy(jm.lower, jm.upper, jm.cells, jm.periodic, jm.coords)
    np.testing.assert_array_equal(rt.element_corner_coords(), jm.element_corner_coords())
    assert rt.periodic == jm.periodic


def test_periodic_closure_check_uses_rtol_zero():
    c = np.stack(np.meshgrid(1.0 + np.arange(3) / 2, 2 * np.pi * np.arange(4) / 3,
                             indexing="xy"), -1).reshape(-1, 2)
    coords = np.stack([c[:, 0] * np.cos(c[:, 1]), c[:, 0] * np.sin(c[:, 1])], -1)
    coords[-3:] *= 1.0 + 1e-9          # the closure plane off by 1e-9 relative
    jpt.StructuredMesh([0, 0], [1, 1], (2, 3), periodic=(False, True), coords=coords)
    with pytest.raises(ValueError, match="do not close"):
        tpt.StructuredMesh([0, 0], [1, 1], (2, 3), periodic=(False, True), coords=coords)
    with pytest.raises(ValueError, match="coords must cover"):
        tpt.StructuredMesh([0, 0], [1, 1], (2, 3), coords=coords[:-1])


class JP(JProblem):
    def A(self, x):
        return 1.0 + 0.3 * x[..., 0] * x[..., 0]

    def b(self, x):
        return jnp.stack([0.4 + 0 * x[..., 0]] + [0.2 + 0 * x[..., 0]] * (x.shape[-1] - 1), -1)

    def c(self, x):
        return 0.5

    def f(self, x):
        return jnp.sin(2 * x[..., 0]) + x[..., -1]

    def g(self, x):
        return x[..., 0] ** 2 - x[..., 1] ** 2

    def bctype(self, x):
        r2 = x[..., 0] ** 2 + x[..., 1] ** 2
        return jnp.where(r2 > 3.9, JBC.NEUMANN, JBC.DIRICHLET)

    def j(self, x):
        return 0.7 + 0.1 * x[..., 1]


class TP(TProblem):
    def A(self, x):
        return 1.0 + 0.3 * x[..., 0] * x[..., 0]

    def b(self, x):
        return torch.stack([0.4 + 0 * x[..., 0]] + [0.2 + 0 * x[..., 0]] * (x.shape[-1] - 1), -1)

    def c(self, x):
        return 0.5

    def f(self, x):
        return torch.sin(2 * x[..., 0]) + x[..., -1]

    def g(self, x):
        return x[..., 0] ** 2 - x[..., 1] ** 2

    def bctype(self, x):
        x = torch.as_tensor(x)             # constraints() passes numpy points
        r2 = x[..., 0] ** 2 + x[..., 1] ** 2
        return torch.where(r2 > 3.9, TBC.NEUMANN, TBC.DIRICHLET)

    def j(self, x):
        return 0.7 + 0.1 * x[..., 1]


def _check(jgo, tgo, seed=0):
    rng = np.random.default_rng(seed)
    n = tgo.space.ndofs
    x, z = rng.standard_normal(n), rng.standard_normal(n)
    r = tgo.residual(torch.from_numpy(x))
    assert _rel(r.numpy(), np.asarray(jgo.residual(jnp.asarray(x)))) <= 1e-12
    y = tgo.jacobian_apply(torch.from_numpy(x), torch.from_numpy(z))
    assert _rel(y.numpy(), np.asarray(jgo.jacobian_apply(jnp.asarray(x), jnp.asarray(z)))) <= 1e-12
    assert torch.equal(r, tgo.residual(torch.from_numpy(x)))
    return r, y


@pytest.mark.parametrize("kind,k", [(kind, 1) for kind in KINDS]
                         + [("periodic3", 2), ("full_annulus", 2), ("wavy3", 2)])
def test_c0_operator_matches_jax(kind, k):
    jm, tm = _mesh_pair(kind)
    dim = jm.dim
    jV, tV = jpt.FunctionSpace(jm, jpt.QkFEM(k, dim)), tpt.FunctionSpace(tm, tpt.QkFEM(k, dim))
    assert tV.ndofs == jV.ndofs
    jc, tc = jpt.constraints(JP().dirichlet_bctype(), jV), tpt.constraints(TP().dirichlet_bctype(), tV)
    np.testing.assert_array_equal(tc.mask_np, jc.mask_np)
    jgo = jpt.GridOperator(jV, JFEM(JP()), constraints=jc)
    tgo = tpt.GridOperator(tV, TFEM(TP()), constraints=tc)
    assert len(tgo.bnd_groups) == len(jgo.bnd_groups)
    _check(jgo, tgo)
    x0 = np.asarray(jpt.interpolate_dirichlet(lambda q: np.asarray(JP().g(jnp.asarray(q))),
                                              jV, jc, jV.zero()))
    t0 = tpt.interpolate_dirichlet(TP().g, tV, tc, tV.zero(F64))
    assert _rel(t0.numpy(), x0) <= 1e-14


@pytest.mark.parametrize("kind", KINDS)
def test_dg_operator_matches_jax(kind):
    jm, tm = _mesh_pair(kind)
    dim = jm.dim
    jV, tV = jpt.FunctionSpace(jm, JQkDG(1, dim)), tpt.FunctionSpace(tm, tpt.QkDGFEM(1, dim))
    jgo = jpt.GridOperator(jV, JDG(JP()))
    tgo = tpt.GridOperator(tV, TDG(TP()))
    assert len(tgo.skel_groups) == len(jgo.skel_groups)
    for jg, tg in zip(jgo.skel_groups, tgo.skel_groups):
        np.testing.assert_array_equal(tgo.group_elements(tg), jg.elements)
        np.testing.assert_array_equal(tgo.group_elements(tg, outside=True), jg.outside)
    r, y = _check(jgo, tgo, 1)
    idx = tpt.GridOperator(tV, TDG(TP()), face_transfer="index")
    rng = np.random.default_rng(1)
    x, z = (torch.from_numpy(rng.standard_normal(tV.ndofs)) for _ in range(2))
    assert _rel(idx.residual(x).numpy(), r.numpy()) <= 1e-13
    assert _rel(idx.jacobian_apply(x, z).numpy(), y.numpy()) <= 1e-13
    if kind != "full_annulus":
        return
    # the probed blocks on the mesh that is both mapped and periodic
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(tV.ndofs))
    jx = jnp.asarray(x.numpy())
    assert _rel(tgo.jacobian_diagonal(x).numpy(), np.asarray(jgo.jacobian_diagonal(jx))) <= 1e-12
    assert _rel(tgo.element_diagonal_blocks(x).numpy(),
                np.asarray(jgo.element_diagonal_blocks(jx))) <= 1e-12
    assert _rel(tgo.jacobian_csr(x).toarray(), np.asarray(jgo.jacobian(jx).todense())) <= 1e-12


@pytest.mark.parametrize("fem", ["q1", "dg"])
def test_identity_map_equals_uniform(fem):
    n, dim = 5, 2
    uni = tpt.StructuredMesh([0] * dim, [1] * dim, (n,) * dim)
    mapped = tpt.StructuredMesh([0] * dim, [1] * dim, (n,) * dim,
                                coords=uni.vertex_coords().copy())
    outs = []
    for mesh in (uni, mapped):
        if fem == "q1":
            V = tpt.FunctionSpace(mesh, tpt.QkFEM(1, dim))
            go = tpt.GridOperator(V, TFEM(TP()), constraints=tpt.constraints(
                TP().dirichlet_bctype(), V))
        else:
            V = tpt.FunctionSpace(mesh, tpt.QkDGFEM(1, dim))
            go = tpt.GridOperator(V, TDG(TP()))
        rng = np.random.default_rng(4)
        x, z = (torch.from_numpy(rng.standard_normal(V.ndofs)) for _ in range(2))
        outs.append((go.residual(x), go.jacobian_apply(x, z)))
    for a, b in zip(*outs):
        assert float((a - b).abs().max()) <= 1e-12 * float(b.abs().max())


def test_fast_tiers_decline_periodic_and_mapped():
    for kind in ("periodic3", "wavy3"):
        _, tm = _mesh_pair(kind)
        V = tpt.FunctionSpace(tm, tpt.QkFEM(1, 3))
        cg = tpt.constraints(True, V)
        go = tpt.GridOperator(V, TFEM(TProblem()), constraints=cg, skip_boundary=True)
        x = V.zero(F64)
        assert compile_stencil(go, x) is None
        assert assemble_ell(go, x) is None and assemble_ell_direct(go, x) is None
        assert make_fused_residual(go) is None
        with pytest.raises(ValueError, match="non-periodic"):
            residual_slabbed(V, go.lop, cg, x)
        with pytest.raises(ValueError, match="uniform non-periodic"):
            LatticeGMG(V, go.lop)
        with pytest.raises(ValueError, match="uniform non-periodic"):
            VarCoeffGMG(go)
        ls = tpt.SEQ_CG_Jacobi()
        _, s = ls.solve(go, x, go.residual(x), 1e-8)
        assert "compile_stencil declined" in ls.report() and "general-jvp" in ls.report()
        ell = tpt.SEQ_CG_Jacobi(matrix_free=False)
        ell.solve(go, x, go.residual(x), 1e-8)
        assert "assemble_ell declined" in ell.report()
        Vd = tpt.FunctionSpace(tm, tpt.QkDGFEM(1, 3))
        god = tpt.GridOperator(Vd, TDG(TProblem()))
        assert compile_block_stencil(god, Vd.zero(F64)) is None
