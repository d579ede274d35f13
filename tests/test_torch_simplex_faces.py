"""Parity of the port's simplex face groups, PkDGFEM and the simplex
DGTwoLevel with the JAX package (fp64).

  * the face groups of `_build_simplex_face_groups`: the same groups, in
    the same order, over the same elements;
  * SIPG PkDGFEM (P1, P2 in 2D; P1 in 3D) with Dirichlet and Neumann
    boundary faces, and conforming P1 with a Neumann/Robin boundary:
    residual, J.v, the assembled jacobian, element_diagonal_blocks and
    jacobian_diagonal to 1e-12 of max|y|; two residual calls bit-equal;
  * `skip_boundary=True` stays an option (the pure-Dirichlet shortcut);
  * DGTwoLevel on a simplex mesh (P1 conforming subspace, AMG coarse
    solve, greedy colours): the colours, and the CG iteration count of the
    reference's test (tests/test_dgmultigrid.py:101), exactly.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

import dune_pdelab_tpu as jpt
import dune_pdelab_tpu_torch as tpt
from dune_pdelab_tpu.fe import PkDGFEM as JPkDG
from dune_pdelab_tpu.linalg import DGTwoLevel as JTwoLevel
from dune_pdelab_tpu.linalg.dgmultigrid import _greedy_element_colors as j_colors
from dune_pdelab_tpu.linalg.krylov import cg as j_cg
from dune_pdelab_tpu.mesh import SimplexMesh as JSimplex
from dune_pdelab_tpu.ops import ConvectionDiffusionFEM as JFEM
from dune_pdelab_tpu.ops import ConvectionDiffusionProblem as JProblem
from dune_pdelab_tpu.ops.convectiondiffusion import BCType as JBC
from dune_pdelab_tpu.ops.convectiondiffusiondg import ConvectionDiffusionDG as JDG
from dune_pdelab_tpu_torch.linalg.dgmultigrid import _greedy_element_colors as t_colors
from dune_pdelab_tpu_torch.linalg.krylov import cg as t_cg
from dune_pdelab_tpu_torch.mesh import SimplexMesh as TSimplex
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


class JP(JProblem):
    def A(self, x):
        return 1.0 + 0.5 * x[..., 0]

    def b(self, x):
        return jnp.stack([0.3 + 0 * x[..., 0]] * x.shape[-1], -1)

    def c(self, x):
        return 0.2

    def f(self, x):
        return jnp.sin(3 * x[..., 0]) * jnp.cos(2 * x[..., -1])

    def g(self, x):
        return x[..., 0] * x[..., -1]

    def bctype(self, x):
        return jnp.where(x[..., 0] > 1 - 1e-9, JBC.NEUMANN, JBC.DIRICHLET)

    def j(self, x):
        return 0.5 + x[..., 1]


class TP(TProblem):
    def A(self, x):
        return 1.0 + 0.5 * x[..., 0]

    def b(self, x):
        return torch.stack([0.3 + 0 * x[..., 0]] * x.shape[-1], -1)

    def c(self, x):
        return 0.2

    def f(self, x):
        return torch.sin(3 * x[..., 0]) * torch.cos(2 * x[..., -1])

    def g(self, x):
        return x[..., 0] * x[..., -1]

    def bctype(self, x):
        x = torch.as_tensor(x)
        return torch.where(x[..., 0] > 1 - 1e-9, TBC.NEUMANN, TBC.DIRICHLET)

    def j(self, x):
        return 0.5 + x[..., 1]


def _meshes(dim, n):
    return (JSimplex.from_structured(jpt.StructuredMesh([0] * dim, [1] * dim, (n,) * dim)),
            TSimplex.from_structured(tpt.StructuredMesh([0] * dim, [1] * dim, (n,) * dim)))


def _ops(case):
    dim, n, k, kind = case
    jm, tm = _meshes(dim, n)
    if kind == "dg":
        jV, tV = jpt.FunctionSpace(jm, JPkDG(k, dim)), tpt.FunctionSpace(tm, tpt.PkDGFEM(k, dim))
        return jpt.GridOperator(jV, JDG(JP())), tpt.GridOperator(tV, TDG(TP()))
    jV, tV = jpt.FunctionSpace(jm, jpt.PkFEM(k, dim)), tpt.FunctionSpace(tm, tpt.PkFEM(k, dim))
    jc = jpt.constraints(JP().dirichlet_bctype(), jV)
    tc = tpt.constraints(TP().dirichlet_bctype(), tV)
    return (jpt.GridOperator(jV, JFEM(JP()), constraints=jc),
            tpt.GridOperator(tV, TFEM(TP()), constraints=tc))


CASES = [(2, 4, 1, "dg"), (2, 3, 2, "dg"), (3, 2, 1, "dg"), (2, 4, 1, "cg"), (3, 2, 2, "cg")]


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}d-k{c[2]}-{c[3]}")
def test_simplex_face_operator_matches_jax(case):
    jgo, tgo = _ops(case)
    assert len(tgo.bnd_groups) == len(jgo.bnd_groups) > 0
    assert len(tgo.skel_groups) == len(jgo.skel_groups)
    for jg, tg in zip(jgo.bnd_groups + jgo.skel_groups, tgo.bnd_groups + tgo.skel_groups):
        np.testing.assert_array_equal(tg.elements, jg.elements)
        if jg.outside is not None:
            np.testing.assert_array_equal(tg.outside, jg.outside)
        np.testing.assert_allclose(tg.factor, jg.factor, rtol=1e-14, atol=0)
    rng = np.random.default_rng(5)
    n = tgo.space.ndofs
    x, z = rng.standard_normal(n), rng.standard_normal(n)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    r = tgo.residual(tx)
    assert _rel(r.numpy(), np.asarray(jgo.residual(jx))) <= 1e-12
    assert torch.equal(r, tgo.residual(tx))            # fixed-order sums
    y = tgo.jacobian_apply(tx, torch.from_numpy(z))
    assert _rel(y.numpy(), np.asarray(jgo.jacobian_apply(jx, jnp.asarray(z)))) <= 1e-12
    if case[:3] != (2, 4, 1):
        return          # the probed blocks: on the 2D P1 cases (JAX compiles dominate)
    A = tgo.jacobian_csr(tx)
    assert _rel(A.toarray(), np.asarray(jgo.jacobian(jx).todense())) <= 1e-12
    assert _rel(A @ z, y.numpy()) <= 1e-12
    assert _rel(tgo.jacobian_diagonal(tx).numpy(), np.asarray(jgo.jacobian_diagonal(jx))) <= 1e-12
    B = tgo.element_diagonal_blocks(tx)
    assert _rel(B.numpy(), np.asarray(jgo.element_diagonal_blocks(jx))) <= 1e-12
    assert torch.equal(B, tgo.element_diagonal_blocks(tx))


def test_skip_boundary_stays_an_option():
    _, tm = _meshes(2, 3)
    V = tpt.FunctionSpace(tm, tpt.PkFEM(1, 2))
    cons = tpt.constraints(True, V)
    full = tpt.GridOperator(V, TFEM(TProblem()), constraints=cons)
    short = tpt.GridOperator(V, TFEM(TProblem()), constraints=cons, skip_boundary=True)
    assert full.bnd_groups and not short.bnd_groups
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(V.ndofs))
    # pure Dirichlet: the boundary kernels add nothing
    assert _rel(short.residual(x).numpy(), full.residual(x).numpy()) <= 1e-14


class JS(JProblem):
    def f(self, x):
        return 1.0 + x[..., 0] * x[..., 1]


class TS(TProblem):
    def f(self, x):
        return 1.0 + x[..., 0] * x[..., 1]


def test_dg_two_level_simplex_iterations_exact():
    jm, tm = _meshes(2, 6)
    for a, b in zip(t_colors(tm), j_colors(jm)):
        np.testing.assert_array_equal(a, b)
    jV, tV = jpt.FunctionSpace(jm, JPkDG(1, 2)), tpt.FunctionSpace(tm, tpt.PkDGFEM(1, 2))
    jgo, tgo = jpt.GridOperator(jV, JDG(JS())), tpt.GridOperator(tV, TDG(TS()))
    jtl = JTwoLevel(jgo, JFEM(JS()))
    ttl = tpt.DGTwoLevel(tgo, TFEM(TS()))
    assert jtl.coarse_kind == ttl.coarse_kind == "amg"
    jtl.setup()
    ttl.setup(tV.zero(F64))
    b = np.random.default_rng(1).standard_normal(tV.ndofs)
    r = np.random.default_rng(2).standard_normal(tV.ndofs)
    assert _rel(ttl.apply(torch.from_numpy(r)).numpy(),
                np.asarray(jtl.apply(jnp.asarray(r)))) <= 1e-10
    x0j, x0t = jV.zero(), tV.zero(F64)
    zj, sj = j_cg(lambda q: jgo.jacobian_apply(x0j, q), jnp.asarray(b), M=jtl.apply, tol=1e-10)
    zt, st = t_cg(lambda q: tgo.jacobian_apply(x0t, q), torch.from_numpy(b), M=ttl.apply,
                  tol=1e-10)
    assert int(st.iterations) == int(sj.iterations)
    assert _rel(zt.numpy(), np.asarray(zj)) <= 1e-8
