"""Composite spaces of the port against the JAX package (fp64, CPU).

  * CompositeSpace (lexicographic, interleaved, entity_blocked orderings,
    chunked descriptor), PowerSpace, VectorSpace, PermutedSpace and
    `entity_blocked`: ndofs, leaf maps, child_global, restrict/embed and
    composite interpolation equal the JAX package's;
  * composite constraints masks equal;
  * the cases of tests/test_orderings.py: permuted and entity-blocked
    solves match the unpermuted ones and the JAX package's;
  * IndexDofMap's scatter (one gather through the transpose map and one
    fixed-order sum) equals an index_add sum to 1e-14 and gives the same
    bits on every call; interleaved and permuted composite residuals,
    J.v and diagonals equal the JAX package's;
  * a DG leaf inside a composite space takes the reshape and slab fast
    paths.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

import dune_pdelab_tpu as jpt
import dune_pdelab_tpu_torch as tpt
from dune_pdelab_tpu.ops import ConvectionDiffusionFEM as JFEM
from dune_pdelab_tpu.ops import ConvectionDiffusionProblem as JProblem
from dune_pdelab_tpu.ops.base import LocalOperator as JLocalOperator
from dune_pdelab_tpu.solvers import SEQ_CG_Jacobi as J_CG_Jacobi
from dune_pdelab_tpu.solvers.stokes import stokes_constraints as j_stokes_constraints
from dune_pdelab_tpu_torch.assembly.dofmaps import (
    IndexDofMap, ReshapeDofMap, SlabFaceTransfer, SlicedDofMap,
)
from dune_pdelab_tpu_torch.ops import ConvectionDiffusionFEM as TFEM
from dune_pdelab_tpu_torch.ops import ConvectionDiffusionProblem as TProblem
from dune_pdelab_tpu_torch.ops.base import LocalOperator as TLocalOperator
from dune_pdelab_tpu_torch.solvers import SEQ_CG_Jacobi
from dune_pdelab_tpu_torch.solvers.stokes import stokes_constraints
from dune_pdelab_tpu_torch.utils.common import set_default_device

pytestmark = pytest.mark.fast
torch.set_num_threads(1)
set_default_device("cpu")
F64 = torch.float64


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _trees(pkg, dim, n):
    """{name: space} of every composite construction, built with `pkg`."""
    mesh = pkg.StructuredMesh([0.0] * dim, [1.0] * dim, (n,) * dim)
    q1 = pkg.FunctionSpace(mesh, pkg.QkFEM(1, dim), name="q1")
    q2 = pkg.FunctionSpace(mesh, pkg.QkFEM(2, dim), name="q2")
    dg = pkg.FunctionSpace(mesh, pkg.QkDGFEM(1, dim), name="dg")
    perm = np.random.default_rng(3).permutation(q2.ndofs)
    th = pkg.CompositeSpace(pkg.PowerSpace(q2, dim), q1)
    return {
        "lexicographic": pkg.CompositeSpace(q2, q1, dg),
        "interleaved": pkg.CompositeSpace(q1, q1, ordering="interleaved", chunk=2),
        "entity_blocked_ordering": pkg.CompositeSpace(q2, q2, ordering="entity_blocked"),
        "power_interleaved": pkg.PowerSpace(q1, 3, ordering="interleaved"),
        "vector": _vector_space(pkg, mesh),
        "taylor_hood": th,
        "permuted": pkg.PermutedSpace(q2, perm),
        "entity_blocked": pkg.entity_blocked(th),
        "nested_interleaved_dg": pkg.CompositeSpace(
            pkg.PowerSpace(dg, 2, ordering="interleaved"), q1),
    }


def _vector_space(pkg, mesh):
    if pkg is jpt:
        from dune_pdelab_tpu.space.space import VectorSpace
    else:
        from dune_pdelab_tpu_torch.space import VectorSpace
    return VectorSpace(mesh, pkg.QkFEM(1, mesh.dim))


NAMES = list(_trees(tpt, 2, 2))


@pytest.mark.parametrize("dim,n", [(2, 3), (3, 2)])
@pytest.mark.parametrize("name", NAMES)
def test_space_maps_match(name, dim, n):
    js, ts = _trees(jpt, dim, n)[name], _trees(tpt, dim, n)[name]
    assert ts.ndofs == js.ndofs and ts.nchildren == js.nchildren
    assert ts.local_sizes() == js.local_sizes()
    for a, b in zip(ts.leaf_element_dofs(), js.leaf_element_dofs()):
        np.testing.assert_array_equal(a, b)
    for i, c in enumerate(ts.children):
        idx = np.arange(c.ndofs, dtype=np.int64)
        np.testing.assert_array_equal(ts.child_global(i, idx), js.child_global(i, idx))
    if name == "entity_blocked":
        np.testing.assert_array_equal(ts.perm, js.perm)
        np.testing.assert_array_equal(ts.entity_block_sizes, js.entity_block_sizes)
    # restrict / embed of a seeded vector, child by child
    rng = np.random.default_rng(7)
    x = rng.standard_normal(ts.ndofs)
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    for i, c in enumerate(ts.children):
        np.testing.assert_array_equal(ts.restrict(xt, i).numpy(),
                                      np.asarray(js.restrict(xj, i)))
        xc = rng.standard_normal(c.ndofs)
        np.testing.assert_array_equal(
            ts.embed(xt, i, torch.from_numpy(xc)).numpy(),
            np.asarray(js.embed(xj, i, jnp.asarray(xc))))
    np.testing.assert_array_equal(xt.numpy(), x)            # embed is functional


@pytest.mark.parametrize("name", ["lexicographic", "taylor_hood", "permuted",
                                  "power_interleaved", "entity_blocked"])
def test_composite_interpolate_matches(name):
    js, ts = _trees(jpt, 2, 3)[name], _trees(tpt, 2, 3)[name]

    def funcs(space, lib):
        sin = np.sin if lib is np else torch.sin
        f = [lambda p, k=k: sin((k + 1) * p[:, 0]) + p[:, 1] ** (k + 1)
             for k in range(len(space.leaves))]
        if name == "permuted":
            return f[0]
        if name == "power_interleaved":
            return lambda p: (np.stack if lib is np else torch.stack)(
                [g(p) for g in f], -1)
        if name in ("taylor_hood", "entity_blocked"):
            return (lambda p: (np.stack if lib is np else torch.stack)([f[0](p), f[1](p)], -1),
                    f[2])
        return tuple(f)

    xj = np.asarray(js.interpolate(funcs(js, np)))
    xt = ts.interpolate(funcs(ts, torch), dtype=F64).numpy()
    assert _rel(xt, xj) <= 1e-14


def test_chunked_descriptor():
    """tests/test_orderings.py:test_chunked_descriptor on the port."""
    V = tpt.FunctionSpace(tpt.StructuredMesh([0, 0], [1, 1], (3, 3)), tpt.QkFEM(1, 2))
    W = tpt.CompositeSpace(V, V, ordering="interleaved", chunk=2)
    assert W.nchunks == V.ndofs
    assert W.block_view(torch.arange(2.0 * V.ndofs)).shape == (V.ndofs, 2)
    with pytest.raises(ValueError):
        tpt.CompositeSpace(V, V, ordering="interleaved", chunk=3)
    V2 = tpt.FunctionSpace(tpt.StructuredMesh([0, 0], [1, 1], (3, 3)), tpt.QkFEM(1, 2))
    with pytest.raises(ValueError):
        tpt.CompositeSpace(V, V2, ordering="entity_blocked")


def test_composite_constraints_match():
    js, ts = _trees(jpt, 2, 4)["taylor_hood"], _trees(tpt, 2, 4)["taylor_hood"]

    def left(x):
        return x[:, 0] < 1e-10

    for bc in [(True, None), (left, True), ((True, left), None), True, None]:
        np.testing.assert_array_equal(tpt.constraints(bc, ts).mask_np,
                                      jpt.constraints(bc, js).mask_np)
    for pin in (True, False):
        np.testing.assert_array_equal(stokes_constraints(ts, pin_pressure=pin).mask_np,
                                      j_stokes_constraints(js, pin_pressure=pin).mask_np)
    eb_j, eb_t = _trees(jpt, 2, 3)["entity_blocked"], _trees(tpt, 2, 3)["entity_blocked"]
    np.testing.assert_array_equal(tpt.constraints(((True, left), True), eb_t).mask_np,
                                  jpt.constraints(((True, left), True), eb_j).mask_np)


def test_index_scatter_matches_index_add():
    """The transpose-map scatter equals the index_add sum (1e-14) and is
    bit-equal from call to call; padding slots add nothing."""
    rng = np.random.default_rng(11)
    n = 500
    dofs = rng.integers(0, n - 7, size=(300, 9))             # repeats; 7 DOFs untouched
    dm = IndexDofMap(dofs)
    r = torch.from_numpy(rng.standard_normal(n))
    loc = torch.from_numpy(rng.standard_normal(dofs.shape))
    got = dm.scatter_add(r, loc)
    want = r.index_add(0, torch.from_numpy(dofs).reshape(-1), loc.reshape(-1))
    assert _rel(got.numpy(), want.numpy()) <= 1e-14
    assert torch.equal(got[n - 7:], r[n - 7:])
    assert torch.equal(got, dm.scatter_add(r, loc))
    # a fresh map on the same indices gives the same bits
    assert torch.equal(got, IndexDofMap(dofs).scatter_add(r, loc))
    # forward-mode derivative of the scatter is the scatter of the tangent
    _, jz = torch.func.jvp(lambda v: dm.scatter_add(r, v), (loc,), (loc,))
    assert torch.equal(jz, dm.scatter_add(torch.zeros_like(r), loc))


class _VecPoissonJ(JLocalOperator):
    """-lap u_c + c u_c = 1 per component (tests/test_orderings.py:132)."""
    is_linear = True

    def alpha_volume(self, ctx, u):
        us = u if isinstance(u, tuple) else (u,)
        out = tuple(self.accumulate_gradient(t, ctx.factor, self.gradient_at_qp(t, ui))
                    + (k + 1) * self.accumulate_value(t, ctx.factor, self.value_at_qp(t, ui))
                    for k, (t, ui) in enumerate(zip(ctx.tabs, us)))
        return out if isinstance(u, tuple) else out[0]

    def lambda_volume(self, ctx):
        one = jnp.sin(ctx.x[..., 0]) + 1.0
        out = tuple(self.accumulate_value(t, ctx.factor, -one) for t in ctx.tabs)
        return out if len(out) > 1 else out[0]


class _VecPoissonT(TLocalOperator):
    is_linear = True

    def alpha_volume(self, ctx, u):
        us = u if isinstance(u, tuple) else (u,)
        out = tuple(self.accumulate_gradient(t, ctx.factor, self.gradient_at_qp(t, ui))
                    + (k + 1) * self.accumulate_value(t, ctx.factor, self.value_at_qp(t, ui))
                    for k, (t, ui) in enumerate(zip(ctx.tabs, us)))
        return out if isinstance(u, tuple) else out[0]

    def lambda_volume(self, ctx):
        one = torch.sin(ctx.x[..., 0]) + 1.0
        out = tuple(self.accumulate_value(t, ctx.factor, -one) for t in ctx.tabs)
        return out if len(out) > 1 else out[0]


@pytest.mark.parametrize("name", ["interleaved", "permuted", "entity_blocked_ordering",
                                  "power_interleaved"])
def test_index_path_residual_matches_jax(name):
    """Composite spaces whose leaves are not contiguous take IndexDofMap;
    residual, J.v and the diagonal equal the JAX package's (1e-13)."""
    js, ts = _trees(jpt, 2, 4)[name], _trees(tpt, 2, 4)[name]
    cj, ct = jpt.constraints(True, js), tpt.constraints(True, ts)
    jgo = jpt.GridOperator(js, _VecPoissonJ(), constraints=cj)
    tgo = tpt.GridOperator(ts, _VecPoissonT(), constraints=ct)
    assert all(isinstance(dm, IndexDofMap) for dm in tgo.dof_maps)
    rng = np.random.default_rng(5)
    x, z = rng.standard_normal(ts.ndofs), rng.standard_normal(ts.ndofs)
    xt, zt = torch.from_numpy(x), torch.from_numpy(z)
    r = tgo.residual(xt)
    assert _rel(r.numpy(), jgo.residual(jnp.asarray(x))) <= 1e-13
    assert torch.equal(r, tgo.residual(xt))                 # one result per run
    assert _rel(tgo.jacobian_apply(xt, zt).numpy(),
                jgo.jacobian_apply(jnp.asarray(x), jnp.asarray(z))) <= 1e-13
    assert _rel(tgo.jacobian_diagonal(xt).numpy(),
                jgo.jacobian_diagonal(jnp.asarray(x))) <= 1e-13
    assert _rel(tgo.jacobian(xt).to_dense().numpy(),
                np.asarray(jgo.jacobian(jnp.asarray(x)).todense())) <= 1e-13


def test_contiguous_leaves_take_fast_paths():
    """Lexicographic C0 leaves stay on strided slices; a DG leaf inside a
    composite space takes the reshape map and slab face transfers (the
    JAX package's dofmaps.py:152-161 branch)."""
    mesh = tpt.StructuredMesh([0, 0], [1, 1], (3, 2))
    dg = tpt.FunctionSpace(mesh, tpt.QkDGFEM(2, 2))
    dgp = tpt.FunctionSpace(mesh, tpt.QkDGFEM(1, 2))
    W = tpt.CompositeSpace(tpt.PowerSpace(dg, 2), dgp)

    class Faces(TLocalOperator):
        def alpha_skeleton(self, ctx, ui, uo):
            ri = tuple(self.accumulate_value(t, ctx.factor, self.value_at_qp(t, a))
                       for t, a in zip(ctx.tabs_in, ui))
            return ri, tuple(torch.zeros_like(a) for a in uo)

    go = tpt.GridOperator(W, Faces())
    assert all(isinstance(dm, ReshapeDofMap) for dm in go.dof_maps)
    assert all(isinstance(tr, SlabFaceTransfer) for g in go.skel_groups for tr in g.trs_in)
    th = _trees(tpt, 2, 3)["taylor_hood"]
    go = tpt.GridOperator(th, _VecPoissonT())
    assert all(isinstance(dm, SlicedDofMap) for dm in go.dof_maps)
    assert [dm.offset for dm in go.dof_maps] == [0, 49, 98]


class _P:
    """tests/test_orderings.py P, for both packages."""

    @staticmethod
    def j():
        class P(JProblem):
            def f(self, x):
                return 5 * np.pi**2 * jnp.sin(np.pi * x[..., 0]) * jnp.cos(2 * np.pi * x[..., 1])

            def g(self, x):
                return jnp.sin(np.pi * x[..., 0]) * jnp.cos(2 * np.pi * x[..., 1]) + x[..., 0]
        return P()

    @staticmethod
    def t():
        class P(TProblem):
            def f(self, x):
                return (5 * np.pi**2 * torch.sin(np.pi * x[..., 0])
                        * torch.cos(2 * np.pi * x[..., 1]))

            def g(self, x):
                return (torch.sin(np.pi * x[..., 0]) * torch.cos(2 * np.pi * x[..., 1])
                        + x[..., 0])
        return P()


def _solve_t(space, p):
    cgm = tpt.constraints(p.dirichlet_bctype(), space)
    go = tpt.GridOperator(space, TFEM(p), constraints=cgm)
    x0 = tpt.interpolate_dirichlet(p.g, space, cgm, space.zero(F64))
    slp = tpt.StationaryLinearProblemSolver(go, SEQ_CG_Jacobi(), reduction=1e-12, verbose=0)
    x = slp.apply(x0)
    assert slp.result.converged
    return x, slp.result.linear_solver_iterations


@pytest.mark.parametrize("kind", ["reverse", "random"])
def test_permuted_solve_matches(kind):
    """tests/test_orderings.py:test_permuted_solve_matches on the port (8^2),
    and the permuted solution against the JAX package's."""
    mesh = tpt.StructuredMesh([0, 0], [1, 1], (8, 8))
    V = tpt.FunctionSpace(mesh, tpt.QkFEM(1, 2))
    x_ref, it_ref = _solve_t(V, _P.t())
    perm = (np.arange(V.ndofs)[::-1].copy() if kind == "reverse"
            else np.random.default_rng(0).permutation(V.ndofs))
    W = tpt.PermutedSpace(V, perm)
    x_perm, it_perm = _solve_t(W, _P.t())
    assert it_perm == it_ref
    assert float(torch.linalg.norm(W.restrict(x_perm) - x_ref)) < 1e-9
    pj = _P.j()
    Wj = jpt.PermutedSpace(jpt.FunctionSpace(jpt.StructuredMesh([0, 0], [1, 1], (8, 8)),
                                             jpt.QkFEM(1, 2)), perm)
    cj = jpt.constraints(pj.dirichlet_bctype(), Wj)
    goj = jpt.GridOperator(Wj, JFEM(pj), constraints=cj)
    x0 = jpt.interpolate_dirichlet(lambda q: np.asarray(pj.g(jnp.asarray(q))), Wj, cj,
                                   Wj.zero())
    slp = jpt.StationaryLinearProblemSolver(goj, J_CG_Jacobi(), reduction=1e-12, verbose=0)
    xj = slp.apply(x0)
    assert slp.result.linear_solver_iterations == it_perm
    assert _rel(x_perm.numpy(), xj) <= 1e-12


def test_entity_blocked_vector_solve():
    """tests/test_orderings.py:test_entity_blocked_poisson_vector_solve on
    the port: vector Poisson on the entity-blocked layout equals the
    per-component solves and the JAX package's solution."""
    def run(pkg, op, backend, zero):
        mesh = pkg.StructuredMesh([0, 0], [1, 1], (6, 6))
        V = pkg.FunctionSpace(mesh, pkg.QkFEM(1, 2))
        W = pkg.entity_blocked(pkg.CompositeSpace(V, V))
        go = pkg.GridOperator(W, op, constraints=pkg.constraints((True, True), W))
        slp = pkg.StationaryLinearProblemSolver(go, backend, reduction=1e-12, verbose=0)
        return W, slp.apply(zero(W)), slp.result.linear_solver_iterations

    W, xt, it_t = run(tpt, _VecPoissonT(), SEQ_CG_Jacobi(maxiter=5000),
                      lambda W: W.zero(F64))
    _, xj, it_j = run(jpt, _VecPoissonJ(), J_CG_Jacobi(maxiter=5000), lambda W: W.zero())
    assert it_t == it_j
    assert _rel(xt.numpy(), xj) <= 1e-12
    inner = W.restrict(xt)
    n = W.children[0].ndofs // 2
    # components differ only by their reaction coefficient (1 vs 2)
    assert float(inner[:n].abs().max()) > float(inner[n:].abs().max()) > 0.0
