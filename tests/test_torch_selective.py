"""Selective assembly (skip_entity / skip_intersection) of the port against
the JAX package (fp64, CPU).

The seven problems of tests/test_selective.py run on both packages: the
reference test's own assertions hold on the port, and the port's residual,
jacobian_apply, assembled jacobian and jacobian_diagonal equal the JAX
package's within 1e-12 of their largest entry. The DWR localisation
invariant (sum of the element indicators = w . r) holds to 1e-11.

Beyond the reference's uniform 2D cases, the masks are held against the JAX
package on every kind of face group: periodic and mapped structured
groups, simplex groups, and a composite (Taylor-Hood) space; and
GridOperator.with_operator rebuilds them for a selective operator.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

import dune_pdelab_tpu as jpt
import dune_pdelab_tpu_torch as tpt
from dune_pdelab_tpu.fe import PkDGFEM as JPkDG
from dune_pdelab_tpu.fe import QkDGFEM as JQkDG
from dune_pdelab_tpu.mesh import SimplexMesh as JSimplex
from dune_pdelab_tpu.ops import ConvectionDiffusionFEM as JFEM
from dune_pdelab_tpu.ops import ConvectionDiffusionProblem as JProblem
from dune_pdelab_tpu.ops.convectiondiffusiondg import ConvectionDiffusionDG as JDG
from dune_pdelab_tpu.ops.stokes import NavierStokesParameters as JNSP
from dune_pdelab_tpu.ops.stokes import TaylorHoodNavierStokes as JTH
from dune_pdelab_tpu.solvers.stokes import taylor_hood_space as j_th_space
from dune_pdelab_tpu_torch.ops import ConvectionDiffusionDG as TDG
from dune_pdelab_tpu_torch.ops import ConvectionDiffusionFEM as TFEM
from dune_pdelab_tpu_torch.ops import ConvectionDiffusionProblem as TProblem
from dune_pdelab_tpu_torch.ops.stokes import NavierStokesParameters as TNSP
from dune_pdelab_tpu_torch.ops.stokes import TaylorHoodNavierStokes as TTH
from dune_pdelab_tpu_torch.solvers.stokes import taylor_hood_space as t_th_space
from dune_pdelab_tpu_torch.utils.common import set_default_device

pytestmark = pytest.mark.fast
torch.set_num_threads(1)
set_default_device("cpu")
F64 = torch.float64
REL = 1e-12


class JProb(JProblem):
    def A(self, x):
        return 1.0 + x[..., 0]

    def c(self, x):
        return 0.5

    def f(self, x):
        return jnp.sin(3 * x[..., 0]) + x[..., 1]

    def bctype(self, x):
        return jnp.where(x[..., 0] < 1e-12, 1, 0)   # Dirichlet left only

    def g(self, x):
        return x[..., 1]

    def j(self, x):
        return 0.3


class TProb(TProblem):
    def A(self, x):
        return 1.0 + x[..., 0]

    def c(self, x):
        return 0.5

    def f(self, x):
        return torch.sin(3 * x[..., 0]) + x[..., 1]

    def bctype(self, x):
        return 1 * (x[..., 0] < 1e-12)   # numpy or torch

    def g(self, x):
        return x[..., 1]

    def j(self, x):
        return 0.3


def _left(base):
    class Left(base):
        def skip_entity(self, centers):
            return centers[..., 0] >= 0.5
    return Left


def _right(base):
    class Right(base):
        def skip_entity(self, centers):
            return centers[..., 0] < 0.5
    return Right


def _cut(base, pred):
    class Cut(base):
        def skip_intersection(self, mids):
            return pred(mids)
    return Cut


def _both(base):
    """Skips elements with centre y > 0.7 and faces with midpoint x < 0.3."""
    class Both(base):
        def skip_entity(self, centers):
            return centers[..., 1] > 0.7

        def skip_intersection(self, mids):
            return mids[..., 0] < 0.3
    return Both


def _vec(n, seed=3):
    return np.random.default_rng(seed).standard_normal(n)


def _np(a):
    if isinstance(a, torch.Tensor):
        return (a.to_dense() if a.is_sparse else a).numpy()
    return np.asarray(a.todense() if hasattr(a, "todense") else a)


def _close(got, want, rel=REL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * max(np.abs(want).max(), 1e-300)


def _dg_pair(n=8, k=1):
    return (jpt.FunctionSpace(jpt.StructuredMesh([0, 0], [1, 1], (n, n)), JQkDG(k, 2)),
            tpt.FunctionSpace(tpt.StructuredMesh([0, 0], [1, 1], (n, n)), tpt.QkDGFEM(k, 2)))


def _ops(jV, tV, jlop, tlop, jcg=None, tcg=None):
    return (jpt.GridOperator(jV, jlop, constraints=jcg),
            tpt.GridOperator(tV, tlop, constraints=tcg))


def _parity(jgo, tgo, seed=3, full=True):
    """Residual and J.v at a random point, and (full) the assembled
    jacobian and its diagonal, against the JAX package. Returns the port's
    residual at x."""
    x = _vec(jgo.space.ndofs, seed)
    z = _vec(jgo.space.ndofs, seed + 1)
    jx, tx = jnp.asarray(x), torch.as_tensor(x, dtype=F64)
    jz, tz = jnp.asarray(z), torch.as_tensor(z, dtype=F64)
    r = tgo.residual(tx)
    _close(r, jgo.residual(jx))
    _close(tgo.jacobian_apply(tx, tz), jgo.jacobian_apply(jx, jz))
    if full:
        _close(tgo.jacobian(tx), jgo.jacobian(jx))
        _close(tgo.jacobian_diagonal(tx), jgo.jacobian_diagonal(jx))
    return r


def test_skip_entity_cg_complementary_sum():
    """CG FEM (boundary lambda terms, no skeleton): left + right == full, and
    each half equals the JAX package's."""
    jV = jpt.FunctionSpace(jpt.StructuredMesh([0, 0], [1, 1], (8, 8)), jpt.QkFEM(1, 2))
    tV = tpt.FunctionSpace(tpt.StructuredMesh([0, 0], [1, 1], (8, 8)), tpt.QkFEM(1, 2))
    jcg = jpt.constraints(JProb().dirichlet_bctype(), jV)
    tcg = tpt.constraints(TProb().dirichlet_bctype(), tV)
    x = torch.as_tensor(_vec(tV.ndofs), dtype=F64)
    r_full = tpt.GridOperator(tV, TFEM(TProb()), constraints=tcg).residual(x)
    rl = _parity(*_ops(jV, tV, _left(JFEM)(JProb()), _left(TFEM)(TProb()), jcg, tcg),
                 full=False)
    rr = tpt.GridOperator(tV, _right(TFEM)(TProb()), constraints=tcg).residual(x)
    assert float((rl + rr - r_full).abs().max()) < 1e-12


def test_skip_entity_dg_zero_rows_and_interface():
    """DG: rows of elements deep in the skipped half vanish; the
    complementary sum misses exactly the interface skeleton faces."""
    jV, tV = _dg_pair()
    mesh = tV.mesh
    x = torch.as_tensor(_vec(tV.ndofs), dtype=F64)
    r_full = tpt.GridOperator(tV, TDG(TProb())).residual(x)
    rl = _parity(*_ops(jV, tV, _left(JDG)(JProb()), _left(TDG)(TProb())), full=False)
    rr = tpt.GridOperator(tV, _right(TDG)(TProb())).residual(x)
    centers = mesh.element_centers()
    nb = tV.fem.nbasis
    deep_right = np.flatnonzero(centers[:, 0] > 0.5 + 1.0 / 8)
    assert np.abs(rl.numpy().reshape(mesh.nelements, nb)[deep_right]).max() == 0.0
    diff = (rl + rr - r_full).numpy().reshape(mesh.nelements, nb)
    touched = np.flatnonzero(np.abs(diff).max(axis=1) > 1e-13)
    assert set(touched) == {int(e) for e in np.flatnonzero(
        np.abs(np.abs(centers[:, 0] - 0.5) - 0.5 / 8) < 1e-12)}


def test_skip_intersection_partition_identity():
    """Skeleton faces split by midpoint: r_A + r_B == r_full + r_none."""
    jV, tV = _dg_pair(6)
    x = torch.as_tensor(_vec(tV.ndofs), dtype=F64)

    def go(pred):
        return tpt.GridOperator(tV, _cut(TDG, pred)(TProb()))

    r_full = tpt.GridOperator(tV, TDG(TProb())).residual(x)
    r_a = _parity(*_ops(jV, tV, _cut(JDG, lambda m: m[..., 0] >= 0.5)(JProb()),
                        _cut(TDG, lambda m: m[..., 0] >= 0.5)(TProb())), full=False)
    r_b = go(lambda m: m[..., 0] < 0.5).residual(x)
    r_none = go(lambda m: torch.ones(m.shape[:-1], dtype=torch.bool)).residual(x)
    assert float((r_a + r_b - (r_full + r_none)).abs().max()) < 1e-12
    assert float((r_none - r_full).abs().max()) > 1e-6


def test_selective_dwr_localization_invariant():
    """sum_K eta_K == w . r(x) under selective assembly; eta equals the JAX
    package's."""
    jV, tV = _dg_pair(6)
    jgo, tgo = _ops(jV, tV, _left(JDG)(JProb()), _left(TDG)(TProb()))
    x, w = _vec(tV.ndofs), _vec(tV.ndofs, 7)
    tx, tw = torch.as_tensor(x, dtype=F64), torch.as_tensor(w, dtype=F64)
    eta = tgo.weighted_element_residuals(tx, tw)
    _close(eta, jgo.weighted_element_residuals(jnp.asarray(x), jnp.asarray(w)))
    rhs = float(tw @ tgo.residual(tx))
    assert abs(float(eta.sum()) - rhs) < 1e-11 * max(1.0, abs(rhs))


def test_skip_entity_jacobian_apply_consistent():
    """The jvp path inherits the masks (linear operator: J z == r(z) - r(0))."""
    _, tV = _dg_pair(6)
    go = tpt.GridOperator(tV, _left(TDG)(TProb()))
    z = torch.as_tensor(_vec(tV.ndofs), dtype=F64)
    zero = torch.zeros_like(z)
    rz = go.residual(z) - go.residual(zero)
    assert float((go.jacobian_apply(zero, z) - rz).abs().max()) < 1e-12


def test_selective_jacobian_matches_jacobian_apply():
    """The assembled jacobian, its diagonal and the element diagonal blocks
    are derivatives of the masked residual, and equal the JAX package's."""
    jV, tV = _dg_pair(6)
    jgo, tgo = _ops(jV, tV, _left(JDG)(JProb()), _left(TDG)(TProb()))
    _parity(jgo, tgo)
    x = torch.zeros(tV.ndofs, dtype=F64)
    z = torch.as_tensor(_vec(tV.ndofs), dtype=F64)
    J = tgo.jacobian(x)
    assert float((J @ z - tgo.jacobian_apply(x, z)).abs().max()) < 1e-11
    np.testing.assert_allclose(tgo.jacobian_diagonal(x).numpy(),
                               np.diag(J.to_dense().numpy()), atol=1e-11)
    blocks = tgo.element_diagonal_blocks(x)
    skipped = torch.as_tensor(tV.mesh.element_centers()[:, 0] >= 0.5)
    assert float(blocks[skipped].abs().max()) == 0.0
    assert float(blocks[~skipped].abs().max()) > 1e-6


def test_skip_intersection_masks_boundary_faces():
    """skip_intersection masks boundary faces too (reference:
    default/assembler.hh:161)."""
    jV, tV = _dg_pair(6)

    def right_bnd(m):
        return m[..., 0] > 1.0 - 1e-9

    x = torch.as_tensor(_vec(tV.ndofs), dtype=F64)
    r_full = tpt.GridOperator(tV, TDG(TProb())).residual(x)
    jgo, tgo = _ops(jV, tV, _cut(JDG, right_bnd)(JProb()), _cut(TDG, right_bnd)(TProb()))
    r_skip = _parity(jgo, tgo)
    assert float((r_full - r_skip).abs().max()) > 1e-8
    zero = torch.zeros(tV.ndofs, dtype=F64)
    z = torch.as_tensor(_vec(tV.ndofs, 9), dtype=F64)
    assert float((tgo.jacobian(zero) @ z - tgo.jacobian_apply(zero, z)).abs().max()) < 1e-11


def _meshes(kind):
    if kind == "periodic":
        args = ([0, 0], [1, 1], (5, 4)), dict(periodic=(True, False))
        return jpt.StructuredMesh(*args[0], **args[1]), tpt.StructuredMesh(*args[0], **args[1])
    if kind == "mapped":
        c = np.stack(np.meshgrid(0.5 + np.arange(6) / 5, 0.5 * np.pi * np.arange(5) / 4,
                                 indexing="xy"), -1).reshape(-1, 2)
        coords = np.stack([c[:, 0] * np.cos(c[:, 1]), c[:, 0] * np.sin(c[:, 1])], -1)
        args = ([0, 0], [1, 1], (5, 4)), dict(coords=coords)
        return jpt.StructuredMesh(*args[0], **args[1]), tpt.StructuredMesh(*args[0], **args[1])
    return (JSimplex.from_structured(jpt.StructuredMesh([0, 0], [1, 1], (4, 4))),
            tpt.SimplexMesh.from_structured(tpt.StructuredMesh([0, 0], [1, 1], (4, 4))))


@pytest.mark.parametrize("kind", ["periodic", "mapped", "simplex"])
def test_face_groups_take_both_masks(kind):
    """skip_entity and skip_intersection together on periodic, mapped and
    simplex face groups (boundary and skeleton): equal to the JAX package."""
    jm, tm = _meshes(kind)
    if kind == "simplex":
        jV, tV = jpt.FunctionSpace(jm, JPkDG(1, 2)), tpt.FunctionSpace(tm, tpt.PkDGFEM(1, 2))
    else:
        jV, tV = jpt.FunctionSpace(jm, JQkDG(1, 2)), tpt.FunctionSpace(tm, tpt.QkDGFEM(1, 2))
    jgo, tgo = _ops(jV, tV, _both(JDG)(JProb()), _both(TDG)(TProb()))
    assert tgo._sel_elem is not None
    assert any(w is not None for w in tgo._sel_bnd + tgo._sel_skel)
    _parity(jgo, tgo, full=False)


def test_composite_space_and_with_operator():
    """A Taylor-Hood space with skip_entity equals the JAX package's;
    with_operator rebuilds the masks for a selective operator and drops
    them for a plain one."""
    jW = j_th_space(jpt.StructuredMesh([0, 0], [1, 1], (4, 4)), 2)
    tW = t_th_space(tpt.StructuredMesh([0, 0], [1, 1], (4, 4)), 2)
    jgo, tgo = _ops(jW, tW, _left(JTH)(JNSP()), _left(TTH)(TNSP()))
    _parity(jgo, tgo, full=False)
    plain = tpt.GridOperator(tW, TTH(TNSP()))
    assert plain._sel_elem is None
    sel = plain.with_operator(_left(TTH)(TNSP()))
    assert sel._sel_elem is not None and plain._sel_elem is None
    x = torch.as_tensor(_vec(tW.ndofs), dtype=F64)
    _close(sel.residual(x), tgo.residual(x), rel=0.0)
    assert sel.with_operator(TTH(TNSP()))._sel_elem is None
