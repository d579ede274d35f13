"""H(div) elements, spaces and the mixed Darcy operator of the port against
the JAX package (fp64, CPU).

Tolerances: tabulations (values and divergences) 1e-14 absolute at seeded
random points; DOF maps, orientation signs and boundary masks exactly
equal; DiffusionMixed residual and J.v 1e-12 relative on each card-vs-CPU
case of chip_smoke phase 14f at 4^2 (2^3 in 3D); pressure errors of the
live reference solves 1e-6 relative. The reference's tests
(tests/test_mixed.py, test_hdiv_simplex.py, test_rt_higher.py, the RT1
tests of test_fe_zoo.py and test_fe_zoo_r3.py, the two mixed tests of
test_mapped.py, the H(div) and mimetic cases of test_fem_sweep.py) run on
the port with their own bounds and sizes; where a test solves, the JAX
package solves the same problem here and the errors are compared.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

import dune_pdelab_tpu as jpt
import dune_pdelab_tpu_torch as tpt
from dune_pdelab_tpu.fe import P0FEM as JP0, PkDGFEM as JPkDG, QkDGFEM as JQkDG
from dune_pdelab_tpu.fe import hdiv as jhdiv
from dune_pdelab_tpu.fe.mimetic import MimeticFEM as JMimetic
from dune_pdelab_tpu.mesh import SimplexMesh as JSimplexMesh
from dune_pdelab_tpu.ops import ConvectionDiffusionProblem as JProblem
from dune_pdelab_tpu.ops.diffusionmixed import DiffusionMixed as JDiffusionMixed
from dune_pdelab_tpu.solvers import LinearSolverBackend as JBackend
from dune_pdelab_tpu.solvers.stationary import (
    StationaryLinearProblemSolver as JStationary,
)
from dune_pdelab_tpu.space.functions import l2_difference as j_l2_difference
from dune_pdelab_tpu_torch.fe import P0FEM, PkDGFEM, QkDGFEM, gauss_legendre, quadrature_rule
from dune_pdelab_tpu_torch.fe import hdiv
from dune_pdelab_tpu_torch.fe.mimetic import MimeticFEM
from dune_pdelab_tpu_torch.mesh import SimplexMesh
from dune_pdelab_tpu_torch.ops import ConvectionDiffusionProblem, DiffusionMixed
from dune_pdelab_tpu_torch.solvers import LinearSolverBackend, StationaryLinearProblemSolver
from dune_pdelab_tpu_torch.space.functions import l2_difference
from dune_pdelab_tpu_torch.utils.common import set_default_device

pytestmark = pytest.mark.fast
torch.set_num_threads(1)
set_default_device("cpu")
F64 = torch.float64
PKG = {"jax": (jpt, JSimplexMesh), "torch": (tpt, SimplexMesh)}


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _m(x):
    """The array module of x: torch for tensors, jax.numpy else."""
    return torch if isinstance(x, torch.Tensor) else jnp


def _zeros(x):
    return 0.0 * x[..., 0]


class _Sin(ConvectionDiffusionProblem):
    """-div grad p = f, p = sin(pi x) sin(pi y), full Dirichlet (the
    reference tests' P)."""

    def p_exact(self, q):
        return np.sin(np.pi * q[:, 0]) * np.sin(np.pi * q[:, 1])

    def f(self, x):
        m = _m(x)
        return 2 * np.pi**2 * m.sin(np.pi * x[..., 0]) * m.sin(np.pi * x[..., 1])

    def g(self, x):
        return _zeros(x)


class _JSin(JProblem):
    p_exact = _Sin.p_exact
    f = _Sin.f
    g = _Sin.g


class _Sin3(ConvectionDiffusionProblem):
    """tests/test_fe_zoo_r3.py P3."""

    def p_exact(self, q):
        return np.sin(np.pi * q[:, 0]) * np.sin(np.pi * q[:, 1]) * np.sin(np.pi * q[:, 2])

    def f(self, x):
        m = _m(x)
        return 3 * np.pi**2 * (m.sin(np.pi * x[..., 0]) * m.sin(np.pi * x[..., 1])
                               * m.sin(np.pi * x[..., 2]))

    def g(self, x):
        return _zeros(x)


class _JSin3(JProblem):
    p_exact = _Sin3.p_exact
    f = _Sin3.f
    g = _Sin3.g


class _Varied(ConvectionDiffusionProblem):
    """A field K, a source and Dirichlet data for the operator parity."""

    def A(self, x):
        return 1.0 + 0.5 * x[..., 0] + 0.25 * x[..., 1] ** 2

    def f(self, x):
        m = _m(x)
        return m.sin(3 * x[..., 0]) * m.cos(2 * x[..., 1])

    def g(self, x):
        return x[..., 0] ** 2 - x[..., 1] + 0.5


class _JVaried(JProblem):
    A = _Varied.A
    f = _Varied.f
    g = _Varied.g


class _Harmonic(ConvectionDiffusionProblem):
    """tests/test_mapped.py Harmonic with p_exact."""

    def p_exact(self, q):
        return q[:, 0] ** 2 - q[:, 1] ** 2

    def g(self, x):
        return x[..., 0] ** 2 - x[..., 1] ** 2


class _JHarmonic(JProblem):
    p_exact = _Harmonic.p_exact
    g = _Harmonic.g

    def f(self, x):
        return jnp.zeros(x.shape[:-1])


def _annulus(pkg, n):
    """tests/test_mapped.py annulus: the quarter annulus 1 <= r <= 2."""
    idx = np.arange((n + 1) * (n + 1))
    r = 1.0 + (idx % (n + 1)) / n
    th = 0.5 * np.pi * (idx // (n + 1)) / n
    return PKG[pkg][0].StructuredMesh([0, 0], [1, 1], (n, n),
                                      coords=np.stack([r * np.cos(th), r * np.sin(th)], axis=-1))


def _mesh(pkg, kind, n, dim=2, periodic=None):
    mod, Simplex = PKG[pkg]
    if kind == "mapped":
        return _annulus(pkg, n)
    m = mod.StructuredMesh([0] * dim, [1] * dim, (n,) * dim, periodic=periodic)
    return Simplex.from_structured(m) if kind == "simplex" else m


# (element name, args, pressure element (jax, torch), dim, mesh kind)
MIXED = {
    "RT0Cube": (("RT0Cube", (2,)), (lambda: JP0(2), lambda: P0FEM(2)), 2, "cube"),
    "BDM1Cube": (("BDM1Cube", (2,)), (lambda: JP0(2), lambda: P0FEM(2)), 2, "cube"),
    "RT1Cube2D": (("RT1Cube2D", ()), (lambda: JQkDG(1, 2), lambda: QkDGFEM(1, 2)), 2, "cube"),
    "RT2Cube2D": (("RT2Cube2D", ()), (lambda: JQkDG(2, 2), lambda: QkDGFEM(2, 2)), 2, "cube"),
    "RT0Simplex2D": (("RT0Simplex2D", ()), (lambda: JP0(2, geometry="simplex"),
                                            lambda: P0FEM(2, geometry="simplex")), 2, "simplex"),
    "BDM1Simplex2D": (("BDM1Simplex2D", ()), (lambda: JP0(2, geometry="simplex"),
                                              lambda: P0FEM(2, geometry="simplex")), 2, "simplex"),
    "RT1Simplex2D": (("RT1Simplex2D", ()), (lambda: JPkDG(1, 2), lambda: PkDGFEM(1, 2)),
                     2, "simplex"),
    "RT0Simplex3D": (("RT0Simplex3D", ()), (lambda: JP0(3, geometry="simplex"),
                                            lambda: P0FEM(3, geometry="simplex")), 3, "simplex"),
    "RTkCube3D": (("RTkCube3D", (1,)), (lambda: JQkDG(1, 3), lambda: QkDGFEM(1, 3)), 3, "cube"),
    "RT0Cube-mapped": (("RT0Cube", (2,)), (lambda: JP0(2), lambda: P0FEM(2)), 2, "mapped"),
}


def _mixed_space(pkg, case, n, periodic=None):
    (name, args), pels, dim, kind = MIXED[case]
    mod = PKG[pkg][0]
    mesh = _mesh(pkg, kind, n, dim, periodic)
    el = getattr(jhdiv if pkg == "jax" else hdiv, name)(*args)
    Vu = mod.FunctionSpace(mesh, el, name="u")
    Vp = mod.FunctionSpace(mesh, pels[0 if pkg == "jax" else 1](), name="p")
    return mesh, mod.CompositeSpace(Vu, Vp), Vu, Vp


def _solve(pkg, case, n, problem, reduction=1e-11, maxiter=60000):
    """Mixed Darcy with unpreconditioned MINRES, as the reference tests
    solve it; returns (mesh, W, Vp, x, converged, go)."""
    mesh, W, Vu, Vp = _mixed_space(pkg, case, n)
    if pkg == "jax":
        go = jpt.GridOperator(W, JDiffusionMixed(problem))
        slp = JStationary(go, JBackend(solver="minres", precond="none", maxiter=maxiter),
                          reduction=reduction, verbose=0)
        x = slp.apply(W.zero())
    else:
        go = tpt.GridOperator(W, DiffusionMixed(problem))
        slp = StationaryLinearProblemSolver(
            go, LinearSolverBackend(solver="minres", precond="none", maxiter=maxiter),
            reduction=reduction, verbose=0)
        x = slp.apply(W.zero(dtype=F64))
    return mesh, W, Vp, x, bool(slp.result.converged), go


def _center_error(pkg, case, n, problem):
    mesh, W, Vp, x, ok, _ = _solve(pkg, case, n, problem)
    assert ok
    xp = np.asarray(W.restrict(x, 1))
    return float(np.sqrt(np.mean((xp - problem.p_exact(mesh.element_centers())) ** 2)))


def _l2_error(pkg, case, n, problem, reduction):
    mesh, W, Vp, x, ok, _ = _solve(pkg, case, n, problem, reduction)
    assert ok
    l2 = j_l2_difference if pkg == "jax" else l2_difference
    return float(l2(Vp, W.restrict(x, 1), problem.p_exact))


# ---------------------------------------------------------------- elements
ELEMENTS = [("RT0Cube", (2,)), ("RT0Cube", (3,)), ("BDM1Cube", (2,)),
            ("RT0Simplex2D", ()), ("RT0Simplex3D", ()), ("BDM1Simplex2D", ()),
            ("RT1Cube2D", ()), ("RTkCube2D", (1,)), ("RTkCube2D", (2,)),
            ("RTkCube2D", (3,)), ("RT2Cube2D", ()), ("RTkCube3D", (1,)),
            ("RT1Cube3D", ()), ("RT1Simplex2D", ())]


def _ref_points(el, n=17, seed=0):
    rng = np.random.default_rng(seed)
    pts = rng.random((4 * n, el.dim))
    if el.geometry == "simplex":
        pts = pts[pts.sum(axis=1) <= 1.0]
    return pts[:n]


@pytest.mark.parametrize("name,args", ELEMENTS, ids=[f"{n}{a}" for n, a in ELEMENTS])
def test_tabulations_match_reference(name, args):
    """tabulate_vector and tabulate_div of every H(div) element against
    the JAX package's at seeded random points inside the element."""
    el, ref = getattr(hdiv, name)(*args), getattr(jhdiv, name)(*args)
    pts = _ref_points(el)
    assert np.abs(el.tabulate_vector(pts) - ref.tabulate_vector(pts)).max() <= 1e-14
    assert np.abs(el.tabulate_div(pts) - ref.tabulate_div(pts)).max() <= 1e-14
    assert (el.nbasis, el.degree) == (ref.nbasis, ref.degree)


MAP_CASES = [(c, p) for c in MIXED for p in ([None, True] if MIXED[c][3] == "cube" else [None])]


@pytest.mark.parametrize("case,periodic", MAP_CASES,
                         ids=[f"{c}-{'periodic' if p else 'plain'}" for c, p in MAP_CASES])
def test_dof_maps_signs_and_masks_match_reference(case, periodic):
    """element_dofs, the simplex orientation signs and the face-lattice
    boundary masks equal the reference's exactly (2D/3D cubes, periodic
    ones, 2D/3D simplices, the mapped annulus)."""
    dim = MIXED[case][2]
    per = None if periodic is None else (True,) + (False,) * (dim - 1)
    n = 3 if dim == 3 else 4
    _, _, Vj, _ = _mixed_space("jax", case, n, per)
    _, _, Vt, _ = _mixed_space("torch", case, n, per)
    assert Vt.ndofs == Vj.ndofs
    assert np.array_equal(Vt.element_dofs, np.asarray(Vj.element_dofs))
    if MIXED[case][3] == "simplex":
        assert np.array_equal(Vt._hdiv_signs, Vj._hdiv_signs)
        with pytest.raises(NotImplementedError):
            Vt.boundary_dof_mask()
    else:
        assert np.array_equal(Vt.boundary_dof_mask(), Vj.boundary_dof_mask())


@pytest.mark.parametrize("case", list(MIXED))
def test_diffusion_mixed_residual_and_jv_match_reference(case):
    """DiffusionMixed residual (with the pressure Dirichlet term) and J.v at
    a seeded random x, z on each phase-14f case: 1e-12 relative."""
    n = 2 if MIXED[case][2] == 3 else 4
    _, Wj, _, _ = _mixed_space("jax", case, n)
    _, Wt, _, _ = _mixed_space("torch", case, n)
    goj = jpt.GridOperator(Wj, JDiffusionMixed(_JVaried()))
    got = tpt.GridOperator(Wt, DiffusionMixed(_Varied()))
    rng = np.random.default_rng(7)
    x, z = rng.standard_normal(Wj.ndofs), rng.standard_normal(Wj.ndofs)
    assert _rel(got.residual(torch.from_numpy(x)), goj.residual(jnp.asarray(x))) < 1e-12
    assert _rel(got.jacobian_apply(torch.from_numpy(x), torch.from_numpy(z)),
                goj.jacobian_apply(jnp.asarray(x), jnp.asarray(z))) < 1e-12


# ------------------------------------------------ tests/test_mixed.py (5)
def test_rt0_flux_duality():
    fem = hdiv.RT0Cube(2)
    xq, wq = gauss_legendre(3)
    for a in range(2):
        for s in (0, 1):
            pts = np.zeros((len(xq), 2))
            pts[:, a] = s
            pts[:, 1 - a] = xq
            flux = np.einsum("q,qb->b", wq, fem.tabulate_vector(pts)[:, :, a])
            expect = np.zeros(4)
            expect[2 * a + s] = 1.0
            assert np.allclose(flux, expect, atol=1e-12)


def test_bdm1_cube_shapes():
    fem = hdiv.BDM1Cube(2)
    assert fem.tabulate_vector(np.array([[0.3, 0.7]])).shape == (1, 8, 2)
    assert fem.tabulate_div(np.random.default_rng(0).random((5, 2))).shape == (5, 8)


def test_mixed_rt0_pressure_superconvergence():
    """test_mixed_darcy_convergence: cell-centre order > 1.5 (8^2, 16^2),
    the 8^2 error equal to the JAX package's run."""
    errs = [_center_error("torch", "RT0Cube", n, _Sin()) for n in (8, 16)]
    assert np.log2(errs[0] / errs[1]) > 1.5, errs
    assert _rel(errs[0], _center_error("jax", "RT0Cube", 8, _JSin())) < 1e-6


def test_mixed_rt0_conserves_locally():
    """test_mixed_darcy_local_conservation: max |r_p| < 1e-9 at 8^2."""
    _, W, _, x, ok, go = _solve("torch", "RT0Cube", 8, _Sin())
    assert ok
    assert float(W.restrict(go.residual(x), 1).abs().max()) < 1e-9


def test_mixed_rt0_saddle_symmetric():
    """test_mixed_rt0_interface_continuity at 4^2: the assembled operator
    is symmetric, its u-u block SPD."""
    _, W, Vu, _ = _mixed_space("torch", "RT0Cube", 4)
    go = tpt.GridOperator(W, DiffusionMixed(_Sin()))
    A = go.jacobian(W.zero(dtype=F64)).to_dense().numpy()
    assert np.allclose(A, A.T, atol=1e-11)
    assert np.linalg.eigvalsh(A[:Vu.ndofs, :Vu.ndofs]).min() > 0


# ------------------------------------------- tests/test_hdiv_simplex.py
def test_rt0_triangle_unisolvence():
    fem = hdiv.RT0Simplex2D()
    xq, wq = gauss_legendre(4)
    verts = fem._verts
    normals = np.array([[1, 1] / np.sqrt(2), [0, -1], [-1, 0]], float)
    M = np.zeros((3, 3))
    for lf, (a, b) in enumerate([(1, 2), (0, 2), (0, 1)]):
        va, vb = verts[a], verts[b]
        pts = va[None] + xq[:, None] * (vb - va)[None]
        M[lf] = (wq * np.linalg.norm(vb - va)) @ np.einsum(
            "qbd,d->qb", fem.tabulate_vector(pts), normals[lf])
    assert np.allclose(M, np.eye(3), atol=1e-12)
    assert np.allclose(fem.tabulate_div(np.array([[0.3, 0.2]])), 2.0)


def test_bdm1_triangle_unisolvence():
    fem = hdiv.BDM1Simplex2D()
    assert np.allclose(fem._dof_matrix() @ fem._C, np.eye(6), atol=1e-10)


@pytest.mark.parametrize("case", ["RT0Simplex2D", "BDM1Simplex2D"])
def test_mixed_triangles_saddle_symmetric(case):
    """test_mixed_simplex_operator_symmetric at 3^2 x 2."""
    _, W, Vu, _ = _mixed_space("torch", case, 3)
    go = tpt.GridOperator(W, DiffusionMixed(_Sin()))
    A = go.jacobian(W.zero(dtype=F64)).to_dense().numpy()
    assert np.allclose(A, A.T, atol=1e-10)
    assert np.linalg.eigvalsh(A[:Vu.ndofs, :Vu.ndofs]).min() > 0


@pytest.mark.parametrize("case", ["RT0Simplex2D", "BDM1Simplex2D"])
def test_mixed_triangles_conserve_locally(case):
    """test_mixed_simplex_local_conservation at 6^2 x 2: max |r_p| < 1e-8."""
    _, W, _, x, ok, go = _solve("torch", case, 6, _Sin())
    assert ok
    assert float(W.restrict(go.residual(x), 1).abs().max()) < 1e-8


def test_mixed_rt0_triangles_order():
    """test_mixed_simplex_rt0_convergence (4, 8): order > 0.9, the 4^2
    error equal to the JAX package's."""
    errs = [_center_error("torch", "RT0Simplex2D", n, _Sin()) for n in (4, 8)]
    assert np.log2(errs[0] / errs[1]) > 0.9, errs
    assert _rel(errs[0], _center_error("jax", "RT0Simplex2D", 4, _JSin())) < 1e-6


def test_rt0_tet_unisolvence():
    fem = hdiv.RT0Simplex3D()
    verts = fem._verts
    qp, qw = quadrature_rule("simplex", 2, 4)
    lam = np.concatenate([1 - qp.sum(axis=1, keepdims=True), qp], axis=1)
    M = np.zeros((4, 4))
    for lf in range(4):
        fverts = verts[[v for v in range(4) if v != lf]]
        n = np.cross(fverts[1] - fverts[0], fverts[2] - fverts[0])
        area2 = np.linalg.norm(n)
        n = n / area2
        if np.dot(n, fverts[0] - verts[lf]) < 0:
            n = -n
        M[lf] = (qw * area2) @ np.einsum("qbd,d->qb", fem.tabulate_vector(lam @ fverts), n)
    assert np.allclose(M, np.eye(4), atol=1e-12)


def test_mixed_rt0_tets():
    """test_mixed_simplex3d_rt0 at 2^3 x 6: symmetric operator, SPD u-u
    block, MINRES converges, max |r_p| < 1e-8."""
    class P3(ConvectionDiffusionProblem):
        def f(self, x):
            return 1.0 + 0.0 * x[..., 0]

    _, W, Vu, _ = _mixed_space("torch", "RT0Simplex3D", 2)
    go = tpt.GridOperator(W, DiffusionMixed(P3()))
    A = go.jacobian(W.zero(dtype=F64)).to_dense().numpy()
    assert np.allclose(A, A.T, atol=1e-10)
    assert np.linalg.eigvalsh(A[:Vu.ndofs, :Vu.ndofs]).min() > 0
    slp = StationaryLinearProblemSolver(
        go, LinearSolverBackend(solver="minres", precond="none", maxiter=40000),
        reduction=1e-10, verbose=0)
    x = slp.apply(W.zero(dtype=F64))
    assert slp.result.converged
    assert float(W.restrict(go.residual(x), 1).abs().max()) < 1e-8


# --------------------------------------------- tests/test_rt_higher.py (7)
@pytest.mark.parametrize("k", [1, 2, 3])
def test_rtk_square_unisolvent(k):
    el = hdiv.RTkCube2D(k)
    assert np.abs(el._dof_matrix() @ el._C - np.eye(el.nbasis)).max() < 1e-9


def test_rt2_divergence_biquadratic():
    el = hdiv.RT2Cube2D()
    pts = np.random.default_rng(5).uniform(0, 1, (30, 2))
    d = el.tabulate_div(pts)
    A = np.stack([pts[:, 0]**i * pts[:, 1]**j for i in range(3) for j in range(3)], axis=1)
    coef, *_ = np.linalg.lstsq(A, d, rcond=None)
    assert np.allclose(A @ coef, d, atol=1e-8)


def test_rt1_triangle_unisolvent():
    el = hdiv.RT1Simplex2D()
    assert np.abs(el._dof_matrix() @ el._C - np.eye(8)).max() < 1e-10


def test_rt1_triangle_normal_trace():
    el = hdiv.RT1Simplex2D()
    t = np.linspace(0.05, 0.95, 7)
    vn = -el.tabulate_vector(np.stack([np.zeros_like(t), t], axis=1))[:, :, 0]
    assert np.abs(vn[:, 6:]).max() < 1e-10
    x, w = np.polynomial.legendre.leggauss(7)
    xq, wq = 0.5 * (x + 1.0), 0.5 * w
    vq = -el.tabulate_vector(np.stack([np.zeros_like(xq), xq], axis=1))[:, :, 0]
    m0, m1 = wq @ vq, (wq * (2 * xq - 1)) @ vq
    assert abs(m0[4] - 1) < 1e-10 and abs(m1[4]) < 1e-10
    assert abs(m0[5]) < 1e-10 and abs(m1[5] - 1) < 1e-10


def test_rt2_darcy_pressure_error():
    """test_rt2_mixed_darcy_order3's solve at 4^2 (reduction 1e-12): the
    port's L2 error equals the JAX package's. Its order check (> 2.5 from 4^2
    to 8^2) runs on the card (chip_smoke phase 14a, at 16^2/32^2): the port's
    eager 8^2 MINRES (2,179 iterations of ~6 ms general-jvp applies on this
    CPU) takes ~14 s, above the ~15 s a CPU case may take with its JAX run."""
    err = _l2_error("torch", "RT2Cube2D", 4, _Sin(), 1e-12)
    assert _rel(err, _l2_error("jax", "RT2Cube2D", 4, _JSin(), 1e-12)) < 1e-6


def test_rt1_triangle_darcy_order2():
    """test_rt1_simplex_mixed_darcy_order2 (4, 8): L2 order > 1.6, the 4^2
    error equal to the JAX package's."""
    errs = [_l2_error("torch", "RT1Simplex2D", n, _Sin(), 1e-12) for n in (4, 8)]
    assert np.log2(errs[0] / errs[1]) > 1.6, errs
    assert _rel(errs[0], _l2_error("jax", "RT1Simplex2D", 4, _JSin(), 1e-12)) < 1e-6


def test_rt1_triangle_saddle_symmetric():
    _, W, Vu, _ = _mixed_space("torch", "RT1Simplex2D", 3)
    go = tpt.GridOperator(W, DiffusionMixed(_Sin()))
    A = go.jacobian(W.zero(dtype=F64)).to_dense().numpy()
    assert np.allclose(A, A.T, atol=1e-9)
    assert np.linalg.eigvalsh(A[:Vu.ndofs, :Vu.ndofs]).min() > 0


# ------------------------------- tests/test_fe_zoo.py RT1 tests (:84-138)
def test_rt1_square_dof_duality():
    fem = hdiv.RT1Cube2D()
    assert np.allclose(fem._dofs_of_raw() @ fem._C, np.eye(12), atol=1e-10)


def test_rt1_square_divergence_bilinear():
    fem = hdiv.RT1Cube2D()
    pts = np.random.default_rng(0).random((20, 2))
    d = fem.tabulate_div(pts)
    A = np.stack([np.ones(20), pts[:, 0], pts[:, 1], pts[:, 0] * pts[:, 1]], axis=1)
    coef, *_ = np.linalg.lstsq(A, d, rcond=None)
    assert np.allclose(A @ coef, d, atol=1e-9)


def test_rt1_square_darcy_order2():
    """test_rt1_mixed_darcy_beats_rt0 (8, 16): L2 order > 1.6 with the
    JAX package's errors at 8^2 (its 16^2 run is left to the port)."""
    errs = [_l2_error("torch", "RT1Cube2D", n, _Sin(), 1e-11) for n in (8, 16)]
    assert np.log2(errs[0] / errs[1]) > 1.6, errs
    assert _rel(errs[0], _l2_error("jax", "RT1Cube2D", 8, _JSin(), 1e-11)) < 1e-6


# -------------------------- tests/test_fe_zoo_r3.py RT1-cube tests (:167-225)
def test_rt1_hex_unisolvent():
    el = hdiv.RTkCube3D(1)
    assert np.abs(el._dof_matrix() @ el._C - np.eye(el.nbasis)).max() < 1e-9


def test_rt1_hex_normal_trace():
    el = hdiv.RTkCube3D(1)
    t = np.linspace(0.1, 0.9, 3)
    T1, T2 = np.meshgrid(t, t, indexing="ij")
    for a, s in ((0, 0), (1, 1), (2, 0)):
        t1, t2 = [d for d in range(3) if d != a]
        pts = np.zeros((T1.size, 3))
        pts[:, a] = float(s)
        pts[:, t1] = T1.ravel()
        pts[:, t2] = T2.ravel()
        vn = el.tabulate_vector(pts)[:, :, a]
        assert np.abs(vn[:, 24:]).max() < 1e-9
        blk = (2 * a + s) * 4
        assert np.abs(vn[:, [j for j in range(24) if not blk <= j < blk + 4]]).max() < 1e-9


def test_rt1_hex_darcy_order2():
    """test_rt1_cube3d_mixed_darcy_order2 (2^3, 4^3): L2 order > 1.6, the
    2^3 error equal to the JAX package's."""
    errs = [_l2_error("torch", "RTkCube3D", n, _Sin3(), 1e-11) for n in (2, 4)]
    assert np.log2(errs[0] / errs[1]) > 1.6, errs
    assert _rel(errs[0], _l2_error("jax", "RTkCube3D", 2, _JSin3(), 1e-11)) < 1e-6


# -------------------------------------- tests/test_mapped.py (:79, :176)
def _identity_mapped(n):
    uni = tpt.StructuredMesh([0, 0], [1, 1], (n, n))
    idx = np.arange(uni.nvertices)
    coords = np.stack([(idx % (n + 1)) / n, (idx // (n + 1)) / n], axis=-1)
    return uni, tpt.StructuredMesh([0, 0], [1, 1], (n, n), coords=coords)


def test_mapped_identity_matches_uniform():
    """test_mapped_matches_uniform_on_identity_map: the mapped geometry paths
    (volume, Neumann boundary faces, H(div) Piola) on an identity map give
    the uniform paths' residual and J.v to 1e-12."""
    from dune_pdelab_tpu_torch.ops import BCType, ConvectionDiffusionFEM

    class WithNeumann(_Harmonic):
        def bctype(self, x):
            m = torch if isinstance(x, torch.Tensor) else np
            return m.where(x[..., 0] > 1 - 1e-9, BCType.NEUMANN, BCType.DIRICHLET)

        def j(self, x):
            return -2.0 * x[..., 0]

    uni, mapped = _identity_mapped(8)
    out = []
    for mesh in (uni, mapped):
        V = tpt.FunctionSpace(mesh, tpt.QkFEM(1, 2))
        go = tpt.GridOperator(V, ConvectionDiffusionFEM(WithNeumann()),
                              constraints=tpt.constraints(WithNeumann().dirichlet_bctype(), V))
        x = torch.from_numpy(np.random.default_rng(0).standard_normal(V.ndofs))
        out.append((go.residual(x), go.jacobian_apply(x, x)))
    assert float((out[0][0] - out[1][0]).abs().max()) < 1e-12
    assert float((out[0][1] - out[1][1]).abs().max()) < 1e-12
    rs = []
    for mesh in (uni, mapped):
        W = tpt.CompositeSpace(tpt.FunctionSpace(mesh, hdiv.RT0Cube(2)),
                               tpt.FunctionSpace(mesh, P0FEM(2)))
        go = tpt.GridOperator(W, DiffusionMixed(_Harmonic()))
        rs.append(go.residual(torch.from_numpy(np.random.default_rng(1).standard_normal(W.ndofs))))
    assert float((rs[0] - rs[1]).abs().max()) < 1e-12


def test_mixed_annulus_order2():
    """test_mixed_darcy_curved_mesh_h2 (8, 16, 32; slow tier in the
    reference): the mapped Piola and the Nanson boundary term give O(h^2)
    cell-centre pressures (orders > 1.85); the 8^2 error equal to the JAX
    package's."""
    errs = [_center_error("torch", "RT0Cube-mapped", n, _Harmonic()) for n in (8, 16, 32)]
    assert min(np.log2(errs[i] / errs[i + 1]) for i in range(2)) > 1.85, errs
    assert _rel(errs[0], _center_error("jax", "RT0Cube-mapped", 8, _JHarmonic())) < 1e-6


# ------------------- tests/test_fem_sweep.py H(div) and mimetic cases
@pytest.mark.parametrize("dim", [2, 3])
def test_mimetic_reproduces_linears(dim):
    """test_scalar_fem_reproduces_linears for MimeticFEM(2), MimeticFEM(3)
    on 3^d cells, with the reference's interpolant alongside."""
    V = tpt.FunctionSpace(tpt.StructuredMesh([0] * dim, [1] * dim, (3,) * dim), MimeticFEM(dim))
    Vj = jpt.FunctionSpace(jpt.StructuredMesh([0] * dim, [1] * dim, (3,) * dim), JMimetic(dim))

    def f(p):
        return 1.0 + np.atleast_2d(np.asarray(p)) @ np.arange(1, dim + 1)

    x = V.interpolate(lambda q: f(q), dtype=F64)
    assert float(l2_difference(V, x, f)) < 1e-10
    assert np.abs(x.numpy() - np.asarray(Vj.interpolate(lambda q: f(q)))).max() < 1e-14


VECTOR_SWEEP = [("RT0Cube", (2,), 2, "cube"), ("RT0Cube", (3,), 3, "cube"),
                ("BDM1Cube", (2,), 2, "cube"), ("RTkCube2D", (1,), 2, "cube"),
                ("RTkCube2D", (2,), 2, "cube"), ("RT0Simplex2D", (), 2, "simplex"),
                ("RT0Simplex3D", (), 3, "simplex"), ("BDM1Simplex2D", (), 2, "simplex"),
                ("RT1Simplex2D", (), 2, "simplex"), ("RTkCube3D", (1,), 3, "cube")]


@pytest.mark.parametrize("name,args,dim,kind", VECTOR_SWEEP,
                         ids=[f"{n}{a}-{k}" for n, a, _, k in VECTOR_SWEEP])
def test_hdiv_space_builds(name, args, dim, kind):
    """test_vector_fem_space_builds (H(div) cases, 3^d cells): every DOF
    referenced, max index + 1 == ndofs."""
    fem = getattr(hdiv, name)(*args)
    V = tpt.FunctionSpace(_mesh("torch", kind, 3, dim), fem)
    ed = V.element_dofs
    assert ed.min() == 0 and ed.max() == V.ndofs - 1
    assert len(np.unique(ed)) == V.ndofs
    assert ed.shape == (V.mesh.nelements, fem.nbasis)
