"""H(curl) edge elements, their spaces and the curl-curl operator of the
port against the JAX package (fp64, CPU).

Tolerances: tabulations (values and curls) 1e-14 absolute at seeded random
points; edge lattices (`_hcurl_edge_dims`, `_hcurl_offsets`), DOF maps,
Whitney orientation signs and `boundary_edge_mask()` exactly equal;
CurlCurl residual and J.v 1e-12 relative. The reference's tests
(tests/test_hcurl.py, the three Whitney-tet tests of test_fe_zoo_r3.py, the
H(curl) cases of test_fem_sweep.py) run on the port with their own bounds
and sizes; the manufactured solves are compared with the JAX package's
run of the same problem to 1e-8 relative.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import scipy.linalg as sla
import torch

import dune_pdelab_tpu as jpt
import dune_pdelab_tpu_torch as tpt
from dune_pdelab_tpu.fe import hcurl as jhcurl
from dune_pdelab_tpu.linalg import cg as jcg
from dune_pdelab_tpu.mesh import SimplexMesh as JSimplexMesh
from dune_pdelab_tpu.ops.electrodynamic import (
    CurlCurl as JCurlCurl, CurlCurlParameters as JCurlCurlParameters,
)
from dune_pdelab_tpu_torch.constraints import DirichletConstraints
from dune_pdelab_tpu_torch.fe import QkFEM, gauss_legendre
from dune_pdelab_tpu_torch.fe import hcurl
from dune_pdelab_tpu_torch.linalg.krylov import cg
from dune_pdelab_tpu_torch.mesh import SimplexMesh
from dune_pdelab_tpu_torch.ops import CurlCurl, CurlCurlParameters
from dune_pdelab_tpu_torch.utils.common import set_default_device

pytestmark = pytest.mark.fast
torch.set_num_threads(1)
set_default_device("cpu")
F64 = torch.float64
PKG = {"jax": (jpt, JSimplexMesh, jhcurl), "torch": (tpt, SimplexMesh, hcurl)}


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _m(x):
    return torch if isinstance(x, torch.Tensor) else jnp


def _mesh(pkg, kind, n, dim, periodic=None):
    mod, Simplex, _ = PKG[pkg]
    if kind == "mapped":
        # a smooth non-affine map of the unit square
        idx = np.arange((n + 1) ** 2)
        u, v = (idx % (n + 1)) / n, (idx // (n + 1)) / n
        coords = np.stack([u + 0.1 * u * v, v + 0.05 * np.sin(np.pi * u)], axis=-1)
        return mod.StructuredMesh([0, 0], [1, 1], (n, n), coords=coords)
    m = mod.StructuredMesh([0] * dim, [1] * dim, (n,) * dim, periodic=periodic)
    return Simplex.from_structured(m) if kind == "simplex" else m


def _space(pkg, kind, n, dim, periodic=None):
    mod, _, el = PKG[pkg]
    fem = el.N0Simplex(dim) if kind == "simplex" else el.N0Cube(dim)
    return mod.FunctionSpace(_mesh(pkg, kind, n, dim, periodic), fem)


def _tet(n):
    return SimplexMesh.from_structured(tpt.StructuredMesh([0, 0, 0], [1, 1, 1], (n, n, n)))


# ---------------------------------------------------------------- elements
ELEMENTS = [("N0Cube", 2), ("N0Cube", 3), ("N0Simplex", 2), ("N0Simplex", 3)]


@pytest.mark.parametrize("name,dim", ELEMENTS, ids=[f"{n}{d}" for n, d in ELEMENTS])
def test_tabulations_match_reference(name, dim):
    el, ref = getattr(hcurl, name)(dim), getattr(jhcurl, name)(dim)
    pts = np.random.default_rng(dim).random((60, dim))
    if name == "N0Simplex":
        pts = pts[pts.sum(axis=1) <= 1.0]
    assert np.abs(el.tabulate_vector(pts) - ref.tabulate_vector(pts)).max() <= 1e-14
    assert np.abs(el.tabulate_curl(pts) - ref.tabulate_curl(pts)).max() <= 1e-14
    assert el.nbasis == ref.nbasis
    if name == "N0Cube":
        assert el.edges == ref.edges


SPACES = [("cube", 2, None), ("cube", 2, (True, False)), ("cube", 3, None),
          ("cube", 3, (False, True, True)), ("simplex", 2, None), ("simplex", 3, None),
          ("mapped", 2, None)]


@pytest.mark.parametrize("kind,dim,periodic", SPACES,
                         ids=[f"{k}{d}-{'periodic' if p else 'plain'}" for k, d, p in SPACES])
def test_edge_maps_and_masks_match_reference(kind, dim, periodic):
    Vj = _space("jax", kind, 3, dim, periodic)
    Vt = _space("torch", kind, 3, dim, periodic)
    assert Vt.ndofs == Vj.ndofs
    assert np.array_equal(Vt.element_dofs, np.asarray(Vj.element_dofs))
    assert np.array_equal(Vt.boundary_edge_mask(), Vj.boundary_edge_mask())
    if kind == "simplex":
        assert np.array_equal(Vt._hcurl_signs, Vj._hcurl_signs)
    else:
        assert Vt._hcurl_edge_dims == Vj._hcurl_edge_dims
        assert Vt._hcurl_offsets == Vj._hcurl_offsets


class _Source(CurlCurlParameters):
    def f(self, x):
        return _m(x).sin(2.0 * x + 0.3)


class _JSource(JCurlCurlParameters):
    f = _Source.f


@pytest.mark.parametrize("kind,dim", [("cube", 2), ("cube", 3), ("simplex", 2),
                                      ("simplex", 3), ("mapped", 2)])
def test_curlcurl_residual_and_jv_match_reference(kind, dim):
    n = 2 if dim == 3 else 4
    goj = jpt.GridOperator(_space("jax", kind, n, dim), JCurlCurl(_JSource(nu=1.3, beta=0.7)))
    got = tpt.GridOperator(_space("torch", kind, n, dim), CurlCurl(_Source(nu=1.3, beta=0.7)))
    rng = np.random.default_rng(3)
    x, z = rng.standard_normal(goj.space.ndofs), rng.standard_normal(goj.space.ndofs)
    assert _rel(got.residual(torch.from_numpy(x)), goj.residual(jnp.asarray(x))) < 1e-12
    assert _rel(got.jacobian_apply(torch.from_numpy(x), torch.from_numpy(z)),
                goj.jacobian_apply(jnp.asarray(x), jnp.asarray(z))) < 1e-12


def test_simplex_face_integrals_refused():
    """H(curl) face integrals on simplices raise, as in the reference."""
    class WithFace(CurlCurl):
        def lambda_boundary(self, ctx):
            return 0.0 * ctx.factor

    with pytest.raises(NotImplementedError):
        tpt.GridOperator(_space("torch", "simplex", 2, 2), WithFace(CurlCurlParameters()))


# ------------------------------------------------------ tests/test_hcurl.py
@pytest.mark.parametrize("dim", [2, 3])
def test_edge_dof_duality(dim):
    fem = hcurl.N0Cube(dim)
    xq, wq = gauss_legendre(3)
    for b, (a, tdims, bits) in enumerate(fem.edges):
        pts = np.zeros((len(xq), dim))
        pts[:, a] = xq
        for td, bit in zip(tdims, bits):
            pts[:, td] = bit
        expect = np.zeros(fem.nbasis)
        expect[b] = 1.0
        assert np.allclose(np.einsum("q,qB->B", wq, fem.tabulate_vector(pts)[:, :, a]),
                           expect, atol=1e-12)


def _gradient_circulations(Ve, Vn, pvals):
    """Edge DOFs of the nodal potential's gradient: p(end) - p(start)."""
    dim = Ve.mesh.dim
    gvec = np.zeros(Ve.ndofs)
    dims_n = Vn._dof_grid_dims
    strides = np.cumprod((1,) + tuple(dims_n[:-1])).astype(np.int64)
    for a in range(dim):
        ed, off = Ve._hcurl_edge_dims[a], Ve._hcurl_offsets[a]
        n_a = int(np.prod(ed))
        g = np.arange(n_a, dtype=np.int64)
        mi = np.empty((n_a, dim), dtype=np.int64)
        for d in range(dim):
            mi[:, d] = g % ed[d]
            g = g // ed[d]
        gvec[off:off + n_a] = (pvals[(mi + np.eye(dim, dtype=np.int64)[a]) @ strides]
                               - pvals[mi @ strides])
    return gvec


@pytest.mark.parametrize("dim", [2, 3])
def test_discrete_de_rham(dim):
    """test_discrete_de_rham at 4^d: edge DOFs of a nodal gradient lie in
    the kernel of the curl-curl matrix."""
    mesh = tpt.StructuredMesh([0] * dim, [1] * dim, (4,) * dim)
    Ve = tpt.FunctionSpace(mesh, hcurl.N0Cube(dim))
    Vn = tpt.FunctionSpace(mesh, QkFEM(1, dim))
    go = tpt.GridOperator(Ve, CurlCurl(CurlCurlParameters(nu=1.0, beta=0.0)))
    gvec = _gradient_circulations(Ve, Vn, np.random.default_rng(0).standard_normal(Vn.ndofs))
    y = go.jacobian_apply(Ve.zero(dtype=F64), torch.from_numpy(gvec))
    assert float(torch.linalg.norm(y)) < 1e-10 * max(1.0, np.linalg.norm(gvec))


class _Manufactured(CurlCurlParameters):
    """curl curl u + u = f, u = (sin(pi y), sin(pi x)) (tests/test_hcurl.py)."""

    def f(self, x):
        m, c = _m(x), np.pi**2 + 1.0
        return m.stack([c * m.sin(np.pi * x[..., 1]), c * m.sin(np.pi * x[..., 0])], -1)


class _JManufactured(JCurlCurlParameters):
    f = _Manufactured.f


def exact_circulations(Ve, h):
    """Exact edge integrals of u = (sin(pi y), sin(pi x)) on the unit
    square's edge lattice: h sin(pi y0) on an x-edge at height y0,
    h sin(pi x0) on a y-edge (closed forms of the reference's scipy quad)."""
    exact = np.zeros(Ve.ndofs)
    for a in range(2):
        ed, off = Ve._hcurl_edge_dims[a], Ve._hcurl_offsets[a]
        g = np.arange(int(np.prod(ed)), dtype=np.int64)
        mi = np.stack([g % ed[0], g // ed[0]], axis=1)
        exact[off:off + len(g)] = h * np.sin(np.pi * mi[:, 1 - a] * h)
    return exact


def test_curlcurl_manufactured_square():
    """test_curlcurl_manufactured_2d at 16^2: boundary edges constrained,
    Jacobi-CG to 1e-11, edge DOFs within 5% of the exact circulations; the
    solution equals the JAX package's to 1e-8."""
    from scipy.integrate import quad

    n = 16
    Ve = tpt.FunctionSpace(tpt.StructuredMesh([0, 0], [1, 1], (n, n)), hcurl.N0Cube(2))
    go = tpt.GridOperator(Ve, CurlCurl(_Manufactured()),
                          constraints=DirichletConstraints(Ve.boundary_edge_mask()))
    zero = Ve.zero(dtype=F64)
    b, d = go.residual(zero), go.jacobian_diagonal(zero)
    z, stats = cg(lambda v: go.jacobian_apply(zero, v), b, M=lambda r: r / d,
                  tol=1e-11, maxiter=5000)
    assert bool(stats.converged)
    x = -z.numpy()
    exact = exact_circulations(Ve, 1.0 / n)
    # the closed forms are the reference's quadratures
    x0 = np.array([3, 5]) / n
    assert abs(quad(lambda s: np.sin(np.pi * x0[1]), x0[0], x0[0] + 1.0 / n)[0]
               - exact[Ve._hcurl_offsets[0] + 3 + 5 * n]) < 1e-15
    assert np.linalg.norm(x - exact) / np.linalg.norm(exact) < 0.05
    Vj = jpt.FunctionSpace(jpt.StructuredMesh([0, 0], [1, 1], (n, n)), jhcurl.N0Cube(2))
    goj = jpt.GridOperator(Vj, JCurlCurl(_JManufactured()),
                           constraints=jpt.DirichletConstraints(Vj.boundary_edge_mask()))
    zj = jnp.zeros(Vj.ndofs)
    dj = goj.jacobian_diagonal(zj)
    xj, _ = jcg(lambda v: goj.jacobian_apply(zj, v), goj.residual(zj), M=lambda r: r / dj,
                tol=1e-11, maxiter=5000)
    assert _rel(x, -np.asarray(xj)) < 1e-8


def test_whitney_triangle_duality():
    fem = hcurl.N0Simplex2D()
    verts = np.array([[0.0, 0.0], [0.0, 1.0], [1.0, 0.0]])
    xq, wq = gauss_legendre(4)
    M = np.zeros((3, 3))
    for lf, (a, b) in enumerate(fem._pairs):
        va, vb = verts[a], verts[b]
        pts = va[None] + xq[:, None] * (vb - va)[None]
        M[lf] = wq @ np.einsum("qbd,d->qb", fem.tabulate_vector(pts), vb - va)
    assert np.allclose(M, np.eye(3), atol=1e-12)


def test_whitney_triangles_de_rham():
    sm = SimplexMesh.from_structured(tpt.StructuredMesh([0, 0], [1, 1], (4, 4)))
    Ve = tpt.FunctionSpace(sm, hcurl.N0Simplex2D())
    go = tpt.GridOperator(Ve, CurlCurl(CurlCurlParameters(nu=1.0, beta=0.0)))
    pvals = np.random.default_rng(0).standard_normal(sm.nvertices)
    uniq, _ = sm.edges()
    y = go.jacobian_apply(Ve.zero(dtype=F64), torch.from_numpy(pvals[uniq[:, 1]] - pvals[uniq[:, 0]]))
    assert float(torch.linalg.norm(y)) < 1e-10


def test_whitney_triangles_spd_solve():
    """test_simplex_curlcurl_spd_solve at 4^2 x 2: SPD operator, CG to 1e-10,
    residual < 1e-8."""
    class P(CurlCurlParameters):
        def f(self, x):
            return torch.stack([torch.ones_like(x[..., 0]), x[..., 0]], dim=-1)

    sm = SimplexMesh.from_structured(tpt.StructuredMesh([0, 0], [1, 1], (4, 4)))
    Ve = tpt.FunctionSpace(sm, hcurl.N0Simplex2D())
    go = tpt.GridOperator(Ve, CurlCurl(P(nu=1.0, beta=1.0)))
    zero = Ve.zero(dtype=F64)
    A = go.jacobian(zero).to_dense().numpy()
    assert np.allclose(A, A.T, atol=1e-11)
    assert np.linalg.eigvalsh(A).min() > 0
    x, s = cg(lambda z: go.jacobian_apply(zero, z), -go.residual(zero), tol=1e-10)
    assert bool(s.converged)
    assert float(torch.linalg.norm(go.residual(x))) < 1e-8


def test_maxwell_cavity_eigenvalues():
    """test_maxwell_eigenvalues_unit_square at 16^2: PEC cavity, the first
    five nonzero eigenvalues / pi^2 are {1, 1, 2, 4, 4} (rtol 0.02), the
    kernel has dimension 15^2."""
    V = tpt.FunctionSpace(tpt.StructuredMesh([0, 0], [1, 1], (16, 16)), hcurl.N0Cube(2))
    zero = V.zero(dtype=F64)
    A = tpt.GridOperator(V, CurlCurl(CurlCurlParameters(nu=1.0, beta=0.0))).jacobian(zero)
    M = tpt.GridOperator(V, CurlCurl(CurlCurlParameters(nu=0.0, beta=1.0))).jacobian(zero)
    free = ~V.boundary_edge_mask()
    A = A.to_dense().numpy()[np.ix_(free, free)]
    M = M.to_dense().numpy()[np.ix_(free, free)]
    lam = np.sort(sla.eigh(A, M, eigvals_only=True))
    nz = lam[lam > 1e-6] / np.pi**2
    assert np.allclose(nz[:5], [1.0, 1.0, 2.0, 4.0, 4.0], rtol=0.02), nz[:8]
    assert int(np.sum(lam <= 1e-6)) == 15 * 15


# ------------------------- tests/test_fe_zoo_r3.py Whitney tets (:96-165)
def test_whitney_tet_gradient_kernel():
    sm = _tet(3)
    V = tpt.FunctionSpace(sm, hcurl.N0Simplex(3))
    uniq, _ = sm.edges()
    pv = np.sin(sm.vertices[:, 0] * 1.3) + sm.vertices[:, 1] ** 2 - 0.7 * sm.vertices[:, 2]
    gvec = pv[uniq[:, 1]] - pv[uniq[:, 0]]
    go = tpt.GridOperator(V, CurlCurl(CurlCurlParameters(nu=1.0, beta=0.0)))
    y = go.jacobian_apply(V.zero(dtype=F64), torch.from_numpy(gvec))
    assert float(torch.linalg.norm(y)) < 1e-10 * max(1.0, np.linalg.norm(gvec))


def test_whitney_tet_constant_exact():
    sm = _tet(2)
    V = tpt.FunctionSpace(sm, hcurl.N0Simplex(3))
    c = np.array([0.7, -1.2, 0.4])
    uniq, _ = sm.edges()

    class P(CurlCurlParameters):
        def f(self, x):
            return torch.broadcast_to(torch.as_tensor(c, dtype=x.dtype), x.shape)

    go = tpt.GridOperator(V, CurlCurl(P(nu=0.0, beta=1.0)))
    r = go.residual(torch.from_numpy((sm.vertices[uniq[:, 1]] - sm.vertices[uniq[:, 0]]) @ c))
    assert float(torch.linalg.norm(r)) < 1e-12


class _GradSin(CurlCurlParameters):
    """f = u = grad prod sin(pi x_i) (tests/test_fe_zoo_r3.py)."""

    def f(self, x):
        m, pi = _m(x), np.pi
        s, c = m.sin, m.cos
        X, Y, Z = x[..., 0], x[..., 1], x[..., 2]
        return pi * m.stack([c(pi * X) * s(pi * Y) * s(pi * Z),
                             s(pi * X) * c(pi * Y) * s(pi * Z),
                             s(pi * X) * s(pi * Y) * c(pi * Z)], -1)


def test_whitney_tet_curlcurl_order():
    """test_whitney_tet_curlcurl_manufactured (2, 4): first-order
    convergence of the edge DOFs to the exact circulations."""
    errs = []
    for n in (2, 4):
        sm = _tet(n)
        V = tpt.FunctionSpace(sm, hcurl.N0Simplex(3))
        uniq, _ = sm.edges()
        go = tpt.GridOperator(V, CurlCurl(_GradSin(nu=1.0, beta=1.0)),
                              constraints=DirichletConstraints(V.boundary_edge_mask()))
        zero = V.zero(dtype=F64)
        d = go.jacobian_diagonal(zero)
        z, s = cg(lambda v: go.jacobian_apply(zero, v), go.residual(zero), M=lambda r: r / d,
                  tol=1e-12, maxiter=4000)
        assert bool(s.converged)
        pv = np.prod(np.sin(np.pi * sm.vertices), axis=1)
        exact = pv[uniq[:, 1]] - pv[uniq[:, 0]]
        errs.append(float(np.linalg.norm(-z.numpy() - exact) / np.linalg.norm(exact)))
    assert np.log2(errs[0] / errs[1]) > 0.9, errs


# ----------------------------- tests/test_fem_sweep.py H(curl) cases
@pytest.mark.parametrize("kind,dim", [("cube", 2), ("cube", 3), ("simplex", 2), ("simplex", 3)])
def test_hcurl_space_builds(kind, dim):
    V = _space("torch", kind, 3, dim)
    ed = V.element_dofs
    assert ed.min() == 0 and ed.max() == V.ndofs - 1
    assert len(np.unique(ed)) == V.ndofs
    assert ed.shape == (V.mesh.nelements, V.fem.nbasis)
