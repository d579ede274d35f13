"""The new elements of the port against the JAX package (fp64).

  * tabulate values and gradients of P0FEM (cube and simplex),
    RannacherTurekFEM, LegendreDGFEM, MonomialDGFEM, OPBFEM (cube and
    simplex) and QkDGFEM on `gl` and `lobatto` nodes, and the modal bases'
    interpolation matrices: 1e-14;
  * gauss_lobatto and lobatto_points_weights: 1e-14;
  * the non-RT tests of tests/test_fe_zoo.py run on the port at their
    sizes: test_opb_orthonormal, test_modal_projection_reproduces_polynomials
    and test_sipg_with_modal_basis_converges (order > 2.5; the port's L2
    errors within 1e-8 relative of the JAX package's live run);
  * compile_block_stencil of SIPG on a modal basis at 6^2 (MonomialDGFEM and
    OPBFEM k = 2, nb = 6; LegendreDGFEM k = 2, nb = 9): W_taps and dD_sides
    against the JAX package's, 1e-12.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

import dune_pdelab_tpu as jpt
import dune_pdelab_tpu_torch as tpt
from dune_pdelab_tpu.assembly import blockstencil as jbs
from dune_pdelab_tpu.fe import basis as jb
from dune_pdelab_tpu.fe import quadrature as jq
from dune_pdelab_tpu.ops import ConvectionDiffusionProblem as JProblem
from dune_pdelab_tpu.ops.convectiondiffusiondg import ConvectionDiffusionDG as JDG
from dune_pdelab_tpu.ops.convectiondiffusiondg import DGMethod
from dune_pdelab_tpu.solvers import SEQ_BCGS_Jacobi as JBCGS
from dune_pdelab_tpu.space.functions import l2_difference as j_l2
from dune_pdelab_tpu_torch.assembly import blockstencil as tbs
from dune_pdelab_tpu_torch.fe import basis as tb
from dune_pdelab_tpu_torch.fe import quadrature as tq
from dune_pdelab_tpu_torch.fe import MonomialDGFEM, OPBFEM
from dune_pdelab_tpu_torch.fe.quadrature import quadrature_rule
from dune_pdelab_tpu_torch.ops import ConvectionDiffusionDG as TDG
from dune_pdelab_tpu_torch.ops import ConvectionDiffusionProblem as TProblem
from dune_pdelab_tpu_torch.solvers import SEQ_BCGS_Jacobi
from dune_pdelab_tpu_torch.space.functions import l2_difference
from dune_pdelab_tpu_torch.utils.common import set_default_device

pytestmark = pytest.mark.fast
torch.set_num_threads(1)
set_default_device("cpu")
F64 = torch.float64
TAB_TOL = 1e-14

ELEMENTS = [("P0FEM", (2,)), ("P0FEM", (3,)), ("P0FEM", (2, "simplex")),
            ("P0FEM", (3, "simplex")), ("RannacherTurekFEM", (2,)),
            ("RannacherTurekFEM", (3,)), ("LegendreDGFEM", (2, 2)),
            ("LegendreDGFEM", (1, 3)), ("MonomialDGFEM", (2, 2)),
            ("MonomialDGFEM", (1, 3)), ("MonomialDGFEM", (2, 2, "simplex")),
            ("OPBFEM", (2, 2)), ("OPBFEM", (3, 2, "simplex")), ("OPBFEM", (1, 3)),
            ("QkDGFEM", (2, 2, "gl")), ("QkDGFEM", (3, 2, "lobatto")),
            ("QkDGFEM", (2, 3, "lobatto"))]


@pytest.mark.parametrize("name,args", ELEMENTS, ids=[f"{n}{a}" for n, a in ELEMENTS])
def test_tabulation_matches_jax(name, args):
    tf, jf = tb._cached_fem(name, *args), jb._cached_fem(name, *args)
    assert (tf.nbasis, tf.degree, tf.continuity, tf.geometry) == (
        jf.nbasis, jf.degree, jf.continuity, jf.geometry)
    pts = np.random.default_rng(7).random((11, tf.dim))
    if tf.geometry == "simplex":
        pts = pts / (1.0 + pts.sum(1, keepdims=True))
    tv, tg = tf.tabulate(pts)
    jv, jg = jf.tabulate(pts)
    assert np.abs(tv - jv).max() <= TAB_TOL
    assert np.abs(tg - jg).max() <= TAB_TOL
    assert np.abs(np.asarray(tf.interpolation_points)
                  - np.asarray(jf.interpolation_points)).max() <= TAB_TOL
    assert np.abs(np.asarray(tf.interpolation_matrix)
                  - np.asarray(jf.interpolation_matrix)).max() <= 1e-12


@pytest.mark.parametrize("n", [2, 3, 4, 6])
def test_lobatto_rules_match_jax(n):
    for t, j in ((tq.lobatto_points_weights(n), jq.lobatto_points_weights(n)),
                 (tq.gauss_lobatto(2 * n), jq.gauss_lobatto(2 * n))):
        assert np.abs(t[0] - j[0]).max() <= TAB_TOL
        assert np.abs(t[1] - j[1]).max() <= TAB_TOL
    x, w = tq.lobatto_points_weights(n)          # exact to degree 2n-3
    assert abs(np.sum(w * x ** (2 * n - 3)) - 1.0 / (2 * n - 2)) < 1e-14
    assert x[0] == 0.0 and x[-1] == 1.0


# -- tests/test_fe_zoo.py on the port ---------------------------------------
@pytest.mark.parametrize("geometry", ["cube", "simplex"])
@pytest.mark.parametrize("k", [1, 2, 3])
def test_opb_orthonormal(geometry, k):
    fem = OPBFEM(k, 2, geometry)
    qp, qw = quadrature_rule(geometry, 2, 2 * k + 2)
    V, _ = fem.tabulate(qp)
    G = V.T @ (V * qw[:, None])
    assert np.allclose(G, np.eye(fem.nbasis), atol=1e-10)


@pytest.mark.parametrize("cls", [MonomialDGFEM, OPBFEM])
def test_modal_projection_reproduces_polynomials(cls):
    """interpolation_matrix is an L2 projection: exact on the span."""
    k = 2
    fem = cls(k, 2, "cube")
    f = lambda p: 1.0 + 2 * p[:, 0] - p[:, 1] + 0.5 * p[:, 0] * p[:, 1] \
        + p[:, 0] ** 2
    coeffs = fem.interpolation_matrix @ f(fem.interpolation_points)
    qp, _ = quadrature_rule("cube", 2, 2 * k)
    V, _ = fem.tabulate(qp)
    assert np.allclose(V @ coeffs, f(qp), atol=1e-10)


def _sincos_exact(p):
    return np.sin(np.pi * p[:, 0]) * np.cos(2 * np.pi * p[:, 1]) + p[:, 0]


class JSinCos(JProblem):
    def f(self, x):
        return 5 * np.pi**2 * jnp.sin(np.pi * x[..., 0]) * jnp.cos(2 * np.pi * x[..., 1])

    def g(self, x):
        return jnp.sin(np.pi * x[..., 0]) * jnp.cos(2 * np.pi * x[..., 1]) + x[..., 0]


class TSinCos(TProblem):
    def f(self, x):
        return 5 * np.pi**2 * torch.sin(np.pi * x[..., 0]) * torch.cos(2 * np.pi * x[..., 1])

    def g(self, x):
        return torch.sin(np.pi * x[..., 0]) * torch.cos(2 * np.pi * x[..., 1]) + x[..., 0]


def _exact_any(p):
    return _sincos_exact(np.asarray(p))


@pytest.mark.parametrize("name", ["MonomialDGFEM", "OPBFEM"])
def test_sipg_with_modal_basis_converges(name):
    """SIPG Poisson on modal total-degree bases: order k+1 in L2
    (testconvectiondiffusiondg.cc analog), the port's errors against the
    JAX package's run of the same problem."""
    errs, jerrs = [], []
    for n in (8, 16):
        mesh = tpt.StructuredMesh([0, 0], [1, 1], (n, n))
        V = tpt.FunctionSpace(mesh, getattr(tb, name)(2, 2, "cube"))
        go = tpt.GridOperator(V, TDG(TSinCos(), method=DGMethod.SIPG))
        slp = tpt.StationaryLinearProblemSolver(
            go, SEQ_BCGS_Jacobi(maxiter=20000), reduction=1e-11)
        x = slp.apply(V.zero(dtype=F64))
        assert slp.result.converged
        errs.append(float(l2_difference(V, x, lambda p: torch.as_tensor(
            _sincos_exact(p.numpy())))))
        jmesh = jpt.StructuredMesh([0, 0], [1, 1], (n, n))
        jV = jpt.FunctionSpace(jmesh, getattr(jb, name)(2, 2, "cube"))
        jgo = jpt.GridOperator(jV, JDG(JSinCos(), method=DGMethod.SIPG))
        jslp = jpt.StationaryLinearProblemSolver(
            jgo, JBCGS(maxiter=20000), reduction=1e-11, verbose=0)
        jx = jslp.apply(jV.zero())
        jerrs.append(float(j_l2(jV, jx, _exact_any)))
    order = np.log2(errs[0] / errs[1])
    assert order > 2.5, (errs, order)
    assert np.allclose(errs, jerrs, rtol=1e-8), (errs, jerrs)


@pytest.mark.parametrize("name,k,nb", [("MonomialDGFEM", 2, 6), ("OPBFEM", 2, 6),
                                       ("LegendreDGFEM", 2, 9)])
def test_modal_sipg_block_stencil_matches_jax(name, k, nb):
    mesh = tpt.StructuredMesh([0, 0], [1, 1], (6, 6))
    go = tpt.GridOperator(tpt.FunctionSpace(mesh, getattr(tb, name)(k, 2)),
                          TDG(TSinCos(), method=DGMethod.SIPG))
    jmesh = jpt.StructuredMesh([0, 0], [1, 1], (6, 6))
    jgo = jpt.GridOperator(jpt.FunctionSpace(jmesh, getattr(jb, name)(k, 2)),
                           JDG(JSinCos(), method=DGMethod.SIPG))
    tst = tbs.compile_block_stencil(go, dtype=F64)
    jst = jbs.compile_block_stencil(jgo)
    assert tst is not None and jst is not None and tst.nb == nb
    assert np.abs(tst.W_taps - np.asarray(jst.W_taps)).max() <= 1e-12
    assert np.abs(tst.dD_sides - np.asarray(jst.dD_sides)).max() <= 1e-12
