"""Cell-centered finite volumes, Darcy post-processing and combined
operators of the port against the JAX package (fp64).

  * ConvectionDiffusionCCFV with variable A, b != 0, c != 0 and Dirichlet,
    Neumann and outflow faces: residual and J.v at a random x, 2D 16^2 and
    3D 5x4x6 (1e-12 relative); the block stencil of the operator
    (nb = 1, compile_block_stencil: W_taps, dD_sides) at 16^2 and 6^3
    (1e-12); the solver's report names the block-stencil tier;
  * the four tests of tests/test_ccfv.py on the port at their sizes;
  * six tests of tests/test_darcy.py on the port at their sizes: the five
    Darcy tests and the linear limit of the nonlinear kernel (its Newton
    convergence test belongs to the nonlinear kernel's own slice and takes
    ~70 s on the port here);
  * the RT0 reconstruction's local conservation with K discontinuous
    between a face and a cell center (examples/09's quarter-five-spot at
    16^2), where the JAX package's face-center K violates it;
  * CombinedOperator (mass + diffusion, weights 0.5 and 2) and
    ScaledOperator residuals and J.v against the JAX package's (1e-12).
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

import dune_pdelab_tpu as jpt
import dune_pdelab_tpu_torch as tpt
from dune_pdelab_tpu.assembly import blockstencil as jbs
from dune_pdelab_tpu.fe import P0FEM as JP0
from dune_pdelab_tpu.fe import QkFEM as JQk
from dune_pdelab_tpu.ops import CombinedOperator as JCombined
from dune_pdelab_tpu.ops import ConvectionDiffusionCCFV as JCCFV
from dune_pdelab_tpu.ops import ConvectionDiffusionFEM as JFEM
from dune_pdelab_tpu.ops import ConvectionDiffusionProblem as JProblem
from dune_pdelab_tpu.ops import L2 as JL2
from dune_pdelab_tpu.ops import ScaledOperator as JScaled
from dune_pdelab_tpu_torch.assembly import blockstencil as tbs
from dune_pdelab_tpu_torch.fe import P0FEM, QkFEM
from dune_pdelab_tpu_torch.ops import (
    BCType, CombinedOperator, ConvectionDiffusionCCFV, ConvectionDiffusionFEM,
    ConvectionDiffusionProblem, DarcyVelocityFromHeadCCFV, DarcyVelocityFromHeadFEM,
    L2, NonlinearConvectionDiffusionFEM, NonlinearConvectionDiffusionProblem,
    ScaledOperator, diagonal_permeability_field, permeability_field,
)
from dune_pdelab_tpu_torch.solvers import (
    SEQ_BCGS_Jacobi, SEQ_CG_Jacobi, StationaryLinearProblemSolver,
)
from dune_pdelab_tpu_torch.utils.common import set_default_device

pytestmark = pytest.mark.fast
torch.set_num_threads(1)
set_default_device("cpu")
F64 = torch.float64
REL = 1e-12


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _bct(x):
    """Dirichlet on x = 0, Neumann on y = 0, outflow elsewhere (numpy,
    jax and torch arrays alike)."""
    left = x[..., 0] < 1e-9
    bottom = x[..., 1] < 1e-9
    return 2 - 1 * left - 2 * (bottom & ~left)


class JMixed(JProblem):
    def A(self, x):
        return 1.0 + 0.5 * x[..., 0] + 0.25 * x[..., 1]

    def b(self, x):
        return jnp.broadcast_to(jnp.asarray([1.0, -0.5, 0.25][:x.shape[-1]]), x.shape)

    def c(self, x):
        return 0.3

    def f(self, x):
        return jnp.sin(3.0 * x[..., 0]) + x[..., 1]

    def bctype(self, x):
        return _bct(x)

    def g(self, x):
        return x[..., 0] * x[..., 1] + 0.5

    def j(self, x):
        return 0.3 + x[..., 0]

    def o(self, x):
        return 0.1 * x[..., 1]


class TMixed(ConvectionDiffusionProblem):
    def A(self, x):
        return 1.0 + 0.5 * x[..., 0] + 0.25 * x[..., 1]

    def b(self, x):
        return torch.broadcast_to(torch.tensor([1.0, -0.5, 0.25][:x.shape[-1]],
                                               dtype=x.dtype), x.shape)

    def c(self, x):
        return 0.3

    def f(self, x):
        return torch.sin(3.0 * x[..., 0]) + x[..., 1]

    def bctype(self, x):
        return _bct(x)

    def g(self, x):
        return x[..., 0] * x[..., 1] + 0.5

    def j(self, x):
        return 0.3 + x[..., 0]

    def o(self, x):
        return 0.1 * x[..., 1]


def _pair(cells, jlop, tlop, jfem=None, tfem=None):
    dim = len(cells)
    lo, hi = [0.0] * dim, [1.0] * dim
    jfem = jfem or JP0(dim)
    tfem = tfem or P0FEM(dim)
    jgo = jpt.GridOperator(jpt.FunctionSpace(jpt.StructuredMesh(lo, hi, cells), jfem), jlop)
    tgo = tpt.GridOperator(tpt.FunctionSpace(tpt.StructuredMesh(lo, hi, cells), tfem), tlop)
    return jgo, tgo


def _check_residual_and_jv(jgo, tgo, seed):
    rng = np.random.default_rng(seed)
    x, z = rng.standard_normal((2, tgo.space.ndofs))
    xt, zt = torch.as_tensor(x), torch.as_tensor(z)
    assert _rel(tgo.residual(xt), jgo.residual(jnp.asarray(x))) <= REL
    assert _rel(tgo.jacobian_apply(xt, zt),
                jgo.jacobian_apply(jnp.asarray(x), jnp.asarray(z))) <= REL


@pytest.mark.parametrize("cells", [(16, 16), (5, 4, 6)])
def test_ccfv_residual_and_jv_match_jax(cells):
    jgo, tgo = _pair(cells, JCCFV(JMixed()), ConvectionDiffusionCCFV(TMixed()))
    _check_residual_and_jv(jgo, tgo, 11)


@pytest.mark.parametrize("cells", [(16, 16), (6, 6, 6)])
def test_ccfv_block_stencil_nb1_matches_jax(cells):
    jgo, tgo = _pair(cells, JCCFV(JMixed()), ConvectionDiffusionCCFV(TMixed()))
    jst = jbs.compile_block_stencil(jgo)
    tst = tbs.compile_block_stencil(tgo, dtype=F64)
    # A varies in space, so neither package's stencil applies: both decline
    assert jst is None and tst is None
    jgo, tgo = _pair(cells, JCCFV(JSpatialConst()), ConvectionDiffusionCCFV(TSpatialConst()))
    jst = jbs.compile_block_stencil(jgo)
    tst = tbs.compile_block_stencil(tgo, dtype=F64)
    assert tst.nb == 1 and tst.W_taps.shape == (2 * len(cells) + 1, 1, 1)
    assert np.abs(tst.W_taps - np.asarray(jst.W_taps)).max() <= 1e-12
    assert np.abs(tst.dD_sides - np.asarray(jst.dD_sides)).max() <= 1e-12
    z = torch.as_tensor(np.random.default_rng(5).standard_normal(tgo.space.ndofs))
    assert _rel(tst(z), tgo.jacobian_apply(torch.zeros_like(z), z)) <= REL


class JSpatialConst(JProblem):
    """Constant A and b (translation invariant) with Dirichlet, Neumann and
    outflow faces."""

    def A(self, x):
        return 2.0

    def b(self, x):
        return jnp.broadcast_to(jnp.asarray([0.5, -0.25, 0.125][:x.shape[-1]]), x.shape)

    def bctype(self, x):
        return _bct(x)


class TSpatialConst(ConvectionDiffusionProblem):
    def A(self, x):
        return 2.0

    def b(self, x):
        return torch.broadcast_to(torch.tensor([0.5, -0.25, 0.125][:x.shape[-1]],
                                               dtype=x.dtype), x.shape)

    def bctype(self, x):
        return _bct(x)


# -- tests/test_ccfv.py on the port -----------------------------------------
class Diff(ConvectionDiffusionProblem):
    def exact(self, p):
        return np.sin(np.pi * p[:, 0]) * np.sin(np.pi * p[:, 1])

    def f(self, x):
        return 2 * np.pi**2 * torch.sin(np.pi * x[..., 0]) * torch.sin(np.pi * x[..., 1])


def _solve(problem, n, solver=None):
    mesh = tpt.StructuredMesh([0, 0], [1, 1], (n, n))
    V = tpt.FunctionSpace(mesh, P0FEM(2))
    go = tpt.GridOperator(V, ConvectionDiffusionCCFV(problem))
    backend = solver or SEQ_CG_Jacobi()
    slp = StationaryLinearProblemSolver(go, backend, reduction=1e-12)
    x = slp.apply(V.zero(dtype=F64))
    assert "compiled block stencil BlockStencilOperator" in backend.report(go), \
        backend.report(go)
    return mesh, V, x, slp


def test_ccfv_diffusion_convergence():
    p = Diff()
    errs = []
    for n in (8, 16, 32):
        mesh, V, x, slp = _solve(p, n)
        assert slp.result.converged
        centers = mesh.element_centers()
        errs.append(float(np.sqrt(np.mean((x.numpy() - p.exact(centers)) ** 2))))
    order = np.log2(errs[-2] / errs[-1])
    assert order > 1.7, (errs, order)   # cell-center superconvergence


def test_ccfv_upwind_transport_monotone():
    """Pure upwinded advection: the solution stays within inflow bounds."""
    class T(ConvectionDiffusionProblem):
        def A(self, x):
            return 1e-8

        def b(self, x):
            return torch.broadcast_to(torch.tensor([1.0, 0.3], dtype=x.dtype), x.shape)

        def g(self, x):
            return torch.where(x[..., 0] < 1e-12, 1.0, 0.0)

    mesh, V, x, slp = _solve(T(), 16, solver=SEQ_BCGS_Jacobi())
    assert slp.result.converged
    assert float(x.min()) > -1e-6
    assert float(x.max()) < 1.0 + 1e-6


def test_ccfv_heterogeneous_tpfa_exact():
    """Two-layer diffusion, K = k1 (x < 0.5), k2 (x >= 0.5): harmonic TPFA
    with A at the cell centers (convectiondiffusionccfv.hh:152-160) is exact
    at the cell centers when the interface is a face. A varies in space, so
    the stencil tier declines and the solve takes the general jvp."""
    k1, k2 = 1.0, 10.0

    class TwoLayer(ConvectionDiffusionProblem):
        def A(self, x):
            return torch.where(x[..., 0] < 0.5, k1, k2)

        def bctype(self, x):
            on_x = (x[..., 0] < 1e-12) | (x[..., 0] > 1 - 1e-12)
            return np.where(np.asarray(on_x), 1, 0) if not isinstance(
                x, torch.Tensor) else torch.where(on_x, 1, 0)

        def g(self, x):
            return torch.where(x[..., 0] > 0.5, 1.0, 0.0)

    mesh = tpt.StructuredMesh([0, 0], [1, 1], (16, 16))
    V = tpt.FunctionSpace(mesh, P0FEM(2))
    go = tpt.GridOperator(V, ConvectionDiffusionCCFV(TwoLayer()))
    slp = StationaryLinearProblemSolver(go, SEQ_CG_Jacobi(), reduction=1e-12)
    x = slp.apply(V.zero(dtype=F64))
    assert slp.result.converged
    q = 1.0 / (0.5 / k1 + 0.5 / k2)      # exact interface flux
    c = mesh.element_centers()
    xe = np.where(c[:, 0] < 0.5, q * c[:, 0] / k1,
                  0.5 * q / k1 + q * (c[:, 0] - 0.5) / k2)
    assert np.max(np.abs(x.numpy() - xe)) < 1e-9, np.max(np.abs(x.numpy() - xe))


def test_ccfv_max_speed_cfl_hook():
    class T(ConvectionDiffusionProblem):
        def b(self, x):
            return torch.broadcast_to(torch.tensor([2.0, -0.5], dtype=x.dtype), x.shape)

    assert abs(ConvectionDiffusionCCFV(T()).max_speed() - 2.0) < 1e-12

    class Var(ConvectionDiffusionProblem):
        def b(self, x):
            return torch.stack([1.0 + x[..., 0], 0 * x[..., 1]], -1)

    with pytest.raises(ValueError):
        ConvectionDiffusionCCFV(Var()).max_speed()
    mesh = tpt.StructuredMesh([0, 0], [1, 1], (4, 4))
    assert abs(ConvectionDiffusionCCFV(Var()).max_speed(mesh=mesh) - 1.875) < 1e-12


# -- tests/test_darcy.py on the port ----------------------------------------
class _TensorHead(ConvectionDiffusionProblem):
    """u = 2x + 3y with anisotropic K: Darcy velocity (-4, -1.5)."""

    def A(self, x):
        d = x.shape[-1]
        A = torch.zeros(x.shape[:-1] + (d, d), dtype=x.dtype)
        A[..., 0, 0] = 2.0
        A[..., 1, 1] = 0.5
        return A

    def g(self, x):
        return 2 * x[..., 0] + 3 * x[..., 1]


def test_darcy_fem_exact_on_linear_head():
    p = _TensorHead()
    mesh = tpt.StructuredMesh([0, 0], [1, 1], (6, 5))
    V = tpt.FunctionSpace(mesh, QkFEM(1, 2))
    x = V.interpolate(lambda pts: 2 * pts[:, 0] + 3 * pts[:, 1], dtype=F64)
    dv = DarcyVelocityFromHeadFEM(p, V, x)
    assert np.allclose(dv.at_centers().numpy(), [-4.0, -1.5], atol=1e-12)
    err = float(dv.l2_difference(lambda pts: np.broadcast_to([-4.0, -1.5], pts.shape)))
    assert err < 1e-12


def test_darcy_ccfv_exact_on_linear_head():
    class P(ConvectionDiffusionProblem):
        def g(self, x):
            return x[..., 0]

    mesh = tpt.StructuredMesh([0, 0], [1, 1], (8, 4))
    u = mesh.element_centers()[:, 0]            # exact P0 head u = x
    dv = DarcyVelocityFromHeadCCFV(mesh, P(), u)
    vx, vy = dv.face_normal_velocities()
    assert np.allclose(vx, -1.0, atol=1e-13)
    assert np.allclose(vy, 0.0, atol=1e-13)
    assert np.allclose(dv.at_centers(), [-1.0, 0.0], atol=1e-13)
    assert np.allclose(dv.cell_divergence(), 0.0, atol=1e-11)


def test_darcy_ccfv_local_conservation():
    """div(v_RT0) of a converged TPFA solve equals the midpoint source."""
    p = Diff()
    mesh = tpt.StructuredMesh([0, 0], [1, 1], (16, 16))
    V = tpt.FunctionSpace(mesh, P0FEM(2))
    go = tpt.GridOperator(V, ConvectionDiffusionCCFV(p))
    slp = StationaryLinearProblemSolver(go, SEQ_CG_Jacobi(), reduction=1e-13)
    x = slp.apply(V.zero(dtype=F64))
    assert slp.result.converged
    div = DarcyVelocityFromHeadCCFV(mesh, p, x).cell_divergence()
    fmid = p.f(torch.as_tensor(mesh.element_centers())).numpy()
    assert np.max(np.abs(div - fmid)) < 1e-8 * np.max(np.abs(fmid))


def test_darcy_ccfv_3d_conservation():
    class P(ConvectionDiffusionProblem):
        def A(self, x):
            return 2.0

        def g(self, x):
            return x[..., 2]

    mesh = tpt.StructuredMesh([0, 0, 0], [1, 1, 1], (4, 5, 6))
    u = mesh.element_centers()[:, 2]
    dv = DarcyVelocityFromHeadCCFV(mesh, P(), u)
    vx, vy, vz = dv.face_normal_velocities()
    assert np.allclose(vx, 0.0, atol=1e-13)
    assert np.allclose(vy, 0.0, atol=1e-13)
    assert np.allclose(vz, -2.0, atol=1e-12)
    assert np.allclose(dv.at_centers(), [0.0, 0.0, -2.0], atol=1e-12)
    assert np.allclose(dv.cell_divergence(), 0.0, atol=1e-10)


class _FiveSpot(ConvectionDiffusionProblem):
    """examples/09's quarter-five-spot: head 1 -> 0 from left to right, no
    flow through top and bottom, K = 1e-3 inside |x - 0.5|, |y - 0.5| <
    0.15. At 16^2 the inclusion's edge x = 0.35 lies between the face at
    5/16 and the cell center at 5.5/16."""

    def A(self, x):
        inside = (torch.abs(x[..., 0] - 0.5) < 0.15) & (torch.abs(x[..., 1] - 0.5) < 0.15)
        return torch.where(inside, 1e-3, 1.0).to(x.dtype)

    def bctype(self, x):
        on_x = (x[..., 0] < 1e-12) | (x[..., 0] > 1 - 1e-12)
        return torch.where(on_x, BCType.DIRICHLET, BCType.NEUMANN)

    def g(self, x):
        return 1.0 - x[..., 0]

    def j(self, x):
        return 0.0


class _JFiveSpot(JProblem):
    def A(self, x):
        inside = (jnp.abs(x[..., 0] - 0.5) < 0.15) & (jnp.abs(x[..., 1] - 0.5) < 0.15)
        return jnp.where(inside, 1e-3, 1.0)

    def bctype(self, x):
        on_x = (x[..., 0] < 1e-12) | (x[..., 0] > 1 - 1e-12)
        return jnp.where(on_x, BCType.DIRICHLET, BCType.NEUMANN)

    def g(self, x):
        return 1.0 - x[..., 0]

    def j(self, x):
        return 0.0


def test_darcy_ccfv_conservation_discontinuous_k():
    """The port's reconstruction reproduces the solver's fluxes where K
    jumps between a face and a cell center (harmonic mean of the cell
    centers' K, as ops/ccfv.py): div v = 0 per cell to solver tolerance and
    inflow = outflow. The JAX package's reconstruction of its own head
    takes K at the face center (dune_pdelab_tpu/ops/darcy.py:132) and
    violates conservation there: the deliberate difference."""
    from dune_pdelab_tpu.ops import DarcyVelocityFromHeadCCFV as JDarcy
    from dune_pdelab_tpu.solvers import SEQ_CG_Jacobi as JCG

    n = 16
    mesh = tpt.StructuredMesh([0, 0], [1, 1], (n, n))
    V = tpt.FunctionSpace(mesh, P0FEM(2))
    p = _FiveSpot()
    slp = StationaryLinearProblemSolver(tpt.GridOperator(V, ConvectionDiffusionCCFV(p)),
                                        SEQ_CG_Jacobi(), reduction=1e-13)
    head = slp.apply(V.zero(dtype=F64))
    assert slp.result.converged
    rt0 = DarcyVelocityFromHeadCCFV(mesh, p, head)
    vx, vy = rt0.face_normal_velocities()
    vmax = max(np.abs(vx).max(), np.abs(vy).max())
    assert np.max(np.abs(rt0.cell_divergence())) < 1e-8 * vmax
    inflow, outflow = vx[:, 0].sum() / n, vx[:, -1].sum() / n
    assert abs(inflow - outflow) < 1e-10 * abs(inflow)

    jmesh = jpt.StructuredMesh([0, 0], [1, 1], (n, n))
    jV = jpt.FunctionSpace(jmesh, JP0(2))
    jp = _JFiveSpot()
    jhead = jpt.StationaryLinearProblemSolver(
        jpt.GridOperator(jV, JCCFV(jp)), JCG(), reduction=1e-13).apply(jV.zero())
    assert _rel(head.numpy(), np.asarray(jhead)) < 1e-9
    jdiv = np.asarray(JDarcy(jmesh, jp, jhead).cell_divergence())
    assert np.max(np.abs(jdiv)) > 1e-2 * vmax


def test_permeability_adapters():
    p = _TensorHead()
    mesh = tpt.StructuredMesh([0, 0], [1, 1], (4, 4))
    k = permeability_field(mesh, p)
    assert k.shape == (16,) and np.allclose(k, np.log10(2.0))
    kd = diagonal_permeability_field(mesh, p)
    assert kd.shape == (16, 2)
    assert np.allclose(kd[:, 0], np.log10(2.0))
    assert np.allclose(kd[:, 1], np.log10(0.5))


def test_nlcd_linear_limit_matches_linear_kernel():
    """With w(u)=u, v=1, q=u*b the nonlinear kernel reproduces the linear
    ConvectionDiffusionFEM residual."""
    beta = torch.tensor([0.7, -0.4], dtype=F64)

    class Lin(ConvectionDiffusionProblem):
        def b(self, x):
            return torch.broadcast_to(beta, x.shape)

        def f(self, x):
            return torch.sin(3 * x[..., 0]) + x[..., 1]

    class NL(NonlinearConvectionDiffusionProblem):
        def q(self, x, u):
            return u[..., None] * torch.broadcast_to(beta, x.shape)

        def f(self, x, u):
            return torch.sin(3 * x[..., 0]) + x[..., 1]

    mesh = tpt.StructuredMesh([0, 0], [1, 1], (7, 6))
    V = tpt.FunctionSpace(mesh, QkFEM(1, 2))
    cg_ = tpt.constraints(True, V)
    go_lin = tpt.GridOperator(V, ConvectionDiffusionFEM(Lin()), constraints=cg_)
    go_nl = tpt.GridOperator(V, NonlinearConvectionDiffusionFEM(NL(), quadrature_add=0),
                             constraints=cg_)
    x = torch.as_tensor(np.random.default_rng(3).standard_normal(V.ndofs))
    assert np.allclose(go_lin.residual(x).numpy(), go_nl.residual(x).numpy(), atol=1e-12)


# -- CombinedOperator / ScaledOperator --------------------------------------
@pytest.mark.parametrize("which", ["combined", "scaled"])
def test_combined_and_scaled_operators_match_jax(which):
    if which == "combined":
        jlop = JCombined([JL2(), JFEM(JMixed())], [0.5, 2.0])
        tlop = CombinedOperator([L2(), ConvectionDiffusionFEM(TMixed())], [0.5, 2.0])
    else:
        jlop, tlop = JScaled(JFEM(JMixed()), -1.5), ScaledOperator(
            ConvectionDiffusionFEM(TMixed()), -1.5)
    assert tlop.is_linear and hasattr(tlop, "alpha_boundary")
    assert not hasattr(tlop, "alpha_skeleton")
    jgo, tgo = _pair((5, 4), jlop, tlop, JQk(2, 2), QkFEM(2, 2))
    _check_residual_and_jv(jgo, tgo, 13)
