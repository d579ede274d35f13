"""Taylor-Hood and DG (Navier-)Stokes of the port against the JAX package
(fp64, CPU).

  * TaylorHoodNavierStokes (gradient and tensor form, Navier term, the
    stress-Neumann boundary of config10), NavierStokesMass and
    DGNavierStokes (gradient and tensor form, Navier term, slip and
    stress-Neumann faces): residual, J.v, the assembled Jacobian and
    jacobian_diagonal to 1e-12 relative, DG element diagonal blocks too;
  * one application of StokesGMGSchur (triangular and diagonal),
    CahouetChabardSchur at given stage weights (wa, wb), StokesBlockJacobi
    and the warned diagonal fallback on an odd mesh: 1e-10 relative;
  * solves, each against the JAX package's run of the same problem here:
    config5 (2D 8^2, StokesGMGSchur GMRES; models/configs.py), and with
    the pressure-mass Jacobi Schur (mass_cheby=0) the golden's 42
    (tests/golden_parity.json, recorded before StokesGMGSchur gained its
    mass Chebyshev); config10 (134, the golden); the 3D Taylor-Hood problem
    of tests/test_stokes3d.py at 4^3 (_solve3d); the Cahouet-Chabard
    instationary run at 4^2, two steps (_run_cc); the Newton lid-driven
    cavity at 4^2 and the DG Stokes solve at 4^2.
"""
import json
import math
from pathlib import Path

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import dune_pdelab_tpu as jpt
import dune_pdelab_tpu_torch as tpt
from dune_pdelab_tpu import instationary as jinst
from dune_pdelab_tpu.models.configs import config5_stokes_taylor_hood as j_config5
from dune_pdelab_tpu.ops.dgnavierstokes import DGNavierStokes as JDGNS
from dune_pdelab_tpu.ops.stokes import NavierStokesMass as JMass
from dune_pdelab_tpu.ops.stokes import NavierStokesParameters as JParams
from dune_pdelab_tpu.ops.stokes import TaylorHoodNavierStokes as JTH
from dune_pdelab_tpu.solvers import LinearSolverBackend as JBackend
from dune_pdelab_tpu.solvers import NewtonMethod as JNewton
from dune_pdelab_tpu.solvers.stokes import CahouetChabardSchur as JCC
from dune_pdelab_tpu.solvers.stokes import StokesBlockJacobi as JBJ
from dune_pdelab_tpu.solvers.stokes import StokesGMGSchur as JGMG
from dune_pdelab_tpu.solvers.stokes import stokes_constraints as j_stokes_constraints
from dune_pdelab_tpu.solvers.stokes import taylor_hood_space as j_th_space
from dune_pdelab_tpu_torch import instationary as tinst
from dune_pdelab_tpu_torch.ops import (
    DGNavierStokes, NavierStokesMass, NavierStokesParameters, StokesBC,
    TaylorHoodNavierStokes,
)
from dune_pdelab_tpu_torch.solvers import (
    LinearSolverBackend, NewtonMethod, StationaryLinearProblemSolver,
)
from dune_pdelab_tpu_torch.solvers.stokes import (
    CahouetChabardSchur, StokesBlockJacobi, StokesGMGSchur, stokes_constraints,
    taylor_hood_space, velocity_pressure_masks,
)
from dune_pdelab_tpu_torch.space.functions import l2_difference
from dune_pdelab_tpu_torch.utils.common import set_default_device
from test_stokes3d import _run_cc as j_run_cc
from test_stokes3d import _solve3d as j_solve3d

pytestmark = pytest.mark.fast
torch.set_num_threads(1)
set_default_device("cpu")
F64 = torch.float64
GOLDEN = json.loads((Path(__file__).parent / "golden_parity.json").read_text())


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


# -- manufactured solutions (polynomials: numpy arrays and tensors alike) ----
def _a(x):
    return x**2 * (1 - x) ** 2


def _da(x):
    return 2 * x * (1 - x) * (1 - 2 * x)


def _dda(x):
    return 12 * x**2 - 12 * x + 2


def _ddda(x):
    return 24 * x - 12


def _stack(parts, like):
    return (torch.stack(parts, dim=-1) if isinstance(like, torch.Tensor)
            else jnp.stack(parts, axis=-1))


def _f2d(x, mu=1.0):
    """tests/test_stokes.py ManufacturedStokes.f."""
    xx, yy = x[..., 0], x[..., 1]
    f1 = -mu * (_dda(xx) * _da(yy) + _a(xx) * _ddda(yy)) + 3 * xx**2
    f2 = mu * (_ddda(xx) * _a(yy) + _da(xx) * _dda(yy)) + 3 * yy**2
    return _stack([f1, f2], x)


def _f3d(x):
    """tests/test_stokes3d.py _f_stokes."""
    xx, yy, zz = x[..., 0], x[..., 1], x[..., 2]
    lap1 = (_dda(xx) * _da(yy) * _a(zz) + _a(xx) * _ddda(yy) * _a(zz)
            + _a(xx) * _da(yy) * _dda(zz))
    lap2 = -(_ddda(xx) * _a(yy) * _a(zz) + _da(xx) * _dda(yy) * _a(zz)
             + _da(xx) * _a(yy) * _dda(zz))
    return _stack([-lap1 + 3 * xx**2, -lap2 + 3 * yy**2, 3 * zz**2 + 0 * xx], x)


def _u2d(p):
    x, y = p[:, 0], p[:, 1]
    return _stack([_a(x) * _da(y), -_da(x) * _a(y)], p)


def _u3d(p):
    x, y, z = p[:, 0], p[:, 1], p[:, 2]
    return _stack([_a(x) * _da(y) * _a(z), -_da(x) * _a(y) * _a(z), 0 * x], p)


def _params(base, f=None, mu=1.0, rho=0.0, bctype=None, g=None, j=None):
    """A NavierStokesParameters subclass instance of `base` (either package)."""
    class P(base):
        pass
    if f is not None:
        P.f = lambda self, x: f(x)
    if bctype is not None:
        P.bctype = lambda self, x: bctype(x)
    if g is not None:
        P.g = lambda self, x: g(x)
    if j is not None:
        P.j = lambda self, x, n: j(x, n)
    return P(mu=mu, rho=rho)


def _mixed_bc(x):
    """Dirichlet walls, stress-Neumann outflow x = 1, slip bottom y = 0."""
    lib = torch if isinstance(x, torch.Tensor) else jnp
    return lib.where(x[..., 0] > 1 - 1e-10, StokesBC.STRESS_NEUMANN,
                     lib.where(x[..., 1] < 1e-10, StokesBC.SLIP_VELOCITY,
                               StokesBC.VELOCITY_DIRICHLET))


def _g_poly(x):
    return _stack([x[..., 1] * (1 - x[..., 1]), 0.3 * x[..., 0] ** 2], x)


def _j_lin(x, n):
    return 1.3 * n + 0.2 * x


def _mesh(pkg, dim, n, upper=1.0):
    return pkg.StructuredMesh([0.0] * dim, [upper] * dim, (n,) * dim)


def _check_operator(jgo, tgo, seed=0, blocks=False):
    rng = np.random.default_rng(seed)
    n = tgo.space.ndofs
    x, z = rng.standard_normal(n), rng.standard_normal(n)
    xt, zt, xj, zj = torch.from_numpy(x), torch.from_numpy(z), jnp.asarray(x), jnp.asarray(z)
    assert _rel(tgo.residual(xt).numpy(), jgo.residual(xj)) <= 1e-12
    assert _rel(tgo.jacobian_apply(xt, zt).numpy(), jgo.jacobian_apply(xj, zj)) <= 1e-12
    assert _rel(tgo.jacobian_diagonal(xt).numpy(), jgo.jacobian_diagonal(xj)) <= 1e-12
    assert _rel(tgo.jacobian(xt).to_dense().numpy(),
                np.asarray(jgo.jacobian(xj).todense())) <= 1e-12
    if blocks:
        assert _rel(tgo.element_diagonal_blocks(xt).numpy(),
                    jgo.element_diagonal_blocks(xj)) <= 1e-12


@pytest.mark.parametrize("case", ["2d", "2d-tensor-navier", "3d", "2d-outflow"])
def test_taylor_hood_operator_parity(case):
    dim = 3 if case == "3d" else 2
    n = 2 if dim == 3 else 4
    kw = dict(mu=0.7, rho=1.3 if "navier" in case else 0.0,
              f=_f3d if dim == 3 else _f2d)
    if case == "2d-outflow":
        kw.update(bctype=_mixed_bc, g=_g_poly, j=_j_lin)
    tensor = "tensor" in case
    jW, tW = j_th_space(_mesh(jpt, dim, n), 2), taylor_hood_space(_mesh(tpt, dim, n), 2)
    jp, tp = _params(JParams, **kw), _params(NavierStokesParameters, **kw)
    if case == "2d-outflow":
        jc = jpt.constraints((jp.velocity_bctype(), None), jW)
        tc = tpt.constraints((tp.velocity_bctype(), None), tW)
        np.testing.assert_array_equal(tc.mask_np, jc.mask_np)
    else:
        jc, tc = j_stokes_constraints(jW), stokes_constraints(tW)
    jgo = jpt.GridOperator(jW, JTH(jp, tensor_form=tensor), constraints=jc)
    tgo = tpt.GridOperator(tW, TaylorHoodNavierStokes(tp, tensor_form=tensor), constraints=tc)
    _check_operator(jgo, tgo)


def test_navier_stokes_mass_parity():
    jW, tW = j_th_space(_mesh(jpt, 2, 3), 2), taylor_hood_space(_mesh(tpt, 2, 3), 2)
    jgo = jpt.GridOperator(jW, JMass(rho=1.7), constraints=j_stokes_constraints(jW))
    tgo = tpt.GridOperator(tW, NavierStokesMass(rho=1.7), constraints=stokes_constraints(tW))
    _check_operator(jgo, tgo, seed=1)
    vmask, pmask = velocity_pressure_masks(tW)
    assert vmask.sum() == 2 * 7 * 7 and pmask.sum() == 16


def _dg_space(pkg, n, kv=2, kp=1):
    mesh = _mesh(pkg, 2, n)
    Vv = pkg.FunctionSpace(mesh, pkg.QkDGFEM(kv, 2))
    Vp = pkg.FunctionSpace(mesh, pkg.QkDGFEM(kp, 2))
    return pkg.CompositeSpace(pkg.PowerSpace(Vv, 2), Vp)


@pytest.mark.parametrize("case", ["gradient", "tensor-navier-mixed-bc"])
def test_dg_navier_stokes_parity(case):
    kw = dict(mu=0.8, rho=1.1 if "navier" in case else 0.0, f=_f2d, g=_g_poly)
    if "mixed" in case:
        kw.update(bctype=_mixed_bc, j=_j_lin)
    opts = dict(tensor_form="tensor" in case, incomp_scaling=2.0, theta=-1.0)
    jW, tW = _dg_space(jpt, 3), _dg_space(tpt, 3)
    jgo = jpt.GridOperator(jW, JDGNS(_params(JParams, **kw), **opts))
    tgo = tpt.GridOperator(tW, DGNavierStokes(_params(NavierStokesParameters, **kw), **opts))
    _check_operator(jgo, tgo, seed=2, blocks=True)


def _stokes_pair(n, mu=1.0):
    """(JAX (W, go), port (W, go)) of config5's operator on n^2 cells."""
    jW, tW = j_th_space(_mesh(jpt, 2, n), 2), taylor_hood_space(_mesh(tpt, 2, n), 2)
    jgo = jpt.GridOperator(jW, JTH(_params(JParams, f=_f2d, mu=mu)),
                           constraints=j_stokes_constraints(jW))
    tgo = tpt.GridOperator(tW, TaylorHoodNavierStokes(_params(NavierStokesParameters,
                                                              f=_f2d, mu=mu)),
                           constraints=stokes_constraints(tW))
    return (jW, jgo), (tW, tgo)


def _check_precond(jpre, tpre, jgo, tgo, x, time_j=0.0, time_t=0.0, seed=3):
    r = np.random.default_rng(seed).standard_normal(tgo.space.ndofs)
    zj = jpre(jgo, jnp.asarray(x), time_j)(jnp.asarray(r))
    zt = tpre(tgo, torch.from_numpy(x), time_t)(torch.from_numpy(r))
    assert _rel(zt.numpy(), zj) <= 1e-10


def test_stokes_preconditioner_parity():
    (jW, jgo), (tW, tgo) = _stokes_pair(8, mu=0.9)
    x = np.random.default_rng(4).standard_normal(tW.ndofs)
    _check_precond(JGMG(jW, mu=0.9), StokesGMGSchur(tW, mu=0.9), jgo, tgo, x)
    _check_precond(JGMG(jW, mu=0.9, triangular=False, mass_cheby=0),
                   StokesGMGSchur(tW, mu=0.9, triangular=False, mass_cheby=0), jgo, tgo, x)
    _check_precond(JBJ(jW, mu=0.9), StokesBlockJacobi(tW, mu=0.9), jgo, tgo, x)


def test_cahouet_chabard_parity():
    """CahouetChabardSchur at stage weights (wa, wb) = (1, 0.02) through
    the stage operator, and its stationary fallback."""
    (jW, jgo), (tW, tgo) = _stokes_pair(8)
    jm = jpt.GridOperator(jW, JMass(), constraints=jgo.cg)
    tm = tpt.GridOperator(tW, NavierStokesMass(), constraints=tgo.cg)
    jigo, tigo = jinst.OneStepGridOperator(jgo, jm), tinst.OneStepGridOperator(tgo, tm)
    x = np.random.default_rng(5).standard_normal(tW.ndofs)
    jsc = jinst.StageContext(t=0.0, wa=1.0, wb=0.02, const=jnp.zeros(jW.ndofs))
    tsc = tinst.StageContext(t=0.0, wa=1.0, wb=0.02, const=torch.zeros(tW.ndofs, dtype=F64))
    jpre, tpre = JCC(jW, mu=1.0, rho=1.0), CahouetChabardSchur(tW, mu=1.0, rho=1.0)
    _check_precond(jpre, tpre, jigo, tigo, x, jsc, tsc)
    _check_precond(jpre, tpre, jgo, tgo, x)


def test_stokes_fallback_warns_and_matches():
    """Odd cell counts have no lattice hierarchy: the diagonal fallback
    warns (tests/test_stokes3d.py:test_stokes_fallback_warns) and equals
    the JAX package's."""
    jW, tW = j_th_space(_mesh(jpt, 2, 5), 2), taylor_hood_space(_mesh(tpt, 2, 5), 2)
    with pytest.warns(UserWarning, match="diagonal Jacobi"):
        tpre = StokesGMGSchur(tW)
    assert tpre._vgmg is None
    with pytest.warns(UserWarning, match="diagonal Jacobi"):
        jpre = JGMG(jW)
    jgo = jpt.GridOperator(jW, JTH(JParams()), constraints=j_stokes_constraints(jW))
    tgo = tpt.GridOperator(tW, TaylorHoodNavierStokes(NavierStokesParameters()),
                           constraints=stokes_constraints(tW))
    _check_precond(jpre, tpre, jgo, tgo, np.zeros(tW.ndofs))


def _velocity_l2(W, x, exact):
    Vv = W.children[0].children[0]
    err2 = 0.0
    for c in range(W.children[0].k):
        xc = W.children[0].restrict(W.restrict(x, 0), c)
        err2 += float(l2_difference(Vv, xc, lambda p, c=c: exact(p)[:, c])) ** 2
    return math.sqrt(err2)


def _config5(mass_cheby):
    """config5's recipe on the port with StokesGMGSchur's mass_cheby set."""
    W = taylor_hood_space(_mesh(tpt, 2, 8), 2)
    go = tpt.GridOperator(W, TaylorHoodNavierStokes(_params(NavierStokesParameters, f=_f2d)),
                          constraints=stokes_constraints(W))
    ls = LinearSolverBackend(solver="gmres",
                             precond=StokesGMGSchur(W, mu=1.0, mass_cheby=mass_cheby),
                             restart=100, maxiter=20000)
    slp = StationaryLinearProblemSolver(go, ls, reduction=1e-9, verbose=0)
    x = slp.apply(W.zero(F64))
    assert slp.result.converged and W.ndofs == GOLDEN["config5_stokes_taylor_hood"]["ndofs"]
    return slp.result.linear_solver_iterations, _velocity_l2(W, x, _u2d)


def test_config5():
    """The port's ALL_CONFIGS["config5"] against the JAX package's count and
    error (its config5 run here); the golden's 42 with the Jacobi
    pressure-mass Schur it was recorded with (config5's recipe, mass_cheby=0)."""
    from dune_pdelab_tpu_torch.models import ALL_CONFIGS

    got = ALL_CONFIGS["config5"]()
    assert got["converged"] and got["ndofs"] == GOLDEN["config5_stokes_taylor_hood"]["ndofs"]
    its, l2 = got["iterations"], got["velocity_l2_error"]
    jax_run = j_config5()
    assert jax_run["converged"] and jax_run["ndofs"] == GOLDEN["config5_stokes_taylor_hood"]["ndofs"]
    assert its == jax_run["iterations"]
    assert l2 == pytest.approx(jax_run["velocity_l2_error"], rel=1e-8)
    want = GOLDEN["config5_stokes_taylor_hood"]
    its, l2 = _config5(mass_cheby=0)
    assert its == want["iterations"]
    assert l2 == pytest.approx(want["velocity_l2_error"], rel=1e-8)


def test_config10_golden():
    """The port's models/configs.py config10_stokes_outflow: Poiseuille
    with a stress-Neumann outflow, StokesBlockJacobi GMRES."""
    from dune_pdelab_tpu_torch.models import ALL_CONFIGS

    want = GOLDEN["config10_stokes_outflow"]
    got = ALL_CONFIGS["config10"]()
    assert got["converged"] and got["ndofs"] == want["ndofs"]
    assert got["iterations"] == want["iterations"]
    assert got["l2_v_error"] == pytest.approx(want["l2_v_error"], rel=1e-8, abs=1e-9)
    assert got["l2_p_error"] == pytest.approx(want["l2_p_error"], rel=1e-8, abs=1e-9)


def test_stokes3d_gmres_matches_jax():
    """tests/test_stokes3d.py _solve3d(4) on the port: unpinned pressure,
    triangular StokesGMGSchur on real GMG, GMRES(100) to 1e-8."""
    W = taylor_hood_space(_mesh(tpt, 3, 4), 2)
    go = tpt.GridOperator(W, TaylorHoodNavierStokes(_params(NavierStokesParameters, f=_f3d)),
                          constraints=stokes_constraints(W, pin_pressure=False))
    pre = StokesGMGSchur(W, mu=1.0, triangular=True)
    assert pre._vgmg is not None
    ls = LinearSolverBackend(solver="gmres", precond=pre, restart=100, maxiter=2000)
    slp = StationaryLinearProblemSolver(go, ls, reduction=1e-8, verbose=0)
    x = slp.apply(W.zero(F64))
    j_its, j_conv, j_l2, j_pre = j_solve3d(4)
    assert slp.result.converged and j_conv and j_pre._vgmg is not None
    assert slp.result.linear_solver_iterations == j_its
    assert _velocity_l2(W, x, _u3d) == pytest.approx(j_l2, rel=1e-8)


def test_cahouet_chabard_instationary():
    """tests/test_stokes3d.py _run_cc(n=4, T=0.04) on the port: implicit
    Euler, two steps of 0.02, CahouetChabardSchur GMRES(150) to 1e-9."""
    def f(self, x):
        xx, yy = x[..., 0], x[..., 1]
        f1 = -(_dda(xx) * _da(yy) + _a(xx) * _ddda(yy)) + 3 * xx**2
        f2 = (_ddda(xx) * _a(yy) + _da(xx) * _dda(yy)) + 3 * yy**2
        u1, u2 = _a(xx) * _da(yy), -_da(xx) * _a(yy)
        return math.exp(-self.time) * torch.stack([f1 - u1, f2 - u2], dim=-1)

    class Decaying(NavierStokesParameters):
        pass
    Decaying.f = f
    prm = Decaying(mu=1.0, rho=1.0)
    W = taylor_hood_space(_mesh(tpt, 2, 4), 2)
    cgm = stokes_constraints(W, bctype=True, pin_pressure=True)
    go_s = tpt.GridOperator(W, TaylorHoodNavierStokes(prm), constraints=cgm)
    go_t = tpt.GridOperator(W, NavierStokesMass(rho=1.0), constraints=cgm)
    ls = LinearSolverBackend(solver="gmres", precond=CahouetChabardSchur(W, mu=1.0, rho=1.0),
                             restart=150, maxiter=20000)
    osm = tinst.OneStepMethod(tinst.one_step_theta(1.0), go_s, go_t, ls,
                              pdesolver="linear", reduction=1e-9)
    x = W.interpolate((_u2d, lambda p: p[:, 0] ** 3 + p[:, 1] ** 3 - 0.5), dtype=F64)
    t, steps = 0.0, 0
    while t < 0.04 - 1e-12:
        x = osm.apply(t, 0.02, x)
        t += 0.02
        steps += 1
    its = osm.result.total_linear_iterations / max(
        1, osm.result.total_newton_iterations + steps)
    err = _velocity_l2(W, x, lambda p: math.exp(-t) * _u2d(p))
    j_err, j_its, _ = j_run_cc(n=4, T=0.04)
    assert its == pytest.approx(j_its, abs=1e-12)
    assert err == pytest.approx(j_err, rel=1e-8)
    assert its <= 80


def test_navier_stokes_cavity_newton_matches_jax():
    """tests/test_stokes.py:test_navier_stokes_cavity_newton (at 4^2) on
    both packages: Newton and GMRES counts equal, solutions to 1e-8."""
    def run(pkg, params_base, newton, backend, bj, space, constr, zero, asarray):
        W = space(_mesh(pkg, 2, 4), degree=2)
        go = pkg.GridOperator(W, (JTH if pkg is jpt else TaylorHoodNavierStokes)(
            _params(params_base, mu=0.01, rho=1.0)), constraints=constr(W, bctype=True,
                                                                        pin_pressure=True))
        ls = backend(solver="gmres", precond=bj(W, mu=0.01), restart=150, maxiter=30000)
        nm = newton(go, ls, reduction=1e-8, verbose=0, min_linear_reduction=1e-4)
        coords = W.children[0].children[0].dof_coords()
        lid = np.isclose(coords[:, 1], 1.0)
        ux = np.where(lid, 4 * coords[:, 0] * (1 - coords[:, 0]), 0.0)
        x0 = zero(W)
        x0 = W.embed(x0, 0, W.children[0].embed(W.restrict(x0, 0), 0, asarray(ux)))
        x = nm.apply(x0)
        assert nm.result.converged
        return np.asarray(x), nm.result.iterations, nm.result.linear_solver_iterations

    xj, nj, lj = run(jpt, JParams, JNewton, JBackend, JBJ, j_th_space,
                     j_stokes_constraints, lambda W: W.zero(), jnp.asarray)
    xt, nt, lt = run(tpt, NavierStokesParameters, NewtonMethod, LinearSolverBackend,
                     StokesBlockJacobi, taylor_hood_space, stokes_constraints,
                     lambda W: W.zero(F64), torch.from_numpy)
    assert (nt, lt) == (nj, lj)
    assert _rel(xt, xj) <= 1e-8
    assert 0.0 < float(np.abs(xt[:9 * 9]).max()) <= 1.01


def test_dg_stokes_solve_matches_jax():
    """tests/test_dgstokes.py _solve(4) on both packages: DGNavierStokes on
    Q2dg/Q1dg with one pinned pressure DOF, block-Jacobi GMRES(150)."""
    def run(pkg, op, params_base, backend, constr_cls, zero):
        W = _dg_space(pkg, 4)
        mask = np.zeros(W.ndofs, dtype=bool)
        mask[int(W.child_global(1, np.array([0]))[0])] = True
        go = pkg.GridOperator(W, op(_params(params_base, f=_f2d)), constraints=constr_cls(mask))
        ls = backend(solver="gmres", precond="block_jacobi", restart=150, maxiter=40000)
        slp = pkg.StationaryLinearProblemSolver(go, ls, reduction=1e-9, verbose=0)
        x = slp.apply(zero(W))
        assert slp.result.converged
        return np.asarray(x), slp.result.linear_solver_iterations

    xj, ij = run(jpt, JDGNS, JParams, JBackend, jpt.DirichletConstraints, lambda W: W.zero())
    xt, it = run(tpt, DGNavierStokes, NavierStokesParameters, LinearSolverBackend,
                 lambda m: tpt.DirichletConstraints(m, device="cpu"), lambda W: W.zero(F64))
    assert it == ij
    assert _rel(xt, xj) <= 1e-8
