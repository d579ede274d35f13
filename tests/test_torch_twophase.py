"""Two-phase flow of the port (ops/twophase.py) against the JAX package
(fp64).

  * residual and J.v of TwoPhaseCCFV (Dirichlet and Neumann faces,
    gravity, wells, a per-cell K field) and TwoPhaseStorage for
    TwoPhaseParameters, BrooksCoreyParameters and VanGenuchtenParameters
    (1e-12 relative);
  * the config11 golden (models/configs.py:440-487): 34 Newton
    iterations, 2 failed steps, 96 DOFs, t_final 0.008 held exactly, and
    s_inlet / s_outlet within 1e-8 of tests/golden_parity.json and of the
    JAX package's live run;
  * the short tests of tests/test_twophase.py on the port at their sizes:
    storage mass, gravity equilibrium, harmonic interface permeability,
    compressible steady mass flux (TwoPhaseVelocity) and the scale
    factors. The time-stepped ones (displacement, wells, Neumann fluxes,
    Brooks-Corey displacement) are in test_torch_twophase_runs.py.

Every solve takes the general-jvp tier (a nonlinear operator on a
composite space); one J.v of these kernels costs ~40 ms here, most of it
torch's forward-mode overhead for operations that mix tangent and
constant operands, so the config11 run takes ~150 s.
"""
import json
from pathlib import Path

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import dune_pdelab_tpu as jpt
import dune_pdelab_tpu_torch as tpt
from dune_pdelab_tpu.fe import P0FEM as JP0
from dune_pdelab_tpu.models.configs import config11_twophase_displacement as j_config11
from dune_pdelab_tpu.ops import twophase as jtp
from dune_pdelab_tpu_torch.fe import P0FEM
from dune_pdelab_tpu_torch.instationary import OneStepMethod, implicit_euler
from dune_pdelab_tpu_torch.ops import twophase as ttp
from dune_pdelab_tpu_torch.ops.twophase import (
    TwoPhaseCCFV, TwoPhaseParameters, TwoPhaseStorage, TwoPhaseVelocity,
)
from dune_pdelab_tpu_torch.solvers import SEQ_BCGS_Jacobi, NewtonMethod
from dune_pdelab_tpu_torch.utils.common import set_default_device

pytestmark = pytest.mark.fast
torch.set_num_threads(1)
set_default_device("cpu")
F64 = torch.float64
REL = 1e-12
GOLDEN = json.loads((Path(__file__).parent / "golden_parity.json").read_text())


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _xp(x):
    return torch if isinstance(x, torch.Tensor) else jnp


def _where(cond, a, b, x):
    """where(cond, a, b) in x's dtype (torch.where of two Python floats
    would give torch's default dtype, float32)."""
    zero = 0.0 * x[..., 0]
    return _xp(x).where(cond, a + zero, b + zero)


class _Rich:
    """Dirichlet on x = 0 and x = 1, Neumann fluxes on y = 0 and y = 1,
    wells, a per-cell K field and gravity (numpy, jax and torch alike)."""

    def is_dirichlet(self, x):
        return (x[..., 0] < 1e-9) | (x[..., 0] > 1 - 1e-9)

    def g_l(self, x):
        return 2.0 - 1.5 * x[..., 0] + 0.1 * x[..., 1]

    def g_g(self, x):
        return 2.4 - 0.5 * x[..., 0]

    def j_l(self, x):
        return 0.05 * x[..., 0]

    def j_g(self, x):
        return _where(x[..., 1] > 0.5, -0.02, 0.01, x)

    def q_l(self, x):
        return _where((x[..., 0] < 0.4) & (x[..., 1] < 0.4), 0.3, 0.0, x)

    def q_g(self, x):
        return -0.2 * x[..., 1]


def _kfield(x):
    return 1.0 + 0.5 * x[..., 0] * x[..., 1]


CLASSES = {
    "sigmoid": (dict(phi=0.25, K=_kfield, mu_l=1.0, mu_g=0.4, rho_l=1.2, rho_g=0.7,
                     pc_scale=1.5, gravity=(0.0, -1.0)), "TwoPhaseParameters"),
    "brooks_corey": (dict(pe=0.4, lam=2.0, s_lr=0.05, s_gr=0.05, phi=0.2, K=_kfield,
                          mu_l=1.0, mu_g=0.3, gravity=(0.0, -0.5)), "BrooksCoreyParameters"),
    "van_genuchten": (dict(a=1.3, n=2.5, s_lr=0.02, s_gr=0.03, phi=0.2, K=1.5,
                           mu_l=1.0, mu_g=0.5), "VanGenuchtenParameters"),
}


def _make(mod, cls_name, pkg, cells):
    cls = type("Rich", (_Rich, getattr(mod, cls_name)), {})
    mesh = pkg.StructuredMesh([0, 0], [1, 1], cells)
    fem = JP0(2) if pkg is jpt else P0FEM(2)
    return mesh, pkg.PowerSpace(pkg.FunctionSpace(mesh, fem), 2), cls


@pytest.mark.parametrize("name", list(CLASSES))
def test_flux_and_storage_match_jax(name):
    kw, cls_name = CLASSES[name]
    _, jW, jcls = _make(jtp, cls_name, jpt, (6, 5))
    _, tW, tcls = _make(ttp, cls_name, tpt, (6, 5))
    rng = np.random.default_rng(21)
    E = 30
    x = np.concatenate([rng.normal(1.0, 0.3, E), rng.normal(1.6, 0.3, E)])
    z = rng.standard_normal(2 * E)
    for jlop, tlop in ((jtp.TwoPhaseCCFV(jcls(**kw), scale_g=1.5),
                        TwoPhaseCCFV(tcls(**kw), scale_g=1.5)),
                       (jtp.TwoPhaseStorage(jcls(**kw), scale_l=0.5),
                        TwoPhaseStorage(tcls(**kw), scale_l=0.5))):
        jgo, tgo = jpt.GridOperator(jW, jlop), tpt.GridOperator(tW, tlop)
        xt, zt = torch.as_tensor(x), torch.as_tensor(z)
        assert _rel(tgo.residual(xt), jgo.residual(jnp.asarray(x))) <= REL
        assert _rel(tgo.jacobian_apply(xt, zt),
                    jgo.jacobian_apply(jnp.asarray(x), jnp.asarray(z))) <= REL


class Displacement(TwoPhaseParameters):
    """models/configs.py config11: the wetting phase floods in from x = 0."""

    def is_dirichlet(self, x):
        return (x[..., 0] < 1e-9) | (x[..., 0] > 1 - 1e-9)

    def g_l(self, x):
        return torch.where(x[..., 0] < 0.5, 2.0, 0.0)

    def g_g(self, x):
        return torch.where(x[..., 0] < 0.5, 1.5, 1.5)


def config11(cells=24, tend=0.008):
    """The port's run of models/configs.py config11_twophase_displacement."""
    prm = Displacement(phi=0.2, K=1.0, mu_l=1.0, mu_g=0.2, pc_scale=1.0)
    mesh = tpt.StructuredMesh([0, 0], [1, 0.25], (cells, 2))
    W = tpt.PowerSpace(tpt.FunctionSpace(mesh, P0FEM(2)), 2)
    osm = OneStepMethod(implicit_euler(), tpt.GridOperator(W, TwoPhaseCCFV(prm)),
                        tpt.GridOperator(W, TwoPhaseStorage(prm)), SEQ_BCGS_Jacobi(),
                        pdesolver="newton", reduction=1e-7, max_iterations=40,
                        min_linear_reduction=1e-4)
    E = mesh.nelements
    x = torch.cat([torch.zeros(E, dtype=F64), torch.full((E,), 0.5, dtype=F64)])
    t, x = osm.solve(0.0, 1e-3, tend, x, max_step_retries=4)
    pl, pg = W.restrict(x, 0).numpy(), W.restrict(x, 1).numpy()
    s_l = 1.0 / (1.0 + np.exp(-4.0 * (0.5 - (pg - pl))))
    centers = mesh.element_centers()
    row = np.isclose(centers[:, 1], centers[0, 1])
    s_row = s_l[row][np.argsort(centers[row][:, 0])]
    return {"s_inlet": float(s_row[0]), "s_outlet": float(s_row[-1]),
            "newton_iterations": osm.result.total_newton_iterations,
            "failed_steps": osm.result.failed_steps, "ndofs": W.ndofs,
            "t_final": float(t)}


def test_config11_golden():
    got = config11()
    gold = GOLDEN["config11_twophase_displacement"]
    live = j_config11()
    for key in ("newton_iterations", "failed_steps", "ndofs", "t_final"):
        assert got[key] == gold[key] == live[key], (key, got[key], gold[key], live[key])
    for key in ("s_inlet", "s_outlet"):
        assert abs(got[key] - gold[key]) <= 1e-8, (key, got[key], gold[key])
        assert abs(got[key] - live[key]) <= 1e-8, (key, got[key], live[key])


# -- tests/test_twophase.py on the port (short ones) ------------------------
def _p0_power(cells, upper=(1.0, 1.0)):
    mesh = tpt.StructuredMesh([0, 0], list(upper), cells)
    return mesh, tpt.PowerSpace(tpt.FunctionSpace(mesh, P0FEM(2)), 2)


def test_twophase_storage_mass():
    """Storage term equals phi*rho*S*V per cell (nu = rho default)."""
    prm = TwoPhaseParameters(phi=0.25, pc_scale=2.0)
    mesh, W = _p0_power((4, 4))
    go1 = tpt.GridOperator(W, TwoPhaseStorage(prm))
    E = mesh.nelements
    x = torch.cat([torch.zeros(E, dtype=F64), torch.ones(E, dtype=F64)])
    m = go1.residual_unconstrained(x).numpy()
    vol = 1.0 / 16
    assert np.allclose(m[:E], 0.25 * 1.0 * 0.5 * vol, atol=1e-12)
    assert np.allclose(m[E:], 0.25 * 1.0 * 0.5 * vol, atol=1e-12)


def test_twophase_gravity_hydrostatic():
    """Hydrostatic phase pressures: every potential drop vanishes, so the
    spatial residual is zero; breaking the balance gives a nonzero one."""
    g = 9.81
    prm = TwoPhaseParameters(phi=0.2, K=1.0, mu_l=1.0, mu_g=0.5, rho_l=2.0, rho_g=1.0,
                             pc_scale=1.0, gravity=(0.0, -g))
    mesh, W = _p0_power((6, 6))
    go0 = tpt.GridOperator(W, TwoPhaseCCFV(prm))
    c = mesh.element_centers()
    pl = 3.0 + prm.rho_l * g * (1.0 - c[:, 1])
    pg = 3.5 + prm.rho_g * g * (1.0 - c[:, 1])
    x = torch.as_tensor(np.concatenate([pl, pg]))
    assert float(go0.residual_unconstrained(x).abs().max()) < 1e-10
    x2 = torch.as_tensor(np.concatenate([pl * 0 + 3.0, pg]))
    assert float(go0.residual_unconstrained(x2).abs().max()) > 1e-3


def test_twophase_heterogeneous_k_harmonic():
    """Two-layer medium: the TPFA transmissibility uses the harmonic
    interface average of lambda*K, so the layer slopes satisfy
    K1 dp1 = K2 dp2."""
    K1, K2 = 1.0, 0.2

    class Layered(TwoPhaseParameters):
        def is_dirichlet(self, x):
            return (x[..., 0] < 1e-9) | (x[..., 0] > 1 - 1e-9)

        def g_l(self, x):
            return torch.where(x[..., 0] < 0.5, 1.0, 0.0)

        def g_g(self, x):
            return self.g_l(x) + 0.5

    prm = Layered(phi=0.2, mu_l=1.0, mu_g=1.0, pc_scale=1.0,
                  K=lambda x: _where(x[..., 0] < 0.5, K1, K2, x))
    n = 8
    mesh, W = _p0_power((n, 1), (1.0, 1.0 / n))
    go0 = tpt.GridOperator(W, TwoPhaseCCFV(prm))
    E = mesh.nelements
    x0 = torch.cat([torch.full((E,), 0.5, dtype=F64), torch.full((E,), 1.0, dtype=F64)])
    x = NewtonMethod(go0, SEQ_BCGS_Jacobi(), reduction=1e-12).apply(x0)
    p_sorted = W.restrict(x, 0).numpy()[np.argsort(mesh.element_centers()[:, 0])]
    dp1 = p_sorted[1] - p_sorted[0]
    dp2 = p_sorted[-1] - p_sorted[-2]
    assert abs(K1 * dp1 - K2 * dp2) < 1e-8 * abs(K1 * dp1), (dp1, dp2)


def test_twophase_compressible_steady_mass_flux():
    """rho_l(p) = 1 + c p: the steady column has a constant phase mass
    flux across every face (TwoPhaseVelocity reproduces the solver's TPFA
    fluxes) and a vanishing discrete divergence."""
    c = 0.3

    class Comp(TwoPhaseParameters):
        def is_dirichlet(self, x):
            return (x[..., 0] < 1e-9) | (x[..., 0] > 1 - 1e-9)

        def density_l(self, x, p_l):
            return 1.0 + c * p_l

        def g_l(self, x):
            return torch.where(x[..., 0] < 0.5, 1.0, 0.0)

        def g_g(self, x):
            return self.g_l(x) + 0.5

    prm = Comp(phi=0.2, mu_l=1.0, mu_g=1.0, pc_scale=1.0)
    n = 8
    mesh, W = _p0_power((n, 1), (1.0, 1.0 / n))
    go = tpt.GridOperator(W, TwoPhaseCCFV(prm))
    cx = torch.as_tensor(mesh.element_centers()[:, 0])
    pl0 = 1.0 - cx
    x = NewtonMethod(go, SEQ_BCGS_Jacobi(), reduction=1e-10,
                     line_search_accept_best=True).apply(torch.cat([pl0, pl0 + 0.5]))
    for phase in ("liquid", "gas"):
        v = TwoPhaseVelocity(mesh, prm, W, x, phase=phase)
        Vx = v.face_normal_velocities()[0].reshape(-1)
        assert Vx.std() < 1e-6 * abs(Vx.mean()), (phase, Vx)
        assert np.abs(v.cell_divergence()).max() < 1e-6, phase
    vl = TwoPhaseVelocity(mesh, prm, W, x, phase="liquid")
    assert vl.face_normal_velocities()[0].reshape(-1).mean() > 0


def test_twophase_scale_factors():
    """scale_l/scale_g multiply the residual rows of their phase, in the
    flux and in the storage operator."""
    prm = TwoPhaseParameters(phi=0.2, pc_scale=1.0)
    mesh, W = _p0_power((4, 4))
    E = mesh.nelements
    x = torch.as_tensor(np.random.default_rng(3).normal(0.5, 0.2, 2 * E))
    for op in (TwoPhaseCCFV, TwoPhaseStorage):
        r1 = tpt.GridOperator(W, op(prm)).residual_unconstrained(x).numpy()
        rs = tpt.GridOperator(W, op(prm, scale_l=2.0, scale_g=3.0)).residual_unconstrained(
            x).numpy()
        assert np.allclose(rs[:E], 2.0 * r1[:E], rtol=1e-12)
        assert np.allclose(rs[E:], 3.0 * r1[E:], rtol=1e-12)
