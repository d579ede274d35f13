"""Two-phase flow of the port (ops/twophase.py) against the JAX package
(fp64).

  * residual and J.v of TwoPhaseCCFV (Dirichlet and Neumann faces,
    gravity, wells, a per-cell K field) and TwoPhaseStorage for
    TwoPhaseParameters, BrooksCoreyParameters and VanGenuchtenParameters
    (1e-12 relative);
  * the config11 golden through the port's models/configs.py: 34 Newton
    iterations, 2 failed steps, 96 DOFs, t_final 0.008 held exactly, and
    s_inlet / s_outlet within 1e-8 of tests/golden_parity.json (the JAX
    package's recorded run of the same configuration);
  * the short tests of tests/test_twophase.py on the port at their sizes:
    storage mass, gravity equilibrium, harmonic interface permeability,
    compressible steady mass flux (TwoPhaseVelocity) and the scale
    factors. The time-stepped ones (displacement, wells, Neumann fluxes,
    Brooks-Corey displacement) are in test_torch_twophase_runs.py.

Every solve takes the general-jvp tier (a nonlinear operator on a
composite space). One jvp of these kernels costs ~50 ms here, most of it
torch's forward-mode overhead for operations that mix tangent and
constant operands; the Krylov solves transpose the apply twice on the
CPU (solvers/linear.py transposed_twice, ~4 ms an apply), so the config11
run takes ~35 s.
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
from dune_pdelab_tpu.ops import twophase as jtp
from dune_pdelab_tpu_torch.fe import P0FEM
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


def test_config11_golden():
    """The port's ALL_CONFIGS["config11"] (matrix-free SEQ_BCGS_Jacobi
    Newton steps, as the configuration defines them) against
    tests/golden_parity.json, the JAX package's own recorded run of the
    same configuration (its live run is not repeated here)."""
    from dune_pdelab_tpu_torch.models import ALL_CONFIGS

    info = {}
    got = ALL_CONFIGS["config11"](info=info)
    assert "general-jvp" in info["ls"].report()
    gold = GOLDEN["config11_twophase_displacement"]
    for key in ("newton_iterations", "failed_steps", "ndofs", "t_final"):
        assert got[key] == gold[key], (key, got[key], gold[key])
    for key in ("s_inlet", "s_outlet"):
        assert abs(got[key] - gold[key]) <= 1e-8, (key, got[key], gold[key])


# -- tests/test_twophase.py on the port (short ones) ------------------------
def test_transposed_twice_apply_equals_jvp():
    """The CPU Krylov apply of the general-jvp tier (solvers/linear.py
    transposed_twice: reverse mode applied twice to the jvp apply, built
    once per solve) equals go.jacobian_apply to 1e-13 relative on random
    vectors: on the sigmoid operator, on its implicit-Euler stage operator
    and on a constrained Q1 operator (identity rows); an operator without
    `reverse_mode_apply` keeps one jvp per apply."""
    import types

    from dune_pdelab_tpu_torch.instationary.onestep import OneStepGridOperator, StageContext
    from dune_pdelab_tpu_torch.ops import ConvectionDiffusionFEM, ConvectionDiffusionProblem
    from dune_pdelab_tpu_torch.solvers.linear import _general_apply

    kw, cls_name = CLASSES["sigmoid"]
    _, W, cls = _make(ttp, cls_name, tpt, (6, 5))
    go0 = tpt.GridOperator(W, TwoPhaseCCFV(cls(**kw)))
    stage = OneStepGridOperator(go0, tpt.GridOperator(W, TwoPhaseStorage(cls(**kw))))
    V = tpt.FunctionSpace(tpt.StructuredMesh([0, 0], [1, 1], (5, 4)), tpt.QkFEM(1, 2))
    q1 = tpt.GridOperator(V, ConvectionDiffusionFEM(ConvectionDiffusionProblem()),
                          constraints=tpt.constraints(True, V))
    rng = np.random.default_rng(5)
    x2 = torch.as_tensor(np.concatenate([rng.normal(1.0, 0.3, 30), rng.normal(1.6, 0.3, 30)]))
    xq = torch.as_tensor(rng.standard_normal(V.ndofs))
    for go, x, time in ((go0, x2, 0.0), (stage, x2, StageContext(0.0, 1.0, 1e-3, 0.0)),
                        (q1, xq, 0.0)):
        apply, how = _general_apply(go, x, x, time)
        assert how == "; transposed twice"
        for seed in range(3):
            z = torch.as_tensor(np.random.default_rng(seed).standard_normal(len(x)))
            assert _rel(apply(z), go.jacobian_apply(x, z, time)) <= 1e-13
    assert _general_apply(types.SimpleNamespace(jacobian_apply=go0.jacobian_apply),
                          x2, x2, 0.0)[1] == ""


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
