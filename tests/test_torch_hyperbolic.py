"""Explicit DG waves of the port against the JAX package (fp64).

  * LinearAcousticsDG (reflect and absorb faces, constant and per-cell
    sound speed) and MaxwellDG (pec and absorb faces, homogeneous and
    heterogeneous eps/mu): residuals at a random state against the JAX
    package's, 2D and 3D (1e-12 relative);
  * three shu3 steps of ExplicitOneStepMethod at 4^2 (acoustics) and
    4x4x2 (Maxwell) against the JAX package's (1e-12 relative);
  * the six tests of tests/test_hyperbolic.py on the port at their sizes.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

import dune_pdelab_tpu as jpt
import dune_pdelab_tpu_torch as tpt
from dune_pdelab_tpu import instationary as jinst
from dune_pdelab_tpu.fe import QkDGFEM as JQkDG
from dune_pdelab_tpu.ops import L2 as JL2
from dune_pdelab_tpu.ops.acoustics import LinearAcousticsDG as JAcoustics
from dune_pdelab_tpu.ops.maxwell import MaxwellDG as JMaxwell
from dune_pdelab_tpu_torch.fe import QkDGFEM
from dune_pdelab_tpu_torch.instationary import ExplicitOneStepMethod, heun, shu3
from dune_pdelab_tpu_torch.ops import L2, LinearAcousticsDG, MaxwellDG
from dune_pdelab_tpu_torch.space.functions import l2_difference
from dune_pdelab_tpu_torch.utils.common import set_default_device

pytestmark = pytest.mark.fast
torch.set_num_threads(1)
set_default_device("cpu")
F64 = torch.float64
REL = 1e-12


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _xp(x):
    return torch if isinstance(x, torch.Tensor) else jnp


def _speed(x):
    return 1.0 + 0.5 * (x[..., 0] > 0.5) + 0.25 * x[..., 1]


def _eps(x):
    return _xp(x).where(x[..., 0] < 0.5, 1.0, 4.0)


def _mu(x):
    return 1.0 + 0.5 * x[..., 1]


def _spaces(cells, k, ncomp):
    dim = len(cells)
    lo, hi = [0.0] * dim, [1.0] * dim
    jQ = jpt.PowerSpace(jpt.FunctionSpace(jpt.StructuredMesh(lo, hi, cells),
                                          JQkDG(k, dim)), ncomp)
    tQ = tpt.PowerSpace(tpt.FunctionSpace(tpt.StructuredMesh(lo, hi, cells),
                                          QkDGFEM(k, dim)), ncomp)
    return jQ, tQ


CASES = [
    ("acoustics", (4, 3), 2, dict(bc="reflect")),
    ("acoustics", (4, 3), 1, dict(bc="absorb", c=_speed, cmax=2.0)),
    ("acoustics", (3, 2, 2), 1, dict(bc="reflect", c=_speed, cmax=2.0)),
    ("maxwell", (3, 2, 2), 1, dict(bc="pec")),
    ("maxwell", (3, 2, 2), 1, dict(bc="absorb", eps=_eps, mu=_mu, cmax=1.0)),
]


def _ops(kind, kw):
    if kind == "acoustics":
        return JAcoustics(**kw), LinearAcousticsDG(**kw)
    return JMaxwell(**kw), MaxwellDG(**kw)


@pytest.mark.parametrize("kind,cells,k,kw", CASES,
                         ids=[f"{c[0]}-{len(c[1])}d-{c[3]['bc']}-{i}"
                              for i, c in enumerate(CASES)])
def test_residual_matches_jax(kind, cells, k, kw):
    ncomp = 1 + len(cells) if kind == "acoustics" else 6
    jQ, tQ = _spaces(cells, k, ncomp)
    jlop, tlop = _ops(kind, kw)
    jgo, tgo = jpt.GridOperator(jQ, jlop), tpt.GridOperator(tQ, tlop)
    x = np.random.default_rng(4).standard_normal(tQ.ndofs)
    assert _rel(tgo.residual(torch.as_tensor(x)), jgo.residual(jnp.asarray(x))) <= REL
    assert tlop.max_speed() == jlop.max_speed()


@pytest.mark.parametrize("kind", ["acoustics", "maxwell"])
def test_shu3_steps_match_jax(kind):
    cells = (4, 4) if kind == "acoustics" else (4, 4, 2)
    ncomp = 3 if kind == "acoustics" else 6
    jQ, tQ = _spaces(cells, 1, ncomp)
    jlop, tlop = _ops(kind, dict(bc="reflect") if kind == "acoustics" else dict(bc="pec"))
    josm = jinst.ExplicitOneStepMethod(jinst.shu3(), jpt.GridOperator(jQ, jlop),
                                       jpt.GridOperator(jQ, JL2()))
    tosm = ExplicitOneStepMethod(shu3(), tpt.GridOperator(tQ, tlop),
                                 tpt.GridOperator(tQ, L2()))
    x = np.random.default_rng(6).standard_normal(tQ.ndofs)
    jx, tx, t = jnp.asarray(x), torch.as_tensor(x), 0.0
    for _ in range(3):
        jx, tx = josm.apply(t, 0.01, jx)[0], tosm.apply(t, 0.01, tx)[0]
        t += 0.01
    assert _rel(tx, jx) <= REL


# -- tests/test_hyperbolic.py on the port -----------------------------------
def _zero(p):
    return np.zeros(len(p))


def _exact(f):
    return lambda p: torch.as_tensor(f(p.numpy()))


def test_acoustics_standing_wave():
    """p = cos(pi x) cos(pi c t), u1 = sin(pi x) sin(pi c t), u2 = 0."""
    c = 1.0
    n, k = 16, 1
    mesh = tpt.StructuredMesh([0, 0], [1, 1], (n, n))
    leaf = tpt.FunctionSpace(mesh, QkDGFEM(k, 2))
    Q = tpt.PowerSpace(leaf, 3)   # (p, u1, u2)
    osm = ExplicitOneStepMethod(shu3(), tpt.GridOperator(Q, LinearAcousticsDG(c=c, bc="reflect")),
                                tpt.GridOperator(Q, L2()))
    x = Q.interpolate((lambda p: np.cos(np.pi * p[:, 0].numpy()), _zero, _zero), dtype=F64)
    dt = 0.4 / (c * n * (2 * k + 1))
    t, x = osm.solve(0.0, dt, 0.25, x)
    perr = float(l2_difference(leaf, Q.restrict(x, 0), _exact(
        lambda p: np.cos(np.pi * p[:, 0]) * np.cos(np.pi * c * t))))
    uerr = float(l2_difference(leaf, Q.restrict(x, 1), _exact(
        lambda p: np.sin(np.pi * p[:, 0]) * np.sin(np.pi * c * t))))
    assert perr < 0.02, perr
    assert uerr < 0.02, uerr


def test_acoustics_energy_decay_absorbing():
    mesh = tpt.StructuredMesh([0, 0], [1, 1], (8, 8))
    leaf = tpt.FunctionSpace(mesh, QkDGFEM(1, 2))
    Q = tpt.PowerSpace(leaf, 3)
    go1 = tpt.GridOperator(Q, L2())
    osm = ExplicitOneStepMethod(heun(), tpt.GridOperator(Q, LinearAcousticsDG(bc="absorb")), go1)
    x = Q.interpolate((
        lambda p: np.exp(-50 * ((p[:, 0].numpy() - .5)**2 + (p[:, 1].numpy() - .5)**2)),
        _zero, _zero), dtype=F64)
    energies = [float(torch.dot(x, go1.jacobian_apply(x, x)))]
    t, dt = 0.0, 5e-3
    for _ in range(3):
        t, x = osm.solve(t, dt, t + 0.2, x)
        energies.append(float(torch.dot(x, go1.jacobian_apply(x, x))))
    assert all(b < a * 1.0001 for a, b in zip(energies, energies[1:])), energies
    assert energies[-1] < 0.5 * energies[0], energies


def test_maxwell_cavity_mode():
    """TM_110 mode in a PEC unit box: E_z = sin(pi x) sin(pi y) cos(w t)."""
    w = np.sqrt(2.0) * np.pi
    a = -1.0 / np.sqrt(2.0)
    n, k = 8, 1
    mesh = tpt.StructuredMesh([0, 0, 0], [1, 1, 1], (n, n, 2))
    leaf = tpt.FunctionSpace(mesh, QkDGFEM(k, 3))
    Q = tpt.PowerSpace(leaf, 6)
    osm = ExplicitOneStepMethod(shu3(), tpt.GridOperator(Q, MaxwellDG(bc="pec")),
                                tpt.GridOperator(Q, L2()))
    x = Q.interpolate((_zero, _zero, lambda p: np.sin(np.pi * p[:, 0].numpy())
                       * np.sin(np.pi * p[:, 1].numpy()), _zero, _zero, _zero), dtype=F64)
    dt = 0.3 / (n * (2 * k + 1))
    t, x = osm.solve(0.0, dt, 0.2, x)
    ez = float(l2_difference(leaf, Q.restrict(x, 2), _exact(
        lambda p: np.sin(np.pi * p[:, 0]) * np.sin(np.pi * p[:, 1]) * np.cos(w * t))))
    hx = float(l2_difference(leaf, Q.restrict(x, 3), _exact(
        lambda p: a * np.sin(np.pi * p[:, 0]) * np.cos(np.pi * p[:, 1]) * np.sin(w * t))))
    assert ez < 0.05, ez
    assert hx < 0.05, hx


def test_maxwell_heterogeneous_transmission():
    """A plane pulse on an eps jump: reflected / transmitted E amplitudes
    match the Fresnel coefficients R = (Z2 - Z1)/(Z2 + Z1),
    T = 2 Z2/(Z1 + Z2)."""
    eps2 = 4.0
    Z1, Z2 = 1.0, 1.0 / np.sqrt(eps2)
    R = (Z2 - Z1) / (Z2 + Z1)
    T = 2 * Z2 / (Z1 + Z2)
    nx, k = 96, 1
    mesh = tpt.StructuredMesh([0, 0, 0], [2, 1, 1], (nx, 2, 2), periodic=(False, True, True))
    leaf = tpt.FunctionSpace(mesh, QkDGFEM(k, 3))
    Q = tpt.PowerSpace(leaf, 6)
    lop = MaxwellDG(bc="absorb", eps=lambda x: torch.where(x[..., 0] < 1.0, 1.0, eps2),
                    mu=1.0, cmax=1.0)
    osm = ExplicitOneStepMethod(shu3(), tpt.GridOperator(Q, lop), tpt.GridOperator(Q, L2()))

    def g(p):
        return np.exp(-((p[:, 0].numpy() - 0.45) / 0.08) ** 2)

    x = Q.interpolate((_zero, g, _zero, _zero, _zero, g), dtype=F64)
    dt = 0.25 / (nx / 2 * (2 * k + 1))
    t, x = osm.solve(0.0, dt, 1.0, x)
    coords = leaf.dof_coords()
    ey = Q.restrict(x, 1).abs().numpy()
    refl = float(ey[coords[:, 0] < 0.85].max())
    trans = float(ey[coords[:, 0] > 1.1].max())
    assert abs(refl - abs(R)) < 0.08, (refl, R)
    assert abs(trans - T) < 0.08, (trans, T)
    sel = coords[:, 0] > 1.1
    xpk = float(coords[sel][np.argmax(ey[sel]), 0])
    assert abs(xpk - (1.0 + 0.45 / 2)) < 0.12, xpk


def test_acoustics_heterogeneous_speed():
    """A pulse crossing a sound-speed jump (c: 1 -> 2) transmits without
    spurious reflection and travels at the local speed."""
    nx, k = 96, 1
    mesh = tpt.StructuredMesh([0, 0], [2, 1], (nx, 2), periodic=(False, True))
    leaf = tpt.FunctionSpace(mesh, QkDGFEM(k, 2))
    Q = tpt.PowerSpace(leaf, 3)
    lop = LinearAcousticsDG(c=lambda x: torch.where(x[..., 0] < 1.0, 1.0, 2.0),
                            bc="absorb", cmax=2.0)
    osm = ExplicitOneStepMethod(shu3(), tpt.GridOperator(Q, lop), tpt.GridOperator(Q, L2()))

    def g(p):
        return np.exp(-((p[:, 0].numpy() - 0.5) / 0.08) ** 2)

    x = Q.interpolate((g, g, _zero), dtype=F64)
    dt = 0.2 / (nx / 2 * (2 * k + 1) * 2.0)
    t, x = osm.solve(0.0, dt, 0.8, x)
    coords = leaf.dof_coords()
    pv = Q.restrict(x, 0).abs().numpy()
    refl = float(pv[coords[:, 0] < 0.85].max())
    assert refl < 0.06, refl
    sel = coords[:, 0] > 1.1
    xpk = float(coords[sel][np.argmax(pv[sel]), 0])
    assert abs(xpk - 1.6) < 0.12, xpk
    assert abs(pv[sel].max() - 0.5) < 0.05, pv[sel].max()


def test_acoustics_3d_standing_wave():
    c = 1.0
    n, k = 8, 1
    mesh = tpt.StructuredMesh([0, 0, 0], [1, 1, 1], (n, n, n))
    leaf = tpt.FunctionSpace(mesh, QkDGFEM(k, 3))
    Q = tpt.PowerSpace(leaf, 4)   # (p, u1, u2, u3)
    osm = ExplicitOneStepMethod(shu3(), tpt.GridOperator(Q, LinearAcousticsDG(c=c, bc="reflect")),
                                tpt.GridOperator(Q, L2()))
    x = Q.interpolate((lambda p: np.cos(np.pi * p[:, 2].numpy()), _zero, _zero, _zero),
                      dtype=F64)
    dt = 0.4 / (c * n * (2 * k + 1))
    t, x = osm.solve(0.0, dt, 0.25, x)
    perr = float(l2_difference(leaf, Q.restrict(x, 0), _exact(
        lambda p: np.cos(np.pi * p[:, 2]) * np.cos(np.pi * c * t))))
    uerr = float(l2_difference(leaf, Q.restrict(x, 3), _exact(
        lambda p: np.sin(np.pi * p[:, 2]) * np.sin(np.pi * c * t))))
    assert perr < 0.05, perr
    assert uerr < 0.05, uerr
    for comp in (1, 2):
        assert float(Q.restrict(x, comp).abs().max()) < 1e-10
