"""The time-stepped tests of tests/test_twophase.py on the port at their
sizes (fp64): implicit Euler + Newton with failed-step dt halving on
PowerSpace(P0FEM(2), 2).

  * the displacement front (24 x 2 cells to t = 0.012): saturations in
    [0, 1] within 1e-8, wet inlet, drained outlet, monotone row;
  * wells on a closed domain: the summed storage changes by dt * Q * |cell|
    per step (rel 1e-6);
  * Neumann boundary fluxes: the summed storage changes by -t * j * |face|
    (rel 1e-6);
  * the Brooks-Corey closure driving the same displacement.

The bounds are the reference test's. The two displacement runs solve their
linear systems on the assembled tier (SEQ_BCGS_Jacobi(matrix_free=False):
the sparse Jacobian probed once per Newton step) rather than the
reference's matrix-free one: matrix-free they take ~200 s and ~650 s here,
nearly all of it torch's forward-mode overhead per operation of a J.v (see
test_torch_twophase.py), against ~10 s and ~22 s assembled. The wells and
Neumann runs and the config11 golden (test_torch_twophase.py) stay
matrix-free, as in the reference.
"""
import numpy as np
import pytest
import torch

import dune_pdelab_tpu_torch as tpt
from dune_pdelab_tpu_torch.fe import P0FEM
from dune_pdelab_tpu_torch.instationary import OneStepMethod, implicit_euler
from dune_pdelab_tpu_torch.ops.twophase import (
    BrooksCoreyParameters, TwoPhaseCCFV, TwoPhaseParameters, TwoPhaseStorage,
)
from dune_pdelab_tpu_torch.solvers import SEQ_BCGS_Jacobi
from dune_pdelab_tpu_torch.utils.common import set_default_device

pytestmark = pytest.mark.fast
torch.set_num_threads(1)
set_default_device("cpu")
F64 = torch.float64


def _setup(prm, cells, upper=(1.0, 1.0), reduction=1e-7, min_lin=1e-4, matrix_free=True):
    mesh = tpt.StructuredMesh([0, 0], list(upper), cells)
    W = tpt.PowerSpace(tpt.FunctionSpace(mesh, P0FEM(2)), 2)
    go1 = tpt.GridOperator(W, TwoPhaseStorage(prm))
    osm = OneStepMethod(implicit_euler(), tpt.GridOperator(W, TwoPhaseCCFV(prm)), go1,
                        SEQ_BCGS_Jacobi(matrix_free=matrix_free), pdesolver="newton",
                        reduction=reduction, max_iterations=40, min_linear_reduction=min_lin)
    return mesh, W, go1, osm


def _start(E, pl, pg):
    return torch.cat([torch.full((E,), pl, dtype=F64), torch.full((E,), pg, dtype=F64)])


def _row(mesh, s):
    centers = mesh.element_centers()
    row = np.isclose(centers[:, 1], centers[0, 1])
    return s[row][np.argsort(centers[row][:, 0])]


class Displacement(TwoPhaseParameters):
    """Wetting phase floods in from x = 0; outflow at x = 1."""

    def is_dirichlet(self, x):
        return (x[..., 0] < 1e-9) | (x[..., 0] > 1 - 1e-9)

    def g_l(self, x):
        return torch.where(x[..., 0] < 0.5, 2.0, 0.0)

    def g_g(self, x):
        return torch.where(x[..., 0] < 0.5, 2.0 - 0.5, 0.0 + 1.5)


def test_twophase_displacement():
    prm = Displacement(phi=0.2, K=1.0, mu_l=1.0, mu_g=0.2, pc_scale=1.0)
    mesh, W, _, osm = _setup(prm, (24, 2), (1.0, 0.25), matrix_free=False)
    t, x = osm.solve(0.0, 1e-3, 0.012, _start(mesh.nelements, 0.0, 0.5), max_step_retries=4)
    assert t == pytest.approx(0.012)
    pl, pg = W.restrict(x, 0).numpy(), W.restrict(x, 1).numpy()
    s_l = 1.0 / (1.0 + np.exp(-4.0 * (0.5 - (pg - pl))))
    assert np.all(s_l >= -1e-8) and np.all(s_l <= 1 + 1e-8)
    s_row = _row(mesh, s_l)
    assert s_row[0] > 0.9, s_row
    assert s_row[-1] < 0.2, s_row
    assert np.all(np.diff(s_row) < 1e-6), s_row


def _masses(go1, x, E):
    m = go1.residual_unconstrained(x).numpy()
    return float(m[:E].sum()), float(m[E:].sum())


def test_twophase_wells_discrete_mass_balance():
    """A liquid injector and a gas producer on a closed domain: the summed
    storage changes by dt * integral(q) per step, exactly up to the
    Newton tolerance (the fluxes telescope)."""
    Q, n = 0.05, 8
    hx = 1.0 / n

    class Wells(TwoPhaseParameters):
        def q_l(self, x):                            # injector at (0, 0)
            return torch.where((x[..., 0] < hx) & (x[..., 1] < hx), Q, 0.0).to(x.dtype)

        def q_g(self, x):                            # producer at (1, 1)
            return torch.where((x[..., 0] > 1 - hx) & (x[..., 1] > 1 - hx), -Q,
                               0.0).to(x.dtype)

    mesh, W, go1, osm = _setup(Wells(phi=0.2, pc_scale=2.0), (n, n), reduction=1e-10,
                               min_lin=1e-5)
    E = mesh.nelements
    x = _start(E, 0.0, 1.0)
    ml0, mg0 = _masses(go1, x, E)
    t, dt = 0.0, 0.01
    for step in range(3):
        x = osm.apply(t, dt, x)
        t += dt
        ml, mg = _masses(go1, x, E)
        assert ml - ml0 == pytest.approx((step + 1) * dt * Q * hx * hx, rel=1e-6)
        assert mg - mg0 == pytest.approx(-(step + 1) * dt * Q * hx * hx, rel=1e-6)


def test_twophase_neumann_flux_mass_balance():
    """Liquid pumped in on the left face, gas extracted on the right: the
    summed storage changes by -t * sum(j * |face|)."""
    J, n = 0.03, 8

    class Neu(TwoPhaseParameters):
        def j_l(self, x):
            return torch.where(x[..., 0] < 1e-9, -J, 0.0).to(x.dtype)

        def j_g(self, x):
            return torch.where(x[..., 0] > 1 - 1e-9, J, 0.0).to(x.dtype)

    mesh, W, go1, osm = _setup(Neu(phi=0.2, pc_scale=2.0), (n, n), reduction=1e-10,
                               min_lin=1e-5)
    E = mesh.nelements
    x = _start(E, 0.0, 1.0)
    ml0, mg0 = _masses(go1, x, E)
    tend = 0.03
    t, x = osm.solve(0.0, 0.01, tend, x, max_step_retries=6)
    assert t == pytest.approx(tend)
    ml, mg = _masses(go1, x, E)
    assert ml - ml0 == pytest.approx(tend * J, rel=1e-6)
    assert mg - mg0 == pytest.approx(-tend * J, rel=1e-6)


def test_twophase_brooks_corey_displacement():
    class BCDisp(BrooksCoreyParameters):
        def is_dirichlet(self, x):
            return (x[..., 0] < 1e-9) | (x[..., 0] > 1 - 1e-9)

        def g_l(self, x):
            return torch.where(x[..., 0] < 0.5, 2.0, 0.0)

        def g_g(self, x):
            return self.g_l(x) + torch.where(x[..., 0] < 0.5, 1.05, 3.0).to(x.dtype)

    prm = BCDisp(pe=1.0, lam=2.0, s_lr=0.05, s_gr=0.05, phi=0.2, K=1.0, mu_l=1.0, mu_g=0.2)
    mesh, W, _, osm = _setup(prm, (24, 2), (1.0, 0.25), matrix_free=False)
    t, x = osm.solve(0.0, 1e-3, 0.008, _start(mesh.nelements, 0.0, 1.2), max_step_retries=6)
    assert t == pytest.approx(0.008)
    pl, pg = W.restrict(x, 0), W.restrict(x, 1)
    s_l = prm.s_l(pg - pl).numpy()
    assert np.all(s_l >= prm.s_lr - 1e-8)
    assert np.all(s_l <= 1 - prm.s_gr + 1e-8)
    s_row = _row(mesh, s_l)
    assert s_row[0] > 0.75, s_row
    assert s_row[-1] < 0.5, s_row
