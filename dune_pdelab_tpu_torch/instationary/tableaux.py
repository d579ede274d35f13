"""Time-stepping scheme parameter tables (A, B, d).

PyTorch port of dune_pdelab_tpu/instationary/tableaux.py: numpy tables,
equal to the reference's bit for bit. Analog of PDELab's
TimeSteppingParameterInterface family (reference:
dune/pdelab/instationary/onestepparameter.hh:43-77 interface;
OneStepTheta :89, Heun :214, Shu3 :287, RK4 :364, Alexander2 :445,
FractionalStep :522, Alexander3 :605). The scheme encodes stage equations

    sum_{i=0..r} [ a[r,i] * m(u_i)  +  dt * b[r,i] * alpha(u_i) ]  =  0

for stages r = 1..s at stage times t + d[i] * dt, where m is the temporal
(mass) residual and alpha the spatial residual, both in residual form
(du/dt = -alpha). Coefficients are the standard Runge-Kutta values in
solution-stage (not slope) form; stiffly-accurate schemes end with u_s as
the step solution.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class TimeSteppingScheme:
    name: str
    implicit: bool
    order: int
    a: np.ndarray  # (s, s+1) mass weights
    b: np.ndarray  # (s, s+1) spatial weights (multiplied by dt)
    d: np.ndarray  # (s+1,) stage time fractions

    @property
    def stages(self) -> int:
        return self.a.shape[0]


def one_step_theta(theta: float) -> TimeSteppingScheme:
    """Theta scheme: explicit Euler (0), implicit Euler (1), CN (1/2)."""
    return TimeSteppingScheme(
        name=f"one-step theta={theta}",
        implicit=theta > 0.0,
        order=2 if theta == 0.5 else 1,
        a=np.array([[-1.0, 1.0]]),
        b=np.array([[1.0 - theta, theta]]),
        d=np.array([0.0, 1.0]),
    )


def implicit_euler() -> TimeSteppingScheme:
    return one_step_theta(1.0)


def explicit_euler() -> TimeSteppingScheme:
    return one_step_theta(0.0)


def crank_nicolson() -> TimeSteppingScheme:
    return one_step_theta(0.5)


def heun() -> TimeSteppingScheme:
    """SSP RK2 (Heun)."""
    return TimeSteppingScheme(
        name="Heun", implicit=False, order=2,
        a=np.array([[-1.0, 1.0, 0.0],
                    [-0.5, -0.5, 1.0]]),
        b=np.array([[1.0, 0.0, 0.0],
                    [0.0, 0.5, 0.0]]),
        d=np.array([0.0, 1.0, 1.0]),
    )


def shu3() -> TimeSteppingScheme:
    """Shu-Osher SSP RK3."""
    return TimeSteppingScheme(
        name="Shu3", implicit=False, order=3,
        a=np.array([[-1.0, 1.0, 0.0, 0.0],
                    [-0.75, -0.25, 1.0, 0.0],
                    [-1.0 / 3.0, 0.0, -2.0 / 3.0, 1.0]]),
        b=np.array([[1.0, 0.0, 0.0, 0.0],
                    [0.0, 0.25, 0.0, 0.0],
                    [0.0, 0.0, 2.0 / 3.0, 0.0]]),
        d=np.array([0.0, 1.0, 0.5, 1.0]),
    )


def rk4() -> TimeSteppingScheme:
    """Classical RK4 in solution-stage form."""
    return TimeSteppingScheme(
        name="RK4", implicit=False, order=4,
        a=np.array([[-1.0, 1.0, 0.0, 0.0, 0.0],
                    [-1.0, 0.0, 1.0, 0.0, 0.0],
                    [-1.0, 0.0, 0.0, 1.0, 0.0],
                    [-1.0, 0.0, 0.0, 0.0, 1.0]]),
        b=np.array([[0.5, 0.0, 0.0, 0.0, 0.0],
                    [0.0, 0.5, 0.0, 0.0, 0.0],
                    [0.0, 0.0, 1.0, 0.0, 0.0],
                    [1.0 / 6, 1.0 / 3, 1.0 / 3, 1.0 / 6, 0.0]]),
        d=np.array([0.0, 0.5, 0.5, 1.0, 1.0]),
    )


def alexander2() -> TimeSteppingScheme:
    """Alexander's 2-stage, 2nd-order, L-stable DIRK."""
    g = 1.0 - np.sqrt(2.0) / 2.0
    return TimeSteppingScheme(
        name="Alexander2", implicit=True, order=2,
        a=np.array([[-1.0, 1.0, 0.0],
                    [-1.0, 0.0, 1.0]]),
        b=np.array([[0.0, g, 0.0],
                    [0.0, 1.0 - g, g]]),
        d=np.array([0.0, g, 1.0]),
    )


def alexander3() -> TimeSteppingScheme:
    """Alexander's 3-stage, 3rd-order, L-stable, stiffly-accurate DIRK."""
    # gamma = root of x^3 - 3x^2 + 3/2 x - 1/6 in (1/6, 1/2)
    g = 0.4358665215084590
    t2 = (1.0 + g) / 2.0
    b1 = -(6.0 * g * g - 16.0 * g + 1.0) / 4.0
    b2 = (6.0 * g * g - 20.0 * g + 5.0) / 4.0
    return TimeSteppingScheme(
        name="Alexander3", implicit=True, order=3,
        a=np.array([[-1.0, 1.0, 0.0, 0.0],
                    [-1.0, 0.0, 1.0, 0.0],
                    [-1.0, 0.0, 0.0, 1.0]]),
        b=np.array([[0.0, g, 0.0, 0.0],
                    [0.0, t2 - g, g, 0.0],
                    [0.0, b1, b2, g]]),
        d=np.array([0.0, g, t2, 1.0]),
    )


def fractional_step_theta() -> TimeSteppingScheme:
    """Glowinski 3-stage fractional-step-theta (strongly A-stable, 2nd order
    for the symmetric choice)."""
    th = 1.0 - np.sqrt(2.0) / 2.0
    alpha = (1.0 - 2.0 * th) / (1.0 - th)
    beta = th / (1.0 - th)
    return TimeSteppingScheme(
        name="FractionalStepTheta", implicit=True, order=2,
        a=np.array([[-1.0, 1.0, 0.0, 0.0],
                    [0.0, -1.0, 1.0, 0.0],
                    [0.0, 0.0, -1.0, 1.0]]),
        b=np.array([[th * beta, th * alpha, 0.0, 0.0],
                    [0.0, (1 - 2 * th) * alpha, (1 - 2 * th) * beta, 0.0],
                    [0.0, 0.0, th * beta, th * alpha]]),
        d=np.array([0.0, th, 1.0 - th, 1.0]),
    )


SCHEMES = {
    "implicit_euler": implicit_euler,
    "explicit_euler": explicit_euler,
    "crank_nicolson": crank_nicolson,
    "heun": heun,
    "shu3": shu3,
    "rk4": rk4,
    "alexander2": alexander2,
    "alexander3": alexander3,
    "fractional_step_theta": fractional_step_theta,
}
