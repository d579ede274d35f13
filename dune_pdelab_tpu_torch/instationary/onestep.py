"""One-step (Runge-Kutta) time integrators.

PyTorch port of dune_pdelab_tpu/instationary/onestep.py (reference:
dune/pdelab/gridoperator/onestep.hh:18 OneStepGridOperator,
onestep/prestageengine.hh:19 constant-residual accumulation,
instationary/implicitonestep.hh:56 OneStepMethod,
instationary/explicitonestep.hh:109 ExplicitOneStepMethod and the CFL
controller).

PDELab re-sweeps the grid per stage to accumulate
sum_i [a(r,i) m(u_i) + b(r,i) dt alpha(u_i)]; here the per-stage constant
residual is a weighted sum of cached residual vectors alpha(u_i), m(u_i):
one assembly per stage, the rest is axpys. The stage system travels
through the solver stack (Newton, the linear backends, a
GeometricMultigrid) as `StageContext`, an opaque `time` of plain floats
and the constant-residual tensor (the reference's traced jax scalars
existed for its jit; eager torch has nothing to retrace). A problem's
`time` is therefore always a float.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple

import numpy as np
import torch

from dune_pdelab_tpu_torch.instationary.tableaux import TimeSteppingScheme
from dune_pdelab_tpu_torch.solvers.newton import NewtonError, NewtonMethod
from dune_pdelab_tpu_torch.solvers.stationary import StationaryLinearProblemSolver


class StageContext(NamedTuple):
    """Opaque stage descriptor passed through solver `time` parameters."""
    t: Any          # stage time
    wa: Any         # mass weight a[r,r]
    wb: Any         # spatial weight dt * b[r,r]
    const: Any      # accumulated constant residual (unconstrained)


class _StageLOPInfo:
    """Minimal lop-protocol shim for the solver backends."""

    def __init__(self, is_linear):
        self.is_linear = is_linear


class OneStepGridOperator:
    """Stage operator combining the spatial GO (go0) and the temporal (mass)
    GO (go1):

    residual(u, sc) = sc.wa * m(u) + sc.wb * alpha(u) + sc.const, with
    constrained rows zeroed (reference: gridoperator/onestep.hh:147-181 and
    the stage-weight injection OneStepLocalAssembler::setWeight,
    onestep/localassembler.hh:175).
    """

    def __init__(self, go0, go1):
        if go0.space is not go1.space:
            raise ValueError("spatial and temporal operators must share a space")
        self.go0 = go0
        self.go1 = go1
        self.cg = go0.cg
        self.space = go0.space
        self.mesh = go0.mesh
        # dt-dependent weights make the combined operator's preconditioner
        # data stage-dependent: the backends set it up at every solve
        self.lop = _StageLOPInfo(is_linear=False)

    @property
    def elem_gdofs_cat(self):
        return self.go0.elem_gdofs_cat

    def _mask(self, x):
        return self.cg.mask_on(x.device)

    def residual_unconstrained(self, x, sc: StageContext):
        return (sc.wa * self.go1.residual_unconstrained(x, sc.t)
                + sc.wb * self.go0.residual_unconstrained(x, sc.t)
                + sc.const)

    def residual(self, x, sc: StageContext):
        r = self.residual_unconstrained(x, sc)
        if self.cg is not None:
            r = torch.where(self._mask(x), 0.0, r)
        return r

    def jacobian_apply(self, x, z, sc: StageContext):
        """J z = wa * M z + wb * A(x) z, identity on constrained rows."""
        zf = z if self.cg is None else torch.where(self._mask(z), 0.0, z)
        _, jz = torch.func.jvp(
            lambda y: (sc.wa * self.go1.residual_unconstrained(y, sc.t, lambdas=False)
                       + sc.wb * self.go0.residual_unconstrained(y, sc.t, lambdas=False)),
            (x,), (zf,))
        if self.cg is not None:
            jz = torch.where(self._mask(z), z, jz)
        return jz

    def jacobian_diagonal(self, x, sc: StageContext):
        d = (sc.wa * self.go1.jacobian_diagonal(x, sc.t)
             + sc.wb * self.go0.jacobian_diagonal(x, sc.t))
        if self.cg is not None:
            d = torch.where(self._mask(x), 1.0, d)
        return d

    def element_jacobians(self, x, sc: StageContext):
        return (sc.wa * self.go1.element_jacobians(x, sc.t)
                + sc.wb * self.go0.element_jacobians(x, sc.t))

    def element_diagonal_blocks(self, x, sc: StageContext):
        return (sc.wa * self.go1.element_diagonal_blocks(x, sc.t)
                + sc.wb * self.go0.element_diagonal_blocks(x, sc.t))

    def jacobian(self, x, sc: StageContext):
        """Sparse COO Jacobian. Both operators carry unit rows on the
        constrained DOFs, so the sum's constrained diagonal is wa + wb, as
        in the reference's sum of BCOO matrices."""
        return (sc.wb * self.go0.jacobian(x, sc.t)
                + sc.wa * self.go1.jacobian(x, sc.t)).coalesce()


@dataclass
class OneStepResult:
    """OneStepMethodResult analog (implicitonestep.hh:22-54)."""
    steps: int = 0
    failed_steps: int = 0
    total_newton_iterations: int = 0
    total_linear_iterations: int = 0


def _stage_const(scheme, r, dt, xold, stage_x, time, cache, go0, go1):
    """sum_{i<r} a[r-1,i] m(u_i) + dt b[r-1,i] alpha(u_i), each residual
    assembled once per step (`cache` holds them by (kind, stage))."""
    a, b, d = scheme.a, scheme.b, scheme.d
    const = torch.zeros_like(xold)
    for i in range(r):
        t_i = time + float(d[i]) * dt
        if a[r - 1, i] != 0.0:
            if ("m", i) not in cache:
                cache["m", i] = go1.residual_unconstrained(stage_x[i], t_i)
            const = const + a[r - 1, i] * cache["m", i]
        if b[r - 1, i] != 0.0:
            if ("a", i) not in cache:
                cache["a", i] = go0.residual_unconstrained(stage_x[i], t_i)
            const = const + dt * b[r - 1, i] * cache["a", i]
    return const


class OneStepMethod:
    """Implicit one-step (RK) method (reference: implicitonestep.hh:56).

    pdesolver: 'newton' or 'linear'; boundary_values: optional callable
    t -> full DOF vector of Dirichlet data, interpolated again at each
    stage (the BC-reinterpolating variant, reference:
    implicitonestep.hh:291).
    """

    def __init__(self, scheme: TimeSteppingScheme, go0, go1, linear_solver,
                 pdesolver: str = "newton", boundary_values=None,
                 verbose: int = 0, **solver_kwargs):
        self.scheme = scheme
        self.igos = OneStepGridOperator(go0, go1)
        self.boundary_values = boundary_values
        self.verbose = verbose
        self.result = OneStepResult()
        if pdesolver == "newton":
            self.pdesolver = NewtonMethod(self.igos, linear_solver,
                                          verbose=max(0, verbose - 1), **solver_kwargs)
        elif pdesolver == "linear":
            self.pdesolver = StationaryLinearProblemSolver(
                self.igos, linear_solver, verbose=max(0, verbose - 1), **solver_kwargs)
        else:
            raise ValueError(pdesolver)

    def apply(self, time: float, dt: float, xold):
        """Advance one step t -> t + dt; returns x(t + dt)."""
        scheme = self.scheme
        a, b, d = scheme.a, scheme.b, scheme.d
        go0, go1 = self.igos.go0, self.igos.go1
        x = xold
        cache = {}
        stage_x = {0: xold}
        for r in range(1, scheme.stages + 1):
            t_r = time + float(d[r]) * dt
            const = _stage_const(scheme, r, dt, xold, stage_x, time, cache, go0, go1)
            sc = StageContext(t=t_r, wa=float(a[r - 1, r]), wb=dt * float(b[r - 1, r]),
                              const=const)
            x0 = x
            if self.boundary_values is not None and self.igos.cg is not None:
                x0 = torch.where(self.igos.cg.mask_on(x.device),
                                 self.boundary_values(t_r), x0)
            if self.verbose:
                print(f"  stage {r}/{scheme.stages} at t={t_r:.6g}")
            x = self.pdesolver.apply(x0, time=sc)
            stage_x[r] = x
            res = self.pdesolver.result
            self.result.total_newton_iterations += getattr(res, "iterations", 0)
            self.result.total_linear_iterations += getattr(
                res, "linear_solver_iterations", 0)
        self.result.steps += 1
        return x

    def solve(self, t0: float, dt: float, tend: float, x0,
              max_step_retries: int = 0):
        """March from t0 to tend; returns (t_final, x_final).

        max_step_retries > 0 enables failed-step handling (reference:
        implicitonestep.hh:210-233 books the failed step's cost and
        rethrows; here the step is also retried with dt/2, up to
        max_step_retries halvings, before the error propagates): a
        NewtonError adds to result.failed_steps, its iterations stay
        booked, and the step restarts from the state before it.
        """
        t, x = t0, x0
        while t < tend - 1e-12:
            step = min(dt, tend - t)
            retries = 0
            while True:
                try:
                    x_new = self.apply(t, step, x)
                    break
                except NewtonError:
                    self.result.failed_steps += 1
                    retries += 1
                    if retries > max_step_retries:
                        raise
                    step *= 0.5
                    if self.verbose:
                        print(f"  step failed at t={t:.6g}; retrying with dt={step:.6g}")
            x = x_new
            t += step
        return t, x


class TimeControllerInterface:
    """dt suggestion protocol (reference: explicitonestep.hh:26)."""

    def suggest_timestep(self, time, dt, x) -> float:
        return dt


class CFLTimeController(TimeControllerInterface):
    """Scale dt by a CFL target using an operator-reported maximum wave
    speed (reference: CFLTimeController, explicitonestep.hh:64; the LOP
    reports it through `max_speed(x, mesh=...)` or `max_speed(x)`)."""

    def __init__(self, cfl: float, go0):
        self.cfl = cfl
        self.go0 = go0

    def suggest_timestep(self, time, dt, x) -> float:
        lop = self.go0.lop
        if hasattr(lop, "max_speed"):
            try:
                # position-dependent velocity fields are sampled at element
                # centres: one probe point can underestimate the speed
                smax = float(lop.max_speed(x, mesh=self.go0.mesh))
            except TypeError:       # LOPs with the (x) signature
                smax = float(lop.max_speed(x))
            h = float(np.min(self.go0.mesh.h))
            if smax > 0:
                return min(dt, self.cfl * h / smax)
        return dt


class ExplicitOneStepMethod:
    """Explicit RK method: per stage solve wa * M u_r = -const with the mass
    operator (reference: explicitonestep.hh:109,292-420; the block solve
    analog of ISTLBackend_SEQ_ExplicitDiagonal,
    seqistlsolverbackend.hh:659): the element-block mass inverse, exact
    for DG, averaged over shared DOFs for C0. The element results are
    summed through the mass operator's DOF map (a reshape for DG, strided
    slice adds for C0), so the same bits come back on every run."""

    def __init__(self, scheme: TimeSteppingScheme, go0, go1,
                 time_controller: TimeControllerInterface | None = None,
                 limiter=None, verbose: int = 0):
        if scheme.implicit:
            raise ValueError("ExplicitOneStepMethod needs an explicit scheme")
        for r in range(scheme.stages):
            if scheme.b[r, r + 1] != 0.0:
                raise ValueError("scheme has implicit spatial weight")
        self.scheme = scheme
        self.go0 = go0
        self.go1 = go1
        self.cg = go0.cg
        self.controller = time_controller or TimeControllerInterface()
        self.limiter = limiter    # stage post-processing hook
        #                           (explicitonestep.hh:704 Limiter analog)
        self.verbose = verbose
        self._mass_solve = None

    def _build_mass_solve(self, x):
        """Element-block mass inverse, averaged over DOFs that elements
        share; on a composite space the blocks span the concatenated local
        layout of the leaves (go1.elem_gdofs_cat, as in the reference)."""
        from dune_pdelab_tpu_torch.linalg.preconditioners import _explicit_block_inverse

        go1 = self.go1
        dms, sizes = go1.dof_maps, list(go1.local_sizes)
        dinv = _explicit_block_inverse(go1.element_jacobians(x, 0.0))

        def gather(v):
            return torch.cat([dm.gather(v) for dm in dms], dim=1)

        def scatter(like, z_loc):
            out = torch.zeros_like(like)
            for dm, part in zip(dms, torch.split(z_loc, sizes, dim=1)):
                out = dm.scatter_add(out, part)
            return out

        zero = torch.zeros(go1.space.ndofs, dtype=dinv.dtype, device=dinv.device)
        counts = scatter(zero, torch.ones(dinv.shape[:2], dtype=dinv.dtype,
                                          device=dinv.device))

        def solve(rhs):
            z_loc = torch.einsum("ejk,ek->ej", dinv.to(rhs.dtype), gather(rhs))
            return scatter(rhs, z_loc) / counts.to(rhs.dtype)

        return solve

    def apply(self, time: float, dt: float, xold):
        """Advance one step; returns (x_new, dt_used)."""
        dt = self.controller.suggest_timestep(time, dt, xold)
        scheme = self.scheme
        if self._mass_solve is None:
            self._mass_solve = self._build_mass_solve(xold)
        cache, stage_x = {}, {0: xold}
        x = xold
        for r in range(1, scheme.stages + 1):
            const = _stage_const(scheme, r, dt, xold, stage_x, time, cache,
                                 self.go0, self.go1)
            x = self._mass_solve(-const / float(scheme.a[r - 1, r]))
            if self.cg is not None:
                # Dirichlet values stay at the previous stage's
                x = torch.where(self.cg.mask_on(x.device), stage_x[r - 1], x)
            if self.limiter is not None:
                x = self.limiter(x)
            stage_x[r] = x
        return x, dt

    def solve(self, t0: float, dt: float, tend: float, x0):
        t, x = t0, x0
        while t < tend - 1e-12:
            step = min(dt, tend - t)
            x, used = self.apply(t, step, x)
            t += used
        return t, x
