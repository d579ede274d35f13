"""The target configurations as runnable models.

PyTorch port of dune_pdelab_tpu/models/configs.py: each function builds,
solves and checks one configuration of BASELINE.md and returns the
reference's dict (the keys of tests/golden_parity.json). They run on
`device` (default: the default device, the card unless the caller asked
for the CPU) in fp64, as the goldens were recorded.

`info`, when given a dict, receives the objects of the run (space,
GridOperator, linear solver backend, preconditioner, solver) for callers
that report on them (launch counts, tiers) without rebuilding the recipe.

config8 and config13's windowed check run on the port's parallel/ over the
initialised process group (torch.distributed); with none, or a group of
one, config8 runs its windowed solve on one rank and config13 skips the
sharded residual check, as the reference does on one device. `ndevices` is
the group's size.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from dune_pdelab_tpu_torch.models.boilerplate import (
    CGSpace, DGSpace, StructuredGrid, solve_stationary,
)
from dune_pdelab_tpu_torch.ops.convectiondiffusion import (
    ConvectionDiffusionFEM, ConvectionDiffusionProblem,
)
from dune_pdelab_tpu_torch.ops.convectiondiffusiondg import ConvectionDiffusionDG
from dune_pdelab_tpu_torch.ops.l2 import L2
from dune_pdelab_tpu_torch.solvers.linear import LinearSolverBackend, SEQ_BCGS_Jacobi
from dune_pdelab_tpu_torch.space.functions import l2_difference
from dune_pdelab_tpu_torch.utils.common import resolve_device

PI = math.pi
F64 = torch.float64


def _record(info, **objects):
    if info is not None:
        info.update(objects)


class _Sine2D(ConvectionDiffusionProblem):
    def exact(self, p):
        return torch.sin(PI * p[:, 0]) * torch.cos(2 * PI * p[:, 1]) + p[:, 0]

    def f(self, x):
        return 5 * PI**2 * torch.sin(PI * x[..., 0]) * torch.cos(2 * PI * x[..., 1])

    def g(self, x):
        return torch.sin(PI * x[..., 0]) * torch.cos(2 * PI * x[..., 1]) + x[..., 0]


class _Sine3D(ConvectionDiffusionProblem):
    def exact(self, p):
        return torch.sin(PI * p[:, 0]) * torch.sin(PI * p[:, 1]) * torch.sin(PI * p[:, 2])

    def f(self, x):
        return 3 * PI**2 * (torch.sin(PI * x[..., 0]) * torch.sin(PI * x[..., 1])
                            * torch.sin(PI * x[..., 2]))

    def g(self, x):
        return torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)


def _group_size():
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def config1_poisson_2d_mf(cells=64, reduction=1e-10, device=None, info=None):
    """(1) 2D Poisson Q1, matrix-free CG + Jacobi (tutorial00 analog)."""
    p = _Sine2D()
    V = CGSpace(StructuredGrid(2, cells), 1)
    ls = LinearSolverBackend(solver="cg", precond="jacobi", use_stencil=False)
    res = solve_stationary(V, ConvectionDiffusionFEM(p), bctype=p.dirichlet_bctype(),
                           dirichlet=p.g, linear_solver=ls, reduction=reduction,
                           device=device, dtype=F64)
    _record(info, space=V, go=res.solver.go, ls=ls, solver=res.solver, x=res.x)
    return {"l2_error": float(l2_difference(V, res.x, p.exact)),
            "iterations": res.iterations, "ndofs": V.ndofs,
            "converged": res.solver.result.converged}


def config2_poisson_3d_gmg(cells=16, reduction=1e-10, device=None, info=None):
    """(2) 3D Poisson Q2, CG + geometric multigrid."""
    from dune_pdelab_tpu_torch.fe.basis import QkFEM
    from dune_pdelab_tpu_torch.linalg.multigrid import GeometricMultigrid

    device = resolve_device(device)
    p = _Sine3D()
    mesh = StructuredGrid(3, cells)
    V = CGSpace(mesh, 2)
    gmg = GeometricMultigrid(ConvectionDiffusionFEM(p), mesh, QkFEM(2, 3),
                             bctype=p.dirichlet_bctype(), device=device)
    ls = LinearSolverBackend(solver="cg", precond=gmg)
    res = solve_stationary(V, ConvectionDiffusionFEM(p), bctype=p.dirichlet_bctype(),
                           linear_solver=ls, reduction=reduction, device=device, dtype=F64)
    _record(info, space=V, go=res.solver.go, ls=ls, precond=gmg, solver=res.solver, x=res.x)
    return {"l2_error": float(l2_difference(V, res.x, p.exact)),
            "iterations": res.iterations, "ndofs": V.ndofs, "levels": gmg.nlevels,
            "converged": res.solver.result.converged}


class _CD(_Sine2D):
    """config3's convection b = (1, 0.5), with the source adjusted for it."""

    def A(self, x):
        return 1.0

    def b(self, x):
        return torch.broadcast_to(torch.tensor([1.0, 0.5], dtype=x.dtype, device=x.device),
                                  x.shape)

    def f(self, x):
        gx = PI * torch.cos(PI * x[..., 0]) * torch.cos(2 * PI * x[..., 1]) + 1.0
        gy = -2 * PI * torch.sin(PI * x[..., 0]) * torch.sin(2 * PI * x[..., 1])
        return super().f(x) + 1.0 * gx + 0.5 * gy


def config3_convdiff_sipg(cells=32, degree=2, reduction=1e-10, device=None,
                          info=None):
    """(3) Convection-diffusion SIPG DG + BiCGStab (upwinded)."""
    p = _CD()
    V = DGSpace(StructuredGrid(2, cells), degree)
    ls = SEQ_BCGS_Jacobi()
    res = solve_stationary(V, ConvectionDiffusionDG(p), linear_solver=ls,
                           reduction=reduction, device=device, dtype=F64)
    _record(info, space=V, go=res.solver.go, ls=ls, solver=res.solver, x=res.x)
    return {"l2_error": float(l2_difference(V, res.x, p.exact)),
            "iterations": res.iterations, "ndofs": V.ndofs,
            "converged": res.solver.result.converged}


_LAM = 2 * PI**2


class _Heat(ConvectionDiffusionProblem):
    def u_exact(self, t):
        return lambda p: math.exp(-t) * torch.sin(PI * p[:, 0]) * torch.sin(PI * p[:, 1])

    def f(self, x):
        return ((_LAM - 1.0) * math.exp(-self.time) * torch.sin(PI * x[..., 0])
                * torch.sin(PI * x[..., 1]))


def config4_heat_theta_newton(cells=16, nsteps=10, dt=0.02, device=None,
                              info=None):
    """(4) Instationary heat, one-step-theta (Crank-Nicolson) + Newton per
    step."""
    from dune_pdelab_tpu_torch.assembly.gridoperator import GridOperator
    from dune_pdelab_tpu_torch.constraints.dirichlet import constraints
    from dune_pdelab_tpu_torch.instationary import OneStepMethod, crank_nicolson

    device = resolve_device(device)
    p = _Heat()
    V = CGSpace(StructuredGrid(2, cells), 1)
    cg_ = constraints(p.dirichlet_bctype(), V, device=device)
    go0 = GridOperator(V, ConvectionDiffusionFEM(p), constraints=cg_)
    go1 = GridOperator(V, L2(), constraints=cg_)
    ls = LinearSolverBackend(solver="cg", precond="jacobi")
    osm = OneStepMethod(crank_nicolson(), go0, go1, ls, pdesolver="newton", reduction=1e-9)
    x = V.interpolate(p.u_exact(0.0), dtype=F64, device=device)
    t = 0.0
    for _ in range(nsteps):
        x = osm.apply(t, dt, x)
        t += dt
    _record(info, space=V, go=go0, ls=ls, solver=osm, x=x)
    return {"l2_error": float(l2_difference(V, x, p.u_exact(t))), "t_final": t,
            "ndofs": V.ndofs, "newton_iterations": osm.result.total_newton_iterations}


def _a(x):
    return x**2 * (1 - x) ** 2


def _da(x):
    return 2 * x * (1 - x) * (1 - 2 * x)


def _dda(x):
    return 12 * x**2 - 12 * x + 2


def _ddda(x):
    return 24 * x - 12


def _velocity_error(W, x, exact):
    Vv = W.children[0].children[0]
    err2 = 0.0
    for c in range(2):
        xc = W.children[0].restrict(W.restrict(x, 0), c)
        err2 += float(l2_difference(Vv, xc, lambda p, c=c: exact(p)[:, c])) ** 2
    return math.sqrt(err2)


def config5_stokes_taylor_hood(cells=8, reduction=1e-9, device=None, info=None):
    """(5) Stokes Taylor-Hood Q2/Q1, block-preconditioned GMRES (velocity
    GMG + pressure-mass Schur)."""
    from dune_pdelab_tpu_torch.assembly.gridoperator import GridOperator
    from dune_pdelab_tpu_torch.ops.stokes import NavierStokesParameters, TaylorHoodNavierStokes
    from dune_pdelab_tpu_torch.solvers.stationary import StationaryLinearProblemSolver
    from dune_pdelab_tpu_torch.solvers.stokes import (
        StokesGMGSchur, stokes_constraints, taylor_hood_space,
    )

    class MS(NavierStokesParameters):
        def __init__(self):
            super().__init__(mu=1.0, rho=0.0)

        def f(self, x):
            xx, yy = x[..., 0], x[..., 1]
            f1 = -(_dda(xx) * _da(yy) + _a(xx) * _ddda(yy)) + 3 * xx**2
            f2 = (_ddda(xx) * _a(yy) + _da(xx) * _dda(yy)) + 3 * yy**2
            return torch.stack([f1, f2], dim=-1)

    def u_exact(p):
        return torch.stack([_a(p[:, 0]) * _da(p[:, 1]), -_da(p[:, 0]) * _a(p[:, 1])], dim=-1)

    device = resolve_device(device)
    W = taylor_hood_space(StructuredGrid(2, cells), 2)
    go = GridOperator(W, TaylorHoodNavierStokes(MS()),
                      constraints=stokes_constraints(W, device=device))
    pre = StokesGMGSchur(W, mu=1.0, device=device)
    ls = LinearSolverBackend(solver="gmres", precond=pre, restart=100, maxiter=20000)
    slp = StationaryLinearProblemSolver(go, ls, reduction=reduction, verbose=0)
    x = slp.apply(W.zero(F64, device))
    _record(info, space=W, go=go, ls=ls, precond=pre, solver=slp, x=x)
    return {"velocity_l2_error": _velocity_error(W, x, u_exact),
            "iterations": slp.result.linear_solver_iterations, "ndofs": W.ndofs,
            "converged": slp.result.converged}


def _corner_exact(p):
    """r^(2/3) sin(2 theta / 3) at point tensors (host arithmetic)."""
    q = np.asarray(p.detach().cpu().numpy() if isinstance(p, torch.Tensor) else p)
    q = q.reshape(-1, 2)
    r = np.hypot(q[:, 0], q[:, 1])
    th = np.mod(np.arctan2(q[:, 1], q[:, 0]), 2 * np.pi)
    return np.where(r == 0, 0.0, r ** (2 / 3) * np.sin(2 * th / 3))


class _Corner(ConvectionDiffusionProblem):
    def f(self, x):
        return torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)

    def g(self, x):
        return torch.as_tensor(_corner_exact(x).reshape(x.shape[:-1]), dtype=x.dtype,
                               device=x.device)


def config6_adaptive_lshape(cycles=4, reduction=1e-12, device=None, info=None):
    """(6) Adaptive L-shape corner singularity: estimate -> mark -> bisect on
    the simplex newest-vertex-bisection path (reference:
    dune/pdelab/test/testadaptivity.cc; adaptivity/adaptivity.hh:632).
    Golden keys: per-cycle ndofs and L2 error, final-solve CG iterations."""
    from dune_pdelab_tpu_torch.adaptivity.adaptivity import error_fraction, mark_elements
    from dune_pdelab_tpu_torch.adaptivity.local import (
        adapt_local_simplex, p1_edge_jump_indicator,
    )
    from dune_pdelab_tpu_torch.assembly.gridoperator import GridOperator
    from dune_pdelab_tpu_torch.constraints.dirichlet import constraints, interpolate_dirichlet
    from dune_pdelab_tpu_torch.fe.basis import PkFEM
    from dune_pdelab_tpu_torch.mesh.simplex import SimplexMesh
    from dune_pdelab_tpu_torch.solvers.linear import SEQ_CG_Jacobi
    from dune_pdelab_tpu_torch.solvers.stationary import StationaryLinearProblemSolver
    from dune_pdelab_tpu_torch.space.space import FunctionSpace

    device = resolve_device(device)

    def solve(V):
        cgm = constraints(True, V, device=device)
        go = GridOperator(V, ConvectionDiffusionFEM(_Corner()), constraints=cgm)
        x0 = interpolate_dirichlet(_corner_exact, V, cgm, V.zero(F64, device))
        slp = StationaryLinearProblemSolver(go, SEQ_CG_Jacobi(maxiter=20000),
                                            reduction=reduction, verbose=0)
        return slp.apply(x0), slp.result.linear_solver_iterations

    sq = SimplexMesh.from_structured(StructuredGrid(2, 8, [-1, -1], [1, 1]))
    c = sq.element_centers()
    mesh = sq.submesh(~((c[:, 0] > 0) & (c[:, 1] < 0))).oriented_for_bisection()
    V = FunctionSpace(mesh, PkFEM(1, 2))
    x, its = solve(V)
    out = {}
    for cyc in range(cycles):
        out[f"ndofs_cycle{cyc}"] = V.ndofs
        out[f"l2_cycle{cyc}"] = float(l2_difference(V, x, _corner_exact))
        eta2 = p1_edge_jump_indicator(V, x)
        marks, _ = mark_elements(eta2, error_fraction(eta2, 0.5))
        V, x = adapt_local_simplex(V, x, marks)
        x, its = solve(V)
    _record(info, space=V, x=x)
    out["ndofs"] = V.ndofs
    out["l2_error"] = float(l2_difference(V, x, _corner_exact))
    out["iterations"] = its
    return out


def config7_dg_twolevel(cells=32, degree=1, reduction=1e-10, device=None,
                        info=None):
    """(7) SIPG DG Poisson with the two-level DG->CG multigrid preconditioner
    (AMG-for-DG analog, reference: backend/istl/seq_amg_dg_backend.hh:146).
    Golden: CG iteration count."""
    from dune_pdelab_tpu_torch.assembly.gridoperator import GridOperator
    from dune_pdelab_tpu_torch.linalg import DGTwoLevel
    from dune_pdelab_tpu_torch.ops.convectiondiffusiondg import DGMethod
    from dune_pdelab_tpu_torch.solvers.stationary import StationaryLinearProblemSolver

    device = resolve_device(device)
    p = _Sine2D()
    V = DGSpace(StructuredGrid(2, cells), degree)
    go = GridOperator(V, ConvectionDiffusionDG(p, method=DGMethod.SIPG))
    pre = DGTwoLevel(go, ConvectionDiffusionFEM(p), bctype=p.dirichlet_bctype(),
                     device=device)
    ls = LinearSolverBackend(solver="cg", precond=pre, use_stencil=False)
    slp = StationaryLinearProblemSolver(go, ls, reduction=reduction, verbose=0)
    x = slp.apply(V.zero(F64, device))
    _record(info, space=V, go=go, ls=ls, precond=pre, solver=slp, x=x)
    return {"l2_error": float(l2_difference(V, x, p.exact)),
            "iterations": slp.result.linear_solver_iterations, "ndofs": V.ndofs,
            "converged": slp.result.converged}


def config8_windowed_sharded(cells=16, degree=1, reduction=1e-10, device=None,
                             info=None):
    """(8) Window-sharded SIPG DG solve over the process group: halo-only
    exchanges, iteration parity with the sequential operator (reference
    parallel oracle: novlpistlsolverbackend.hh:330). Every rank of the
    group calls it. Golden: sharded CG iterations, L2 error, rank count."""
    from dune_pdelab_tpu_torch.assembly.gridoperator import GridOperator
    from dune_pdelab_tpu_torch.ops.convectiondiffusiondg import DGMethod
    from dune_pdelab_tpu_torch.parallel.windowed import WindowShardedGridOperator

    device = resolve_device(device)
    p = _Sine2D()
    V = DGSpace(StructuredGrid(2, cells), degree)
    go = GridOperator(V, ConvectionDiffusionDG(p, method=DGMethod.SIPG))
    wgo = WindowShardedGridOperator(go, device=device)
    x0 = V.zero(F64, device)
    b = go.residual(x0)
    z, stats = wgo.solve_cg(x0, b, diag=go.jacobian_diagonal(x0),
                            tol=reduction * float(torch.linalg.norm(b)), maxiter=5000)
    x = x0 - z
    _record(info, space=V, go=go, wgo=wgo, stats=stats, x=x)
    return {"l2_error": float(l2_difference(V, x, p.exact)),
            "iterations": int(stats.iterations), "ndofs": V.ndofs,
            "ndevices": _group_size()}


class _Var3D(_Sine3D):
    """u = sin(pi x) sin(pi y) sin(pi z), A = a(x, y) I with
    a = 1 + 0.5 sin(2x) y, so f = 3 pi^2 a u - grad(a).grad(u)."""

    def A(self, x):
        a = 1.0 + 0.5 * torch.sin(2 * x[..., 0]) * x[..., 1]
        return a[..., None, None] * torch.eye(x.shape[-1], dtype=x.dtype, device=x.device)

    def f(self, x):
        xx, yy, zz = x[..., 0], x[..., 1], x[..., 2]
        sx, sy, sz = torch.sin(PI * xx), torch.sin(PI * yy), torch.sin(PI * zz)
        a = 1.0 + 0.5 * torch.sin(2 * xx) * yy
        dax = torch.cos(2 * xx) * yy
        day = 0.5 * torch.sin(2 * xx)
        ux = PI * torch.cos(PI * xx) * sy * sz
        uy = PI * sx * torch.cos(PI * yy) * sz
        return 3 * PI**2 * a * sx * sy * sz - dax * ux - day * uy


def config9_assembled_ilu(cells=12, reduction=1e-10, device=None, info=None):
    """(9) 3D variable-coefficient Poisson Q1 through the assembled
    lattice-ELL path with lattice ILU(0) CG (the BCRS + SEQ_CG_ILU0
    analog, reference: seqistlsolverbackend.hh:112-1060). Golden: iteration
    count and L2 error."""
    from dune_pdelab_tpu_torch.assembly.gridoperator import GridOperator
    from dune_pdelab_tpu_torch.constraints.dirichlet import constraints
    from dune_pdelab_tpu_torch.solvers import SEQ_CG_ILU0
    from dune_pdelab_tpu_torch.solvers.stationary import StationaryLinearProblemSolver

    device = resolve_device(device)
    p = _Var3D()
    V = CGSpace(StructuredGrid(3, cells), 1)
    go = GridOperator(V, ConvectionDiffusionFEM(p),
                      constraints=constraints(p.dirichlet_bctype(), V, device=device))
    ls = SEQ_CG_ILU0(use_stencil=False)
    slp = StationaryLinearProblemSolver(go, ls, reduction=reduction, verbose=0)
    x = slp.apply(V.zero(F64, device))
    _record(info, space=V, go=go, ls=ls, solver=slp, x=x)
    return {"l2_error": float(l2_difference(V, x, p.exact)),
            "iterations": slp.result.linear_solver_iterations, "ndofs": V.ndofs,
            "converged": slp.result.converged}


def config10_stokes_outflow(cells=6, reduction=1e-11, device=None, info=None):
    """(10) Poiseuille channel with the StokesBC protocol: Dirichlet inflow
    and walls, a STRESS_NEUMANN outflow traction j = p_out n that sets the
    pressure level (reference: stokesparameter.hh:32 codes,
    taylorhoodnavierstokes.hh:300 lambda_boundary). The exact solution is
    in Q2/Q1; the golden pins the GMRES iteration count and the errors."""
    from dune_pdelab_tpu_torch.assembly.gridoperator import GridOperator
    from dune_pdelab_tpu_torch.constraints.dirichlet import constraints
    from dune_pdelab_tpu_torch.mesh.structured import StructuredMesh
    from dune_pdelab_tpu_torch.ops.stokes import (
        NavierStokesParameters, StokesBC, TaylorHoodNavierStokes,
    )
    from dune_pdelab_tpu_torch.solvers.stationary import StationaryLinearProblemSolver
    from dune_pdelab_tpu_torch.solvers.stokes import StokesBlockJacobi, taylor_hood_space

    MU, L, P0 = 0.7, 2.0, 1.3

    def u_exact(p):
        return torch.stack([p[:, 1] * (1 - p[:, 1]), torch.zeros_like(p[:, 0])], dim=-1)

    class Poiseuille(NavierStokesParameters):
        def __init__(self):
            super().__init__(mu=MU, rho=0.0)

        def g(self, x):
            return torch.stack([x[..., 1] * (1 - x[..., 1]), torch.zeros_like(x[..., 0])],
                               dim=-1)

        def bctype(self, x):
            on_wall = (x[..., 1] < 1e-10) | (x[..., 1] > 1 - 1e-10)
            on_out = x[..., 0] > L - 1e-10
            return torch.where(on_wall, StokesBC.VELOCITY_DIRICHLET,
                               torch.where(on_out, StokesBC.STRESS_NEUMANN,
                                           StokesBC.VELOCITY_DIRICHLET))

        def j(self, x, normal):
            return P0 * normal

    device = resolve_device(device)
    prm = Poiseuille()
    W = taylor_hood_space(StructuredMesh([0, 0], [L, 1], (2 * cells, cells)), degree=2)
    cg_ = constraints((prm.velocity_bctype(), None), W, device=device)
    go = GridOperator(W, TaylorHoodNavierStokes(prm), constraints=cg_)
    pre = StokesBlockJacobi(W, MU, device=device)
    ls = LinearSolverBackend(solver="gmres", precond=pre, restart=150, maxiter=40000)
    slp = StationaryLinearProblemSolver(go, ls, reduction=reduction, verbose=0)
    # the Dirichlet data rides the initial iterate (constrained DOFs are
    # invariant under the solve)
    xg = W.interpolate((u_exact, lambda p: torch.zeros(len(p), dtype=F64, device=p.device)),
                       dtype=F64, device=device)
    x = slp.apply(torch.where(cg_.mask_on(device), xg, 0.0))
    _record(info, space=W, go=go, ls=ls, precond=pre, solver=slp, x=x)
    perr = float(l2_difference(W.children[1], W.restrict(x, 1),
                               lambda p: 2 * MU * (L - p[:, 0]) + P0))
    return {"l2_v_error": _velocity_error(W, x, u_exact), "l2_p_error": perr,
            "iterations": slp.result.linear_solver_iterations, "ndofs": W.ndofs,
            "converged": slp.result.converged}


def config11_twophase_displacement(cells=24, tend=0.008, device=None, info=None):
    """(11) Two-phase immiscible displacement (twophaseccfv.hh analog):
    sigmoid capillary closure, Dirichlet inflow/outflow, implicit Euler +
    Newton with failed-step dt halving. The golden pins the endpoint
    saturations of the front, the total Newton iterations and the failed
    steps."""
    from dune_pdelab_tpu_torch.assembly.gridoperator import GridOperator
    from dune_pdelab_tpu_torch.fe.basis import P0FEM
    from dune_pdelab_tpu_torch.instationary import OneStepMethod, implicit_euler
    from dune_pdelab_tpu_torch.mesh.structured import StructuredMesh
    from dune_pdelab_tpu_torch.ops.twophase import (
        TwoPhaseCCFV, TwoPhaseParameters, TwoPhaseStorage,
    )
    from dune_pdelab_tpu_torch.space.space import FunctionSpace, PowerSpace

    class Displacement(TwoPhaseParameters):
        def is_dirichlet(self, x):
            return (x[..., 0] < 1e-9) | (x[..., 0] > 1 - 1e-9)

        def g_l(self, x):
            return torch.where(x[..., 0] < 0.5, 2.0, 0.0)

        def g_g(self, x):
            return torch.where(x[..., 0] < 0.5, 1.5, 1.5)

    device = resolve_device(device)
    prm = Displacement(phi=0.2, K=1.0, mu_l=1.0, mu_g=0.2, pc_scale=1.0)
    mesh = StructuredMesh([0, 0], [1, 0.25], (cells, 2))
    W = PowerSpace(FunctionSpace(mesh, P0FEM(2)), 2)
    ls = SEQ_BCGS_Jacobi()
    osm = OneStepMethod(implicit_euler(), GridOperator(W, TwoPhaseCCFV(prm)),
                        GridOperator(W, TwoPhaseStorage(prm)), ls,
                        pdesolver="newton", reduction=1e-7, max_iterations=40,
                        min_linear_reduction=1e-4)
    E = mesh.nelements
    x = torch.cat([torch.zeros(E, dtype=F64, device=device),
                   torch.full((E,), 0.5, dtype=F64, device=device)])
    t, x = osm.solve(0.0, 1e-3, tend, x, max_step_retries=4)
    _record(info, space=W, go=osm.igos, ls=ls, solver=osm, x=x)
    pl, pg = W.restrict(x, 0).cpu().numpy(), W.restrict(x, 1).cpu().numpy()
    s_l = 1.0 / (1.0 + np.exp(-4.0 * (0.5 - (pg - pl))))
    centers = mesh.element_centers()
    row = np.isclose(centers[:, 1], centers[0, 1])
    s_row = s_l[row][np.argsort(centers[row][:, 0])]
    return {"s_inlet": float(s_row[0]), "s_outlet": float(s_row[-1]),
            "newton_iterations": osm.result.total_newton_iterations,
            "failed_steps": osm.result.failed_steps, "ndofs": W.ndofs, "t_final": float(t)}


def config12_simplex_amg(cells=32, reduction=1e-10, device=None, info=None):
    """(12) Simplex P1 Poisson solved by CG + smoothed-aggregation AMG
    (ISTLBackend_SEQ_CG_AMG analog, linalg/amg.py). The golden pins the
    AMG-CG iteration count and the hierarchy's level count."""
    from dune_pdelab_tpu_torch.assembly.gridoperator import GridOperator
    from dune_pdelab_tpu_torch.constraints.dirichlet import constraints, interpolate_dirichlet
    from dune_pdelab_tpu_torch.fe.basis import PkFEM
    from dune_pdelab_tpu_torch.linalg.amg import AlgebraicMultigrid
    from dune_pdelab_tpu_torch.mesh.simplex import SimplexMesh
    from dune_pdelab_tpu_torch.solvers.stationary import StationaryLinearProblemSolver
    from dune_pdelab_tpu_torch.space.space import FunctionSpace

    device = resolve_device(device)
    p = _Sine2D()
    V = FunctionSpace(SimplexMesh.from_structured(StructuredGrid(2, cells)), PkFEM(1, 2))
    cg_ = constraints(p.dirichlet_bctype(), V, device=device)
    go = GridOperator(V, ConvectionDiffusionFEM(p), constraints=cg_)
    amg = AlgebraicMultigrid()
    ls = LinearSolverBackend(solver="cg", precond=amg, use_stencil=False)
    x0 = interpolate_dirichlet(p.g, V, cg_, V.zero(F64, device))
    slp = StationaryLinearProblemSolver(go, ls, reduction=reduction, verbose=0)
    x = slp.apply(x0)
    info_h = amg.hierarchy_info()
    _record(info, space=V, go=go, ls=ls, precond=amg, solver=slp, x=x)
    return {"l2_error": float(l2_difference(V, x, p.exact)),
            "iterations": slp.result.linear_solver_iterations,
            "levels": len(info_h["sizes"]),
            "operator_complexity": info_h["operator_complexity"],
            "ndofs": V.ndofs, "converged": slp.result.converged}


def config13_scale_lattice_gmg(cells=128, reduction=1e-10, device=None,
                               info=None):
    """(13) At-scale golden: 3D Poisson Q1 at cells^3 (default 128^3 = 2.15M
    DOFs) through the north-star solve path, lattice-GMG-preconditioned CG
    on the compiled stencil; on a process group of more than one rank also
    a window-sharded residual cross-check (every rank calls it then)."""
    from dune_pdelab_tpu_torch.assembly.gridoperator import GridOperator
    from dune_pdelab_tpu_torch.assembly.stencil import compile_stencil
    from dune_pdelab_tpu_torch.constraints.dirichlet import constraints, interpolate_dirichlet
    from dune_pdelab_tpu_torch.fe.basis import QkFEM
    from dune_pdelab_tpu_torch.linalg.gmg_lattice import LatticeGMG
    from dune_pdelab_tpu_torch.mesh.structured import StructuredMesh
    from dune_pdelab_tpu_torch.space.space import FunctionSpace

    device = resolve_device(device)
    p = _Sine3D()
    V = FunctionSpace(StructuredMesh([0, 0, 0], [1, 1, 1], (cells,) * 3), QkFEM(1, 3))
    cg_ = constraints(p.dirichlet_bctype(), V, device=device)
    lop = ConvectionDiffusionFEM(p)
    go = GridOperator(V, lop, constraints=cg_)
    x0 = interpolate_dirichlet(p.g, V, cg_, V.zero(F64, device))
    b = -go.residual(x0, 0.0)
    st = compile_stencil(go, dtype=F64, device=device)
    gmg = LatticeGMG(V, lop, fine_stencil=st, device=device)
    z, res = gmg.solve_host(b, tol=reduction, maxiter=60)
    x = x0 + z
    _record(info, space=V, go=go, stencil=st, precond=gmg, x=x)
    out = {"l2_error": float(l2_difference(V, x, p.exact)),
           "iterations": int(res["iterations"]),
           "true_rel_defect": res["true_defect"] / res["defect0"],
           "levels": gmg.nlevels, "ndofs": V.ndofs, "converged": bool(res["converged"])}
    if _group_size() > 1:
        from dune_pdelab_tpu_torch.parallel.windowed import WindowShardedGridOperator
        wgo = WindowShardedGridOperator(go, device=device)
        maxdiff = float((wgo.residual(x) - go.residual(x)).abs().max())
        out["windowed_parity_ok"] = 1.0 if maxdiff < 1e-10 else 0.0
    return out


ALL_CONFIGS = {
    "config1": config1_poisson_2d_mf,
    "config2": config2_poisson_3d_gmg,
    "config3": config3_convdiff_sipg,
    "config4": config4_heat_theta_newton,
    "config5": config5_stokes_taylor_hood,
    "config6": config6_adaptive_lshape,
    "config7": config7_dg_twolevel,
    "config8": config8_windowed_sharded,
    "config9": config9_assembled_ilu,
    "config10": config10_stokes_outflow,
    "config11": config11_twophase_displacement,
    "config12": config12_simplex_amg,
    "config13": config13_scale_lattice_gmg,
}
