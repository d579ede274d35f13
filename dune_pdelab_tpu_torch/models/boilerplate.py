"""One-call application entry points (the "boilerplate" layer).

PyTorch port of dune_pdelab_tpu/models/boilerplate.py (reference analog:
dune/pdelab/boilerplate/pdelab.hh: StructuredGrid :90, CGSpace :581,
DG*Space :890-1376, P0Space :1376, GalerkinGlobalAssembler :1508 and the
solver wrappers): space, operator and solver from a handful of arguments or
an INI ParameterTree.

Every entry point takes `device` and `dtype` (default: the default device, the
card unless the caller asked for the CPU, and torch's default dtype) for
its vectors and constraints; the operators follow their vectors.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from dune_pdelab_tpu_torch.assembly.gridoperator import GridOperator
from dune_pdelab_tpu_torch.constraints.dirichlet import constraints as make_constraints
from dune_pdelab_tpu_torch.constraints.dirichlet import interpolate_dirichlet
from dune_pdelab_tpu_torch.fe.basis import (
    LegendreDGFEM, MonomialDGFEM, OPBFEM, P0FEM, QkDGFEM, QkFEM,
)
from dune_pdelab_tpu_torch.mesh.structured import StructuredMesh
from dune_pdelab_tpu_torch.solvers.linear import LinearSolverBackend
from dune_pdelab_tpu_torch.solvers.newton import NewtonMethod
from dune_pdelab_tpu_torch.solvers.stationary import StationaryLinearProblemSolver
from dune_pdelab_tpu_torch.space.space import FunctionSpace
from dune_pdelab_tpu_torch.utils.common import default_float, resolve_device
from dune_pdelab_tpu_torch.utils.config import ParameterTree


def StructuredGrid(dim: int, cells, lower=None, upper=None, periodic=None):
    """StructuredGrid analog (boilerplate/pdelab.hh:90): the unit box by
    default, `cells` per axis (an int or one per axis)."""
    lower = lower if lower is not None else [0.0] * dim
    upper = upper if upper is not None else [1.0] * dim
    cells = (cells,) * dim if np.isscalar(cells) else tuple(cells)
    return StructuredMesh(lower, upper, cells, periodic=periodic)


def CGSpace(mesh, degree: int = 1, name: str = "u"):
    """Conforming Lagrange space (boilerplate/pdelab.hh:581)."""
    return FunctionSpace(mesh, QkFEM(degree, mesh.dim), name=name)


def DGSpace(mesh, degree: int = 1, variant: str = "equidistant", name: str = "u"):
    """DG space; variant in {'equidistant', 'gl', 'lobatto', 'legendre',
    'opb', 'monomial'} (the DG{Qk,QkGL,QkOPB,Legendre}Space analogs,
    boilerplate/pdelab.hh:890)."""
    if variant == "legendre":
        fem = LegendreDGFEM(degree, mesh.dim)
    elif variant == "opb":
        fem = OPBFEM(degree, mesh.dim, geometry=mesh.geometry_type)
    elif variant == "monomial":
        fem = MonomialDGFEM(degree, mesh.dim, geometry=mesh.geometry_type)
    else:
        fem = QkDGFEM(degree, mesh.dim, variant)
    return FunctionSpace(mesh, fem, name=name)


def P0Space(mesh, name: str = "u"):
    return FunctionSpace(mesh, P0FEM(mesh.dim), name=name)


def GalerkinGlobalAssembler(space, lop, constraints=None, quad_order=None):
    """GalerkinGlobalAssembler analog (boilerplate/pdelab.hh:1508)."""
    return GridOperator(space, lop, constraints=constraints, quad_order=quad_order)


def linear_solver_from_config(ptree: ParameterTree | dict | None = None, **kw):
    """A LinearSolverBackend from INI-style keys: [linear_solver]
    type=cg|bicgstab|gmres|minres, preconditioner=..., maxiter=, restart=
    (the ISTL backend selection analog). The reference's verbose= key is
    read and has no effect: the port's backend prints nothing."""
    if isinstance(ptree, dict):
        ptree = ParameterTree(ptree)
    cfg = ptree or ParameterTree()
    cfg.get("verbose", 0, int)
    return LinearSolverBackend(
        solver=cfg.get("type", kw.pop("solver", "cg")),
        precond=cfg.get("preconditioner", kw.pop("precond", "jacobi")),
        maxiter=cfg.get("maxiter", 5000, int),
        restart=cfg.get("restart", 30, int),
        **kw,
    )


@dataclass
class StationaryResultBundle:
    space: Any
    x: Any
    solver: Any
    constraints: Any = None

    @property
    def iterations(self):
        return self.solver.result.linear_solver_iterations

    def vtk(self, path, name="u", binary=None):
        """Write the solution as a .vtu file (io/vtk.py; binary=None takes
        the native binary writer above 65,536 vertices)."""
        from dune_pdelab_tpu_torch.io.vtk import VTKWriter
        return VTKWriter(self.space.mesh).add_field(self.space, self.x, name).write(
            path, binary=binary)


def solve_stationary(space, lop, bctype=None, dirichlet=None, linear_solver=None,
                     reduction=1e-10, nonlinear=False, verbose=0, ptree=None,
                     device=None, dtype=None, **newton_kw):
    """Assemble and solve a (non)linear stationary problem in one call.

    bctype: the constraints specification (True / callable / tuple);
    dirichlet: boundary values (a callable of point tensors) for the
    initial iterate. The solve runs on `device` in `dtype`."""
    device = resolve_device(device)
    dtype = dtype or default_float()
    cg_ = make_constraints(bctype, space, device=device) if bctype is not None else None
    go = GridOperator(space, lop, constraints=cg_)
    ls = linear_solver or linear_solver_from_config(
        ptree.sub("linear_solver") if ptree else None)
    x0 = space.zero(dtype, device)
    if dirichlet is not None and cg_ is not None:
        x0 = interpolate_dirichlet(dirichlet, space, cg_, x0)
    if nonlinear:
        solver = NewtonMethod(go, ls, verbose=verbose, **newton_kw)
        if ptree and "newton.reduction" in ptree:
            solver = NewtonMethod.from_parameters(go, ls, ptree.sub("newton"))
    else:
        solver = StationaryLinearProblemSolver(go, ls, reduction=reduction, verbose=verbose)
    x = solver.apply(x0)
    return StationaryResultBundle(space, x, solver, cg_)


def solve_instationary(space, lop_spatial, lop_temporal=None, bctype=None, x0=None,
                       t0=0.0, dt=None, tend=None, scheme=None, linear_solver=None,
                       pdesolver=None, boundary_values=None,
                       ptree: ParameterTree | None = None, verbose=0, vtk_basename=None,
                       checkpoint_dir=None, device=None, dtype=None, **solver_kw):
    """One-call instationary solve, optionally INI-configured.

    INI keys (ParameterTree):
      [time] scheme=, dt=, tend=, t0=
      [linear_solver] type=, preconditioner=, maxiter=, ...
      [newton] reduction=, max_iterations=
    Writes a VTK time series (.vtu per step and a .pvd) and checkpoints
    (utils/checkpoint.py) when a basename or directory is given. x0
    defaults to zeros of `dtype` on `device`. Returns (t_final, x_final,
    method)."""
    from dune_pdelab_tpu_torch.instationary import SCHEMES, OneStepMethod
    from dune_pdelab_tpu_torch.ops.l2 import L2

    cfg = ptree or ParameterTree()
    tcfg = cfg.sub("time")
    scheme = scheme or tcfg.get("scheme", "implicit_euler")
    if isinstance(scheme, str):
        scheme = SCHEMES[scheme]()
    dt = dt if dt is not None else tcfg.get("dt", 0.1, float)
    tend = tend if tend is not None else tcfg.get("tend", 1.0, float)
    t0 = tcfg.get("t0", t0, float)

    if x0 is not None:
        device = x0.device
    device = resolve_device(device)
    cg_ = make_constraints(bctype, space, device=device) if bctype is not None else None
    go0 = GridOperator(space, lop_spatial, constraints=cg_)
    go1 = GridOperator(space, lop_temporal or L2(), constraints=cg_)
    ls = linear_solver or linear_solver_from_config(cfg.sub("linear_solver"))
    pdesolver = pdesolver or ("newton" if not getattr(lop_spatial, "is_linear", False)
                              else "linear")
    newton_kw = dict(solver_kw)
    if "newton.reduction" in cfg:
        newton_kw.setdefault("reduction", cfg.get("newton.reduction", 1e-8, float))
        newton_kw.setdefault("max_iterations", cfg.get("newton.max_iterations", 20, int))
    osm = OneStepMethod(scheme, go0, go1, ls, pdesolver=pdesolver,
                        boundary_values=boundary_values, verbose=verbose, **newton_kw)
    x = x0 if x0 is not None else space.zero(dtype or default_float(), device)
    seq = None
    if vtk_basename:
        from dune_pdelab_tpu_torch.io.vtk import VTKSequenceWriter
        seq = VTKSequenceWriter(vtk_basename)
        seq.write(space.mesh, t0, [(space, x, "u")])
    mgr = None
    if checkpoint_dir:
        from dune_pdelab_tpu_torch.utils.checkpoint import CheckpointManager
        mgr = CheckpointManager(checkpoint_dir)
    t, step = t0, 0
    while t < tend - 1e-12:
        h = min(dt, tend - t)
        x = osm.apply(t, h, x)
        t += h
        step += 1
        if seq is not None:
            seq.write(space.mesh, t, [(space, x, "u")])
        if mgr is not None:
            mgr.save(step, {"x": x}, {"t": t})
    return t, x, osm


def adaptive_solve(problem_lop_factory, mesh0, fem, bctype=None, dirichlet=None,
                   estimator=None, tol=1e-3, max_levels=5, linear_solver=None,
                   reduction=1e-10, verbose=0, device=None, dtype=None):
    """Estimate -> refine -> re-solve loop (reference: the adaptivity
    loop of dune/pdelab/test/testadaptivity.cc): solve on the current
    space, evaluate the a-posteriori estimator, stop when the global eta
    reaches `tol` or at `max_levels`, else refine uniformly and take the
    transferred solution as the next initial guess.

    problem_lop_factory: () -> (problem, local operator) per level.
    estimator: callable(go, problem, x) -> per-element eta^2 (default: the
    residual convection-diffusion estimator).
    Returns (space, x, [(ndofs, eta) per level])."""
    from dune_pdelab_tpu_torch.adaptivity.adaptivity import (
        adapt_uniform, residual_estimator_convectiondiffusion,
    )

    est = estimator or residual_estimator_convectiondiffusion
    device = resolve_device(device)
    dtype = dtype or default_float()
    mesh = mesh0
    history = []
    x_prev = None
    space = x = None
    for level in range(max_levels):
        problem, lop = problem_lop_factory()
        space = FunctionSpace(mesh, fem)
        cg_ = make_constraints(bctype, space, device=device) if bctype is not None else None
        go = GridOperator(space, lop, constraints=cg_)
        ls = linear_solver or linear_solver_from_config(None)
        x0 = x_prev if x_prev is not None else space.zero(dtype, device)
        if dirichlet is not None and cg_ is not None:
            x0 = interpolate_dirichlet(dirichlet, space, cg_, x0)
        slp = StationaryLinearProblemSolver(go, ls, reduction=reduction,
                                            verbose=max(0, verbose - 1))
        x = slp.apply(x0)
        eta = float(torch.sqrt(torch.sum(est(go, problem, x))))
        history.append((space.ndofs, eta))
        if verbose:
            print(f"adaptive level {level}: ndofs={space.ndofs} eta={eta:.4e}")
        if eta <= tol or level == max_levels - 1:
            break
        space_new, x_prev = adapt_uniform(space, x)
        mesh = space_new.mesh
    return space, x, history
