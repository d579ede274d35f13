"""Porous-media flow: a heterogeneous-permeability Darcy solve (CCFV/TPFA),
the locally conservative RT0 velocity reconstruction, the nonlinear
porous-medium equation by Newton, and VTK output of head, velocity and
log-permeability (examples/09_darcy_porous_media.py; darcyccfv.hh,
darcyfem.hh, permeability_adapter.hh, nonlinearconvectiondiffusionfem.hh).

The RT0 face velocities are the solver's own two-point fluxes (harmonic
means of the cell centers' K), so div v vanishes cell by cell to solver
tolerance even where K jumps between a face and a cell center.

Run: python -m dune_pdelab_tpu_torch.examples.ex09_darcy_porous_media [--device cpu]
"""
from __future__ import annotations

import math
import os

import numpy as np
import torch

import dune_pdelab_tpu_torch as pt
from dune_pdelab_tpu_torch.examples import _kernels
from dune_pdelab_tpu_torch.examples._common import finish, on_device, out_directory, parser
from dune_pdelab_tpu_torch.io import VTKWriter
from dune_pdelab_tpu_torch.ops import (
    BCType, ConvectionDiffusionCCFV, ConvectionDiffusionProblem, DarcyVelocityFromHeadCCFV,
    DarcyVelocityFromHeadFEM, NonlinearConvectionDiffusionFEM,
    NonlinearConvectionDiffusionProblem, permeability_field,
)
from dune_pdelab_tpu_torch.space.functions import l2_difference

PI = math.pi


# -- 1. heterogeneous Darcy: quarter-five-spot with a low-K inclusion -------
class QuarterFiveSpot(ConvectionDiffusionProblem):
    """Flow from the left (head 1) to the right (head 0); K drops by 1e3
    inside a central block. No flow through top and bottom."""

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


def darcy_ccfv(cells, dtype, dev, out_dir):
    p = QuarterFiveSpot()
    mesh = pt.StructuredMesh([0, 0], [1, 1], (cells, cells))
    V = pt.FunctionSpace(mesh, pt.P0FEM(2))
    go = pt.GridOperator(V, ConvectionDiffusionCCFV(p))
    ls = pt.SEQ_CG_Jacobi()
    slp = pt.StationaryLinearProblemSolver(go, ls, reduction=1e-12, verbose=0)
    before = _kernels.snapshot()
    head = slp.apply(V.zero(dtype, dev))
    launches = _kernels.since(before)

    rt0 = DarcyVelocityFromHeadCCFV(mesh, p, head)
    v = rt0.at_centers()
    div = rt0.cell_divergence()
    # local conservation: no sources, so div v = 0 cell by cell
    divmax = float(np.max(np.abs(div)))
    print(f"[darcy] CG {slp.result.linear_solver_iterations} iterations "
          f"({ls.report(go).splitlines()[0]})")
    print(f"[darcy] max |div v| per cell    : {divmax:.3e}")
    # inflow == outflow (global mass balance from the face fluxes)
    vx = rt0.face_normal_velocities()[0]
    h = mesh.h
    inflow = float(np.sum(vx[:, 0]) * h[1])
    outflow = float(np.sum(vx[:, -1]) * h[1])
    print(f"[darcy] inflow {inflow:.6f} vs outflow {outflow:.6f}")
    if not abs(inflow - outflow) < 1e-10 * abs(inflow):
        raise AssertionError(f"ex09: inflow {inflow} against outflow {outflow}")
    if not divmax < 1e-7:                       # solver-tolerance scale
        raise AssertionError(f"ex09: max |div v| {divmax:.3e} per cell")

    w = VTKWriter(mesh)
    w.add_field(V, head, "head")
    w.add_cell_data("velocity", v)
    w.add_cell_data("log10K", permeability_field(mesh, p))
    path = w.write(os.path.join(out_dir, "darcy"))
    print(f"[darcy] wrote {path} (head, velocity, log10K)")
    return {"ndofs": V.ndofs, "iterations": slp.result.linear_solver_iterations,
            "max_div": divmax, "inflow": inflow, "outflow": outflow,
            "faces": rt0.face_normal_velocities(), "head": head.cpu().numpy(),
            "launches": launches, "solve_report": ls.report(go), "vtu": path}


# -- 2. porous-medium equation: -Laplace(u^2) = f via Newton ----------------
class PorousMedium(NonlinearConvectionDiffusionProblem):
    C = 1.2

    def exact(self, p):
        return torch.sin(PI * p[:, 0]) * torch.sin(PI * p[:, 1]) + self.C

    def w(self, x, u):
        return u * u

    def f(self, x, u):
        a = PI
        s0, c0 = torch.sin(a * x[..., 0]), torch.cos(a * x[..., 0])
        s1, c1 = torch.sin(a * x[..., 1]), torch.cos(a * x[..., 1])
        ue = s0 * s1 + self.C
        grad2 = a**2 * (c0**2 * s1**2 + s0**2 * c1**2)
        return -2 * grad2 + 4 * a**2 * ue * (ue - self.C)

    def g(self, x):
        return torch.sin(PI * x[..., 0]) * torch.sin(PI * x[..., 1]) + self.C


def porous_medium(cells, dtype, dev, check):
    p = PorousMedium()
    mesh = pt.StructuredMesh([0, 0], [1, 1], (cells, cells))
    V = pt.FunctionSpace(mesh, pt.QkFEM(1, 2))
    cg = pt.constraints(p.dirichlet_bctype(), V, device=dev)
    go = pt.GridOperator(V, NonlinearConvectionDiffusionFEM(p), constraints=cg)
    xc = V.interpolate(lambda pts: torch.full((pts.shape[0],), p.C, dtype=pts.dtype),
                       dtype=dtype, device=dev)
    x0 = pt.interpolate_dirichlet(p.g, V, cg, xc)
    ls = pt.SEQ_CG_Jacobi()
    newton = pt.NewtonMethod(go, ls, reduction=1e-11, verbose=0)
    x = newton.apply(x0)
    err = float(l2_difference(V, x, p.exact))
    print(f"[pme] Newton {newton.result.iterations} its, L2 error {err:.3e}")
    if not (newton.result.converged and (err < 1e-3 or not check)):
        raise AssertionError(f"ex09: porous-medium Newton failed (L2 {err:.3e})")
    # seepage velocity of the head field through the FEM adapter
    vmax = float(torch.max(torch.abs(DarcyVelocityFromHeadFEM(p, V, x).at_centers())))
    print(f"[pme] max |v| at centers        : {vmax:.3f}")
    return {"ndofs": V.ndofs, "newton_iterations": newton.result.iterations,
            "l2_error": err, "max_v": vmax, "solve_report": ls.report()}


def run(darcy_cells=64, pme_cells=32, check=True, device=None, dtype=torch.float64,
        out_dir=None):
    """The Darcy solve with its conservation checks, then the porous-medium
    Newton solve (with `check`, at the reference's 32^2, its L2 error below
    the reference's 1e-3); returns both parts' numbers under "darcy" and
    "pme"."""
    out_dir = out_directory(out_dir, "ex09")
    with on_device(device, dtype) as dev:
        darcy = darcy_ccfv(darcy_cells, dtype, dev, out_dir)
        pme = porous_medium(pme_cells, dtype, dev, check)
    return {"darcy": darcy, "pme": pme}


def main(argv=None):
    ap = parser(__doc__, "ex09_darcy_porous_media")
    ap.add_argument("--darcy-cells", type=int, default=64)
    ap.add_argument("--pme-cells", type=int, default=32)
    a = ap.parse_args(argv)
    return finish(run(a.darcy_cells, a.pme_cells, device=a.device, out_dir=a.out))


if __name__ == "__main__":
    main()
