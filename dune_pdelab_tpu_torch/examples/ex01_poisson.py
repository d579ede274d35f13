"""Poisson with Dirichlet and Neumann boundary conditions, Q2, CG + Jacobi,
VTK output (examples/01_poisson.py; dune-pdelab-tutorials tutorial00/01,
dune/pdelab/test/testpoisson.cc).

    -div(grad u) = f   in (0,1)^2
               u = g   on the Dirichlet boundary (x = 0, x = 1)
    -grad u . n  = j   on the Neumann boundary   (y = 0, y = 1)

Run: python -m dune_pdelab_tpu_torch.examples.ex01_poisson [--device cpu] [--out DIR]
"""
from __future__ import annotations

import math
import os

import numpy as np
import torch

import dune_pdelab_tpu_torch as pt
from dune_pdelab_tpu_torch.examples._common import finish, on_device, out_directory, parser
from dune_pdelab_tpu_torch.io import VTKWriter
from dune_pdelab_tpu_torch.ops import ConvectionDiffusionFEM, ConvectionDiffusionProblem
from dune_pdelab_tpu_torch.space.functions import l2_difference

PI = math.pi


class Problem(ConvectionDiffusionProblem):
    """Manufactured solution u = sin(pi x) cos(pi y) + x."""

    def exact(self, p):
        return torch.sin(PI * p[:, 0]) * torch.cos(PI * p[:, 1]) + p[:, 0]

    def f(self, x):
        return 2 * PI**2 * torch.sin(PI * x[..., 0]) * torch.cos(PI * x[..., 1])

    def g(self, x):
        return torch.sin(PI * x[..., 0]) * torch.cos(PI * x[..., 1]) + x[..., 0]

    def dirichlet_bctype(self):
        return lambda p: np.isclose(p[:, 0], 0.0) | np.isclose(p[:, 0], 1.0)

    def j(self, x):
        # du/dy = -pi sin(pi x) sin(pi y) vanishes on y = 0 and y = 1
        return torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)


def run(cells=64, reduction=1e-10, device=None, dtype=torch.float32, out_dir=None):
    """Solve, measure the L2 error, write poisson.vtu; returns ndofs,
    iterations, l2_error and the .vtu path."""
    out_dir = out_directory(out_dir, "ex01")
    with on_device(device, dtype) as dev:
        prob = Problem()
        mesh = pt.StructuredMesh([0, 0], [1, 1], (cells, cells))
        V = pt.FunctionSpace(mesh, pt.QkFEM(2, 2))
        cg = pt.constraints(prob.dirichlet_bctype(), V, device=dev)
        go = pt.GridOperator(V, ConvectionDiffusionFEM(prob), constraints=cg)
        x0 = pt.interpolate_dirichlet(prob.g, V, cg, V.zero(dtype, dev))
        ls = pt.SEQ_CG_Jacobi()
        slp = pt.StationaryLinearProblemSolver(go, ls, reduction=reduction, verbose=0)
        x = slp.apply(x0)
        err = float(l2_difference(V, x, prob.exact))
        print(f"ndofs={V.ndofs}  L2 error={err:.3e}  "
              f"({slp.result.linear_solver_iterations} CG iterations)")
        path = VTKWriter(mesh).add_field(V, x, "u").write(os.path.join(out_dir, "poisson"))
        print(f"wrote {path}")
    return {"ndofs": V.ndofs, "iterations": slp.result.linear_solver_iterations,
            "converged": bool(slp.result.converged), "l2_error": err,
            "solve_report": ls.report(go), "vtu": path}


def main(argv=None):
    ap = parser(__doc__, "ex01_poisson")
    ap.add_argument("--cells", type=int, default=64)
    a = ap.parse_args(argv)
    return finish(run(a.cells, device=a.device, out_dir=a.out))


if __name__ == "__main__":
    main()
