"""The instationary heat equation with the Crank-Nicolson one-step method
(examples/04_instationary_heat.py; dune-pdelab-tutorials tutorial03,
dune/pdelab/test/testinstationary.cc).

    du/dt - lap u = 0, exact u = exp(-2 pi^2 t) sin(pi x) sin(pi y)

Run: python -m dune_pdelab_tpu_torch.examples.ex04_instationary_heat [--device cpu]
"""
from __future__ import annotations

import math

import numpy as np
import torch

import dune_pdelab_tpu_torch as pt
from dune_pdelab_tpu_torch.examples._common import finish, on_device, parser
from dune_pdelab_tpu_torch.instationary import OneStepMethod, crank_nicolson
from dune_pdelab_tpu_torch.ops import ConvectionDiffusionFEM, ConvectionDiffusionProblem
from dune_pdelab_tpu_torch.ops.l2 import L2
from dune_pdelab_tpu_torch.space.functions import l2_difference

DECAY = 2 * math.pi ** 2


def u_exact(p, t):
    return math.exp(-DECAY * t) * torch.sin(math.pi * p[:, 0]) * torch.sin(math.pi * p[:, 1])


class Heat(ConvectionDiffusionProblem):
    def f(self, x):
        return torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)

    def g(self, x):
        return torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)


def run(cells=32, dt=1e-3, T=0.05, device=None, dtype=torch.float32, out_dir=None):
    """Crank-Nicolson steps of dt to T; returns t, the L2 error, max|u|
    and the exact decay."""
    with on_device(device, dtype) as dev:
        mesh = pt.StructuredMesh([0, 0], [1, 1], (cells, cells))
        V = pt.FunctionSpace(mesh, pt.QkFEM(1, 2))
        cg = pt.constraints(True, V, device=dev)
        go_s = pt.GridOperator(V, ConvectionDiffusionFEM(Heat()), constraints=cg)
        go_t = pt.GridOperator(V, L2(), constraints=cg)
        ls = pt.SEQ_CG_Jacobi()
        osm = OneStepMethod(crank_nicolson(), go_s, go_t, ls,
                            pdesolver="linear", reduction=1e-11)
        x = V.interpolate(lambda p: u_exact(p, 0.0), dtype=dtype, device=dev)
        t, steps = 0.0, 0
        while t < T - 1e-12:
            x = osm.apply(t, dt, x)
            t += dt
            steps += 1
        err = float(l2_difference(V, x, lambda p: u_exact(p, t)))
        umax = float(torch.max(torch.abs(x)))
        exact = float(np.exp(-DECAY * t))
        print(f"t={t:.3f}: L2 error {err:.3e}, max|u| {umax:.4f} (exact {exact:.4f})")
    return {"ndofs": V.ndofs, "t": t, "steps": steps, "l2_error": err, "max_u": umax,
            "exact_max": exact, "solve_report": ls.report()}


def main(argv=None):
    ap = parser(__doc__, "ex04_instationary_heat")
    ap.add_argument("--cells", type=int, default=32)
    a = ap.parse_args(argv)
    return finish(run(a.cells, device=a.device, out_dir=a.out))


if __name__ == "__main__":
    main()
