"""Two-phase immiscible flow: Brooks-Corey drainage/imbibition on a
heterogeneous reservoir slab with gravity, a liquid injector well, gas
venting through a Dirichlet window, implicit Euler + Newton with
failed-step dt control, per-phase mass balance and the locally
conservative per-phase velocities written to VTK
(examples/13_twophase_flow.py; twophaseccfv.hh).

An all-Neumann two-phase problem has the exact Jacobian null mode
(p_l, p_g) -> (p_l + c, p_g + c), which stalls Krylov solvers: the gas
vent's Dirichlet window anchors the pressure level.

Run: python -m dune_pdelab_tpu_torch.examples.ex13_twophase_flow [--device cpu]
"""
from __future__ import annotations

import os

import numpy as np
import torch

import dune_pdelab_tpu_torch as pt
from dune_pdelab_tpu_torch.examples._common import finish, on_device, out_directory, parser
from dune_pdelab_tpu_torch.instationary import OneStepMethod, implicit_euler
from dune_pdelab_tpu_torch.io import VTKWriter
from dune_pdelab_tpu_torch.ops import (
    BrooksCoreyParameters, TwoPhaseCCFV, TwoPhaseStorage, TwoPhaseVelocity,
)
from dune_pdelab_tpu_torch.space.space import PowerSpace


class Reservoir(BrooksCoreyParameters):
    """Layered permeability, liquid injected by a well at the bottom left,
    gas vented through a window on the top face; gravity pulls the denser
    liquid down."""

    def __init__(self):
        super().__init__(pe=1.0, lam=2.0, s_lr=0.05, s_gr=0.05,
                         phi=0.2, mu_l=1.0, mu_g=0.2, rho_l=2.0, rho_g=1.0,
                         K=lambda x: torch.where(x[..., 1] > 0.5, 0.3, 1.0).to(x.dtype),
                         gravity=(0.0, -0.5))

    def q_l(self, x):   # injector well in the bottom-left cell block
        return torch.where((x[..., 0] < 0.15) & (x[..., 1] < 0.15), 0.4, 0.0).to(x.dtype)

    def _vent(self, x):
        return (x[..., 1] > 1 - 1e-9) & (x[..., 0] > 0.6)

    def bc_g(self, x):  # gas vents through a Dirichlet window on the top
        return torch.where(self._vent(x), 1, 0)

    def g_g(self, x):
        return torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)


def run(cells=16, tend=0.03, dt=2e-3, device=None, dtype=torch.float64, out_dir=None):
    """Implicit Euler to tend; returns t, failed steps, Newton iterations,
    the liquid mass gain against the injected mass, the gas mass change and
    the saturation range."""
    out_dir = out_directory(out_dir, "ex13")
    with on_device(device, dtype) as dev:
        n = cells
        mesh = pt.StructuredMesh([0, 0], [1, 1], (n, n))
        W = PowerSpace(pt.FunctionSpace(mesh, pt.P0FEM(2)), 2)     # (p_l, p_g)
        prm = Reservoir()
        go0 = pt.GridOperator(W, TwoPhaseCCFV(prm))
        go1 = pt.GridOperator(W, TwoPhaseStorage(prm))
        ls = pt.SEQ_BCGS_Jacobi()
        osm = OneStepMethod(implicit_euler(), go0, go1, ls,
                            pdesolver="newton", reduction=1e-7, max_iterations=50,
                            min_linear_reduction=1e-4, line_search_accept_best=True,
                            verbose=0)
        E = mesh.nelements
        # initial: moderately drained, pc = 1.3 -> S_e = 1.3^-2 ~ 0.59
        x = torch.cat([torch.zeros(E, dtype=dtype, device=dev),
                       torch.full((E,), 1.3, dtype=dtype, device=dev)])

        def masses(xv):
            m = go1.residual_unconstrained(xv).cpu().numpy()
            return float(m[:E].sum()), float(m[E:].sum())

        ml0, mg0 = masses(x)
        t, x = osm.solve(0.0, dt, tend, x, max_step_retries=6)
        ml1, mg1 = masses(x)

        # liquid only enters through the well (no-flow boundary), so its
        # gain is q_l vol t exactly; gas leaves through the vent. The well
        # block is the cells whose centers lie below 0.15 (2x2 at 16^2).
        m = int(np.sum((np.arange(n) + 0.5) / n < 0.15))
        inj = 0.4 * (m / n) * (m / n) * t
        print(f"t = {t:.3f}, failed steps = {osm.result.failed_steps}")
        print(f"liquid mass gain {ml1 - ml0:.6f}  (injected {inj:.6f})")
        print(f"gas    mass change {mg1 - mg0:.6f}  (vented through Dirichlet)")
        if not abs((ml1 - ml0) - inj) < 1e-6 * max(inj, 1e-12):
            raise AssertionError(f"ex13: liquid mass gain {ml1 - ml0} against {inj}")

        pl = W.restrict(x, 0).cpu().numpy()
        pg = W.restrict(x, 1).cpu().numpy()
        s_l = prm.s_l(torch.as_tensor(pg - pl)).numpy()
        print(f"saturation range: [{s_l.min():.3f}, {s_l.max():.3f}]")

        # per-phase mass velocities (the V_l/V_g analog)
        vc = TwoPhaseVelocity(mesh, prm, W, x, phase="liquid").at_centers()
        gc = TwoPhaseVelocity(mesh, prm, W, x, phase="gas").at_centers()
        w = VTKWriter(mesh)
        for name, a in (("p_l", pl), ("p_g", pg), ("s_l", s_l), ("v_l_x", vc[:, 0]),
                        ("v_l_y", vc[:, 1]), ("v_g_x", gc[:, 0]), ("v_g_y", gc[:, 1])):
            w.add_cell_data(name, a)
        path = w.write(os.path.join(out_dir, "twophase_flow"))
        print(f"wrote {path}")
    return {"ndofs": W.ndofs, "t": t, "failed_steps": osm.result.failed_steps,
            "newton_iterations": osm.result.total_newton_iterations,
            "liquid_gain": ml1 - ml0, "injected": inj, "gas_change": mg1 - mg0,
            "s_min": float(s_l.min()), "s_max": float(s_l.max()), "x": x.cpu().numpy(),
            "solve_report": ls.report(),
            "vtu": path}


def main(argv=None):
    ap = parser(__doc__, "ex13_twophase_flow")
    ap.add_argument("--cells", type=int, default=16)
    a = ap.parse_args(argv)
    return finish(run(a.cells, device=a.device, out_dir=a.out))


if __name__ == "__main__":
    main()
