"""Explicit hyperbolic solver chain: heterogeneous linear acoustics with
SSP-RK3 DG, CFL-controlled time steps and VTK output
(examples/10_acoustics_explicit_rk.py; linearacousticsdg.hh,
explicitonestep.hh CFLTimeController, instationary/onestepparameter.hh Shu3).

A Gaussian pressure pulse crosses a sound-speed interface (c: 1 -> 2); in
the symmetrized variables the interface is impedance-matched, so the pulse
transmits with amplitude c1/c2 = 0.5 and no spurious reflection, both
checked quantitatively.

Run: python -m dune_pdelab_tpu_torch.examples.ex10_acoustics_explicit_rk [--device cpu]
"""
from __future__ import annotations

import os

import numpy as np
import torch

import dune_pdelab_tpu_torch as pt
from dune_pdelab_tpu_torch.examples._common import finish, on_device, out_directory, parser
from dune_pdelab_tpu_torch.instationary import CFLTimeController, ExplicitOneStepMethod, shu3
from dune_pdelab_tpu_torch.io import VTKWriter
from dune_pdelab_tpu_torch.ops import L2
from dune_pdelab_tpu_torch.ops.acoustics import LinearAcousticsDG
from dune_pdelab_tpu_torch.space.space import PowerSpace


def c(x):
    """Sound speed, jumping at x = 1."""
    return torch.where(x[..., 0] < 1.0, 1.0, 2.0).to(x.dtype)


def pulse(x):
    return torch.exp(-((x - 0.5) / 0.08) ** 2)


def run(nx=96, k=1, T=0.8, check=True, device=None, dtype=torch.float64, out_dir=None):
    """SSP-RK3 to T in chunks of 10 CFL-controlled steps; returns t, the
    steps taken, the reflection residue, the transmitted peak's position
    and amplitude. With `check` (the reference's sizes) the reflection and
    transmission bounds must hold."""
    out_dir = out_directory(out_dir, "ex10")
    with on_device(device, dtype) as dev:
        mesh = pt.StructuredMesh([0, 0], [2, 1], (nx, 2), periodic=(False, True))
        leaf = pt.FunctionSpace(mesh, pt.QkDGFEM(k, 2))
        Q = PowerSpace(leaf, 3)            # (p, u1, u2) symmetrized variables
        go0 = pt.GridOperator(Q, LinearAcousticsDG(c=c, bc="absorb", cmax=2.0))
        go1 = pt.GridOperator(Q, L2())
        osm = ExplicitOneStepMethod(shu3(), go0, go1)

        # +x-moving pulse: p = g, u1 = g (unit impedance in these variables)
        x = Q.interpolate((lambda p: pulse(p[:, 0]), lambda p: pulse(p[:, 0]),
                           lambda p: torch.zeros(p.shape[0], dtype=p.dtype)),
                          dtype=dtype, device=dev)
        # CFL-controlled dt: h_min / (c_max (2k+1)) (explicitonestep.hh:64)
        ctrl = CFLTimeController(0.35, go0)
        t = 0.0
        dt0 = 0.2 / (nx / 2 * (2 * k + 1) * 2.0)
        nsteps = 0
        while t < T - 1e-12:
            dt = min(ctrl.suggest_timestep(t, dt0, x), T - t)
            t, x = osm.solve(t, dt, min(t + 10 * dt, T), x)
            nsteps += 10
        print(f"[acoustics] advanced to t={t:.3f} in ~{nsteps} RK3 steps")

        coords = np.asarray(leaf.dof_coords())
        pv = np.abs(Q.restrict(x, 0).cpu().numpy())
        refl = float(pv[coords[:, 0] < 0.85].max())
        sel = coords[:, 0] > 1.1
        xpk = float(coords[sel][np.argmax(pv[sel]), 0])
        amp = float(pv[sel].max())
        print(f"[acoustics] reflection residue  : {refl:.4f}  (expect < 0.06)")
        print(f"[acoustics] transmitted peak at : x={xpk:.3f} (expect ~1.6)")
        print(f"[acoustics] transmitted amp     : {amp:.3f}  (expect ~0.5)")
        ok = refl < 0.06 and abs(xpk - 1.6) < 0.12 and abs(amp - 0.5) < 0.05

        w = VTKWriter(mesh)
        w.add_field(leaf, Q.restrict(x, 0), "pressure")
        w.add_cell_data("c", c(torch.as_tensor(mesh.element_centers())))
        path = w.write(os.path.join(out_dir, "acoustics_final"))
        print(f"[acoustics] wrote {path}")
    if check and not ok:
        raise AssertionError(f"ex10: reflection {refl}, peak at {xpk}, amplitude {amp}")
    return {"ndofs": Q.ndofs, "t": t, "steps": nsteps, "reflection": refl, "peak_x": xpk,
            "amplitude": amp, "vtu": path}


def main(argv=None):
    ap = parser(__doc__, "ex10_acoustics_explicit_rk")
    ap.add_argument("--nx", type=int, default=96)
    a = ap.parse_args(argv)
    return finish(run(a.nx, device=a.device, out_dir=a.out))


if __name__ == "__main__":
    main()
