"""North-star solve: lattice-GMG CG and, with --refine, fp64 defect
correction around it (examples/15_north_star_scaling.py).

Solves -Laplace u = 1 (homogeneous Dirichlet) on an n^3 structured grid,
Q1, through the fast path:

  1. compile the operator to a 27-point stencil (stencil27 on the card),
  2. build the stencil-resident geometric multigrid (LatticeGMG:
     proxy-probed level stencils, separable transfers, Chebyshev
     smoothing; stencil27 on every level above the coarsest),
  3. solve with host-loop preconditioned CG,
  4. with --refine, reach a true fp64 relative defect of 1e-8 by fp64
     residuals and updates around the fp32 solve (refine_solve).

Reference analog: ISTLBackend_SEQ_CG_AMG_SSOR driven by
StationaryLinearProblemSolver (dune/pdelab/backend/istl/
seqistlsolverbackend.hh:983, stationary/linearproblem.hh:182-278).

Run: python -m dune_pdelab_tpu_torch.examples.ex15_north_star_scaling [--cells 64] [--refine]
"""
from __future__ import annotations

import time

import torch

import dune_pdelab_tpu_torch as pt
from dune_pdelab_tpu_torch.assembly.stencil import compile_stencil
from dune_pdelab_tpu_torch.examples._common import finish, on_device, parser, sync
from dune_pdelab_tpu_torch.linalg.gmg_lattice import LatticeGMG
from dune_pdelab_tpu_torch.ops import ConvectionDiffusionFEM, ConvectionDiffusionProblem
from dune_pdelab_tpu_torch.solvers.refinement import refine_solve


class P(ConvectionDiffusionProblem):
    def f(self, x):
        return torch.ones(x.shape[:-1], dtype=x.dtype, device=x.device)


def run(cells=64, refine=False, device=None, dtype=torch.float32, out_dir=None):
    """LatticeGMG-CG to 1e-8 (a warm-up solve, then the timed one) and, with
    `refine`, fp64 refinement to 1e-8; returns iterations, defects, levels
    and seconds."""
    with on_device(device, dtype) as dev:
        print(f"device={dev}, cells={cells}^3")
        p = P()
        mesh = pt.StructuredMesh([0, 0, 0], [1, 1, 1], (cells,) * 3)
        V = pt.FunctionSpace(mesh, pt.QkFEM(1, 3))
        cg_mask = pt.constraints(p.dirichlet_bctype(), V, device=dev)
        lop = ConvectionDiffusionFEM(p)
        go = pt.GridOperator(V, lop, constraints=cg_mask, skip_boundary=True)
        print(f"N = {V.ndofs:,} DOFs")

        b = -go.residual(V.zero(dtype, dev))
        t0 = time.perf_counter()
        # probed in fp64 when the refinement reuses the stencil for its fp64 residuals
        st = compile_stencil(go, dtype=torch.float64 if refine else dtype, device=dev)
        gmg = LatticeGMG(V, lop, fine_stencil=st)
        float(torch.sum(gmg.apply(b)))                 # warm the V-cycle
        setup_s = time.perf_counter() - t0
        print(f"setup: {setup_s:.1f} s ({gmg.nlevels} levels)")

        gmg.solve_host(b, tol=1e-8)                    # warm-up solve
        sync(dev)
        t0 = time.perf_counter()
        x, info = gmg.solve_host(b, tol=1e-8)
        sync(dev)
        solve_s = time.perf_counter() - t0
        rec, true = info["defect"] / info["defect0"], info["true_defect"] / info["defect0"]
        print(f"solve: {info['iterations']} CG iterations in {solve_s:.3f} s "
              f"({V.ndofs / solve_s / 1e6:.1f} M solved DOFs/s), recurrence defect "
              f"{rec:.1e}, TRUE {str(dtype).split('.')[-1]} defect {true:.1e}")
        if not (info["converged"] and bool(torch.isfinite(x).all())):
            raise AssertionError(f"ex15: LatticeGMG-CG failed: {info}")
        out = {"ndofs": V.ndofs, "levels": gmg.nlevels, "iterations": info["iterations"],
               "converged": bool(info["converged"]), "recurrence_rel": float(rec),
               "true_rel": float(true), "setup_s": setup_s, "solve_s": solve_s}
        if refine:
            b64 = -go.residual(V.zero(torch.float64, dev))
            t0 = time.perf_counter()
            x64, stats = refine_solve(
                st, lambda r32: gmg.solve_host(r32, tol=1e-4, maxiter=30)[0], b64, tol=1e-8)
            sync(dev)
            ref_s = time.perf_counter() - t0
            rel64 = float(stats.defect / stats.defect0)
            print(f"fp64 refinement: {stats.outer_iterations} sweeps in {ref_s:.2f} s, "
                  f"TRUE fp64 defect {rel64:.1e}")
            if not (stats.converged and rel64 <= 1e-8):
                raise AssertionError(f"ex15: fp64 refinement failed: {stats}")
            out.update(refine_sweeps=int(stats.outer_iterations), refine_rel=rel64,
                       refine_s=ref_s)
        else:
            print("(pass --refine for the fp64 refinement stage)")
    return out


def main(argv=None):
    ap = parser(__doc__, "ex15_north_star_scaling")
    ap.add_argument("--cells", type=int, default=64)
    ap.add_argument("--refine", action="store_true", help="run the fp64 refinement stage")
    a = ap.parse_args(argv)
    return finish(run(a.cells, a.refine, device=a.device, out_dir=a.out))


if __name__ == "__main__":
    main()
