#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (dune_pdelab_tpu_torch) on one H100.

Run from the repository root on a machine with a Hopper card:

    python3 chip_smoke.py

Phases (each passes or raises; there is no CPU path):
  1. build the hand-written CUDA kernels from dune_pdelab_tpu_torch/csrc;
  2. each kernel against its plain PyTorch version on the card, with kernel
     and plain times: stencil27 and the fused-CG pair at 128^3, at an
     unaligned (67, 45, 33) grid (fp32 and fp64) and at the main path's
     512^3 grid (fp32); stencil27 in fp32 and fp64 at every LatticeGMG
     level shape phase 5a launches it on (513^3 down to 9^3), 3^3 and
     67x45x33, timed in fp32; structured_fused (fp32) at 512^3 cells and
     at a ragged 66x44x32 cells, and (fp32, fp64) at one cell (2x2x2
     nodes), residual and Jacobian-apply modes, for a field-A problem and a
     tensor-A + b + c + f problem (and fp64 at the ragged size), and at the
     ragged size on a q = 3 rule (fp32 field-A J.v, fp64 tensor residual);
     both kernels launched twice on one input give bit-equal results;
  3. the main path at full size: 3D Poisson Q1, 511 cells per axis
     (N = 134,217,728 DOFs), fp32: mesh -> space -> constraints ->
     GridOperator -> slabbed RHS -> compile_stencil (proxy branch) ->
     make_fused_cg for 50 iterations, checked against the true residual and
     against a plain CG on the same operator;
  4. the README entry point, StationaryLinearProblemSolver + SEQ_CG_Jacobi at
     127 cells, in fp32 and fp64 (fp64 checked against a plain CG);
  5. the multigrid routes: (a) LatticeGMG-CG solve_host at 512^3 cells,
     fp32, tol 1e-8 (bench.py:641-714); (b) fp64 defect correction around
     it to a true relative defect of 1e-8 (bench.py:478-560); (c)
     VarCoeffGMG on the fused structured operator at 256^3 and 512^3
     cells (bench.py:562-639); (d) the config13_scale_lattice_gmg golden at
     128^3 in fp64 (models/configs.py:525-562, without its sharded check),
     held against tests/golden_parity.json;
  6. the assembled lattice-ELL path (bench.py:717-832) on the
     variable-coefficient problem at 255^3 cells (N = 16,777,216), fp32:
     (a) general and fused (K3) residual rates, and the fused residual and
     J.v against the general ones at a random x; (b) assemble_ell_direct
     twice and with check=True, and direct against probed values at 63^3
     cells; (c) ell27 against its plain version (fp32 at 256^3 DOFs, fp64
     at a ragged 67x45x33 lattice, random values and z) with the cuSPARSE
     CSR matvec as yardstick; (d) Jacobi-CG on the assembled ELL
     (matrix_free=False) at 255^3, and its iteration count and solution
     against the general-jvp tier at 63^3; (e) the config9_assembled_ilu
     golden in fp64 and SEQ_CG_ILU0 at 127^3 cells next to Jacobi-CG;
  7. the DG path (bench.py:835-975), Q1/Q2 DG SIPG on the unit cube or
     square: (a) block_stencil_mm and block_stencil_em against their plain
     versions on SIPG weights (128^3 Q1 fp32 both layouts, 64^3 Q1 fp32
     mode-major, 20x16x12 Q1, 37x29x23 Q2 and 10x8x6 Q3 fp64 both layouts,
     2048^2 Q2 fp32, the 32^2 config3/config7 shapes and 40x24 Q3 fp64
     element-major), a repeated launch bit-equal, timed (below 10^7 DOFs
     also from a CUDA graph) against their bound, plain version and a
     TF32-off convolution; and both layouts on random weights at nb = 343 (Q6 in 3D) in fp64, whose
     weights the shared path stages in two parts, and a z view off 16-byte
     alignment refused; (b) bench.py's _dg_half at 128^3 cells:
     compile_block_stencil (proxy branch) and the mode-major apply, held
     against go.jacobian_apply; (c) _dgmg_half at 64^3 and 128^3 cells:
     DGTwoLevel on the mode-major stencil inside a host PCG loop, with the
     launches per iteration counted; (d) the config3 and config7 goldens in
     fp64 (element-major kernel, 2D), with their element-major launches;
  8. geometric multigrid on re-discretised levels (models/configs.py:66):
     (a) CG + GeometricMultigrid (Jacobi smoother) on 3D Poisson Q2, fp32,
     tol 1e-8, at 32^3 and 64^3 cells (N = 2,146,689, 6 levels), the
     iteration count held flat, at 64^3 with the share of the solve spent
     in jacobian_apply (every level apply is the general torch.func.jvp,
     as in the reference; no hand kernel); (b) the config2_poisson_3d_gmg
     golden at 16^3 in fp64; (c) DGTwoLevel with gmg_kwargs (the
     GeometricMultigrid coarse solve) against its default LatticeGMG path
     on 2D Q1 SIPG (its block stencil is the element-major kernel);
  9. Newton and one-step time stepping (models/configs.py:113): (a) 3D Q1
     heat at 128^3 cells, fp64, Crank-Nicolson + Newton with Jacobi-CG on
     the lattice ELL assembled at every Newton step (the ell27 kernel in
     each Krylov apply), per-step Newton/CG counts, wall and assembly
     share, the L2 error at t = 0.2, at most 2 Newton iterations a step;
     (b) the config4_heat_theta_newton golden in fp64; (c) Newton on
     -lap u + u^3 = f (examples/03) in 3D Q1 at 128^3, fp64, on the
     assembled ELL (4 Newton iterations), and the nonlinear
     assemble_ell_direct against colored probing at 63^3. In (a) and (c)
     ell27 is held against its plain version on the first ELL the solve
     assembled (129^3 fp64, the stage or Newton operator's values and
     Dirichlet mask) with a random z;
 10. composite spaces and Taylor-Hood (Navier-)Stokes (no hand kernel: the
     Q2 velocity V-cycles run the plain k > 1 stencil form, the other
     applies the general torch.func.jvp): (a) the 3D Taylor-Hood problem of
     tests/test_stokes3d.py (unpinned pressure, triangular StokesGMGSchur,
     GMRES(100)) in fp32 to 1e-6 at 32^3 and 64^3 cells (N = 6,714,692),
     and at 64^3 in fp64: iterations held to a plateau, the fp64 true
     residual, the velocity L2 error falling, peak memory, and at 64^3 the
     solve's split between the
     Taylor-Hood jacobian_apply, the velocity V-cycles and the
     pressure-mass Chebyshev, with one of each (and one fine Q2 stencil
     apply) against its device time; (b) the config5 and config10 goldens
     in fp64, and a Taylor-Hood residual on an interleaved velocity
     (IndexDofMap) twice bit-equal and equal to the lexicographic one; (c)
     Cahouet-Chabard instationary Stokes at 256^2 in fp64, at most 80 GMRES
     iterations a step; (d) the Newton lid-driven cavity at 64^2 and
     DGNavierStokes at 8^2 (block-Jacobi GMRES), fp64.
 11. the algebraic solvers (no hand kernel of their own: the AMG cycle is
     plain-torch padded-ELL SpMVs, its setup host scipy): (a) the
     config12_simplex_amg golden at 32^2 in fp64; (b) AMG-CG on 2D simplex
     P1 Poisson at 256^2, 512^2 and 1024^2 cells in fp64 to 1e-10
     (iterations bounded and flat, L2 error falling as h^2) and at 1024^2
     in fp32 to 1e-6, each with its setup split, levels, operator
     complexity, ms per iteration, one V-cycle's wall against its device
     time and launches, true defect and peak memory; (c) the same on 3D P1
     tetrahedra at 64^3 hexes (N = 274,625); (d) SEQ_CG_AMG on phase 4's
     README problem at 127^3 in fp32 (the Krylov operator on stencil27);
     (e) DGTwoLevel(coarse="amg") on phase 7c's 64^3 Q1 SIPG problem (the
     smoother on blockstencil_mm); (f) SEQ_SuperLU on 2D Q2 at 128^2,
     lobpcg for the 4 smallest Dirichlet-Laplacian eigenpairs at 128^2 and
     GenEO (method="ilu", boxes (4, 4)) at 128^2 on the card and the CPU.
 12. adaptivity and mesh breadth, fp64 (no hand kernel applies: K1-K6
     decline simplex, periodic, mapped and hanging-node operators; every
     apply is the general torch.func.jvp, the mesh work host numpy): (a)
     the config6_adaptive_lshape golden (models/configs.py:206-265); (b)
     the config6 problem at full size: uniform L-shapes cut from 256^2,
     512^2 and 1024^2 squares (N = 788,481) and the adaptive loop from the
     64^2 L-shape (p1_edge_jump_indicator -> Doerfler 0.5 ->
     adapt_local_simplex, SEQ_CG_AMG with Chebyshev smoothing to 1e-10)
     until N >= 5e4 or 25 cycles, with the per-cycle split of host and
     device seconds, held to: N rising, L2 falling, <= 25 iterations, true
     defect <= 1e-9, slope of log L2 on log N (N >= 1e4) below -0.75, an
     iterate below the uniform 1024^2 error at no more DOFs, a conforming
     final mesh; (c) 3D Traxler bisection on the Fichera problem: uniform
     16^3 and 32^3 Kuhn meshes and the adaptive loop to N >= 5e4 beating
     the uniform 32^3 error at no more DOFs; (d) the hanging-node
     AdaptiveMesh Q1 loop (volume_residual_indicator, Doerfler 0.7,
     Jacobi-CG) to N >= 2.5e4 against a uniform 256^2 run, and
     jacobian_apply against the assembled
     P^T J P; (e) periodic 3D Poisson at 32^3/64^3 (L2 ratio 3-5), the
     fully periodic heat run at 256^2, and the stencil, ELL and K3 tiers'
     declines; (f) curved Dirichlet, Neumann-arc and periodic full-annulus
     Poisson at 256^2/512^2 and curved SIPG at 128^2/256^2 (L2 ratios 3-5),
     the identity map against the uniform operator; (g) SIPG PkDGFEM(1, 2)
     on triangles at 128^2/256^2 with DGTwoLevel (AMG coarse), iterations
     flat, and at 32^2 the residual, J.v, dg_jump_indicator,
     MinmodSlopeLimiter and dwr_indicators on the card against the CPU,
     the face-group residual twice bit-equal.
 13. slice 13a, fp64 unless stated: (k) block_stencil_em/_mm against their
     plain versions at every new block size, fp32 and fp64, repeats
     bit-equal, timed against the bound and a convolution (nb = 1: CCFV at
     1024^2 and 128^3; nb = 6: SIPG on MonomialDGFEM/OPBFEM k = 2 at 256^2;
     nb = 9: LegendreDGFEM; nb = 4: MonomialDGFEM k = 1 at 32^3; not
     counted); (a) the config11 golden (34 Newton iterations, 2 failed
     steps, 96 DOFs, the saturations to 1e-8); (b) config11's problem at
     256x64 cells for 4 steps (rows equal, s_l in [0, 1], the share in
     jacobian_apply), the wells problem at 128^2 (mass balance to 1e-6) and
     config11's first three steps at 48x4 on the card against the CPU; (c)
     CCFV diffusion at 512^2/1024^2 (K6, nb = 1) and 64^3/128^3 (K5),
     order > 1.7, the upwind transport (BiCGStab at 128^2 held to its
     bounds; at 512^2 BiCGStab breaks down in both packages and SuperLU's
     solution is held), the Darcy reconstruction's per-cell conservation;
     (d) SIPG on MonomialDGFEM/OPBFEM (nb = 6) and LegendreDGFEM (nb = 9)
     at 128^2/256^2 (order > 2.5), MonomialDGFEM(1, 3) at 32^3 (K5, nb = 4),
     variable order at 64^2 against the truncated space; (e) Q2 elasticity
     at 128^2/256^2 (order > 2.7); (f) LinearAcousticsDG at 256^2 Q2 and
     MaxwellDG at 32^3 Q1, 50 shu3 steps, and at 8^2 / 8x8x2 against the
     CPU to 1e-12; (g) L2 projections onto every new element, a config11
     restart through CheckpointManager bit-equal, a numpy-written
     checkpoint loaded onto the card.
 14. slices 13b and 13c, fp64 unless stated (no hand kernel: K1-K6 decline
     H(div), H(curl) and mimetic leaves and report() names each declined
     tier; every Krylov apply is the general torch.func.jvp replayed from a
     CUDA graph): (a) DiffusionMixed with unpreconditioned MINRES on
     squares: RT0/P0 at 128^2/256^2 (cell-centre order > 1.5, max |r_p| <
     1e-9), RT1/Q1DG at 32^2/64^2 and RT2/Q2DG at 16^2/32^2 (L2 orders > 1.6
     and 2.5), BDM1/P0 at 128^2; (b) RT0 and BDM1 triangles at 64^2/128^2 x
     2, RT1/P1DG triangles at 32^2/64^2, RT0 tets at 16^3 x 6, RT1 hexahedra
     at 8^3/16^3 and RT0 on the quarter annulus at 64^2/128^2 (the mapped
     Piola and Nanson boundary term, orders > 1.85); (c) curl-curl on
     N0Cube(2) at 128^2/256^2 against the exact edge circulations, the
     discrete de Rham check on N0Cube(3) at 32^3, Whitney tets at 8^3/16^3
     x 6, the Maxwell cavity at 32^2 (A and M by go.jacobian on the card, a
     dense generalised eigensolve: {1, 1, 2, 4, 4} pi^2, a 31^2 kernel); (d)
     DiffusionMFD at 256^2/512^2 (order > 1.8), the 7 x 5 patch test and the
     3D operator at 32^3 (symmetric, Jacobi-CG converges); (e) adjoint
     gradients: the linear Poisson problem of tests/test_differentiable.py
     at 256^2 against directional FD and at 10^2 against the CPU, the
     Crank-Nicolson rollout at 128^2 for 20 steps against central FD and
     checkpointed, the Stokes viscosity gradient at 5^2 against FD, with
     forward and backward seconds and adjoint Krylov iterations; (f)
     residual and J.v of every new operator at 8^2 / 4^3 on the card against
     the CPU (1e-12) and in fp32 against fp64 (1e-5).
 15. slice 12, parallel/ with one process per rank on the card
     (dune_pdelab_tpu_torch.parallel.launch): (a) the DOF-sharded stencil
     apply (stencil27 on each rank's halo-extended block; a 1D rank mesh and
     (2, 2)) against the sequential apply and ShardedLatticeGMG-CG at 256^3
     cells in fp32 (the sequential LatticeGMG-CG's iterations on one NCCL
     rank, within 1 on four gloo ranks sharing the card, the true defect);
     (b) the config8 golden on eight ranks and a 256^2 SIPG residual and J.v
     on four ranks against the one-rank operator (fp64); (c) ShardedAMG-CG
     on phase 11b's simplex P1 problem at 1024^2 on four ranks against one
     (fp64): the coupled setup (the one-rank hierarchy: iterations within
     1 of one rank's) and the default one (a partition per rank: converged,
     the true defect). Each sub-phase logs its wall seconds, rank 0's seconds and bytes
     of communication and the ranks' stencil27 launches, which the ranks
     count in their own processes and this process adds to its count.
 16. slice 13d, io, models and selective assembly: (a)
     models.solve_stationary on phase 4's README problem at 127^3 in fp32
     on the stencil tier (stencil27; phase 4's 149 Jacobi-CG iterations),
     StationaryResultBundle.vtk through the native binary writer (2,097,152
     vertices; the decoded payload equals the host copy bit for bit; write
     seconds and MB/s), the ASCII .vtu of a 32^3 solution written from the
     card equal to the one the CPU port writes from its host copy, and a
     ParallelVTKWriter over four parts of parallel/'s load balancing that
     covers every cell once; (b) a tetrahedral MSH 2 file written here,
     read by the native and the Python parser (equal arrays and tags, the
     seconds of each) and solved by P1 SEQ_CG_AMG (iterations, L2 error);
     (c) read_dgf on a 512^2 Interval block: the Q1 solve equals the
     StructuredGrid one bit for bit; (d) selective assembly in fp64: the
     complementary skip_entity operators' residual and J.v sum to the full
     operator's at 512^2 Q1, the skip_intersection partition identity at
     256^2 SIPG (1e-12 of the largest entry), the card against the CPU at
     16^2 (1e-12), and K3 declining a 64^3 selective operator; (e)
     solve_instationary from tests/test_boilerplate_config.py's INI at
     256^2 with its .pvd and checkpoints written from the card: t = 0.2,
     the latest checkpoint step 8, the L2 error below that test's 0.01.
 17. the fifteen example scripts (dune_pdelab_tpu_torch/examples/, one per
     script of examples/), each run() on the card at its reference script's
     size and dtype and held to that script's checks: ex01-ex06 and ex15
     (fp32; ex15 with its fp64 refinement; ex02's SIPG solves on the
     element-major block stencil, order in [1.8, 2.2]), ex09 (the Darcy
     reconstruction's max |div v| < 1e-7 and inflow = outflow), ex10
     (reflection and transmission bounds), ex11 (misfit down 1e6, theta to
     1e-6), ex12 (last effectivity in [0.9, 1.1]), ex13 (liquid mass
     balance), and on 8 gloo ranks ex14 (ShardedAMG-CG equal to the
     sequential iterations, solutions within 1e-12), ex07 (the sharded
     Jacobi-CG equal to the sequential one) and ex08 (window-sharded
     Taylor-Hood GMRES, the velocity error bound); then ex01 as a user runs
     it, in a subprocess, exiting 0 with "OK". Nine examples (ex02 and
     ex15 among them) run in this process; the others in four helper
     processes started beside them (ex05; ex09 + ex13; ex14 + ex07 on an
     8-rank pool; ex08 on another), whose launches are added to this
     process's counts. Each example's seconds and launches are logged.

The goldens of phases 5d, 6e, 7d, 8b, 9b, 10b, 11a, 12a, 13a and 15b run
through the port's own configurations, dune_pdelab_tpu_torch.models.ALL_CONFIGS
(config5's mass_cheby=0 variant through its recipe with that setting).

Phases 1-7 run in this process, one after another. Then phases 10-14 and
16, host-bound loops that leave the card mostly idle, run in three lane
processes (13 + 16, 10 + 14, 12 + 11, each lane its phases in turn)
beside phases 8, 9 and 15 in this process; phase 17 starts when every lane
is done. The times logged for phases 8-16 are those of phases sharing the
host's cores and the card.

Launch counts are set to 0 before each of phases 3 to 17 and read after
it, in the process that drives it (a lane reports its phases' counts to
this process); a kernel of that path that was never launched fails the run (the
comparison launches of phases 6a, 6c, 7a, 9a, 9c, 13k and 15a are not
counted). Prints phase results and times, the card's name and power limit,
one JSON line {"kernels": [...]} with each kernel's launches over phases
3-17, error, times and bound, and as its last line {"ok": true, "device":
{...}}.
"""
from __future__ import annotations

import json
import math
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
MAIN_CELLS = 511      # cells per axis of the main path: N = 512^3 DOFs
MAIN_ITERS = 50       # fused-CG iterations at tol = 0
README_CELLS = 127    # README entry point: 2,097,152 DOFs
MG_CELLS = 512        # multigrid routes: cells per axis (even, so it coarsens)
VAR_CELLS = (256, 512)
FUSED_CELLS = [(512, 512, 512), (66, 44, 32), (1, 1, 1)]   # structured_fused checks
# the lattices phase 5a's LatticeGMG runs stencil27 on (every level above
# its coarsest, which is a dense LU); phase 2 holds the kernel there
MG_LEVEL_DIMS = [(n,) * 3 for n in (513, 257, 129, 65, 33, 17, 9)]
C13_CELLS = 128       # config13 golden
ASM_CELLS = 255       # assembled path (bench.py:734): N = 256^3 DOFs
ASM_SMALL = 63        # direct-vs-probed and iteration-parity checks
ILU_CELLS = 127       # SEQ_CG_ILU0 on the assembled-path problem
C9_CELLS = 12         # config9 golden
DG_CELLS = 128        # _dg_half (bench.py:835): N = 16,777,216 DG DOFs
DGMG_CELLS = (64, 128)   # _dgmg_half (bench.py:899)
# phase 7a: (cells, Q degree, dtype name, layouts, layout recorded in the
# kernels JSON line or None): every shape phase 7 launches the kernels at
# (7b/7c at 64^3 and 128^3, config3/config7 at 32^2), the 2048^2 Q2 main
# shape of the element-major layout, Q1 in 3D in fp64 (the parameter path
# in both layouts), Q2 in 3D (nb = 27, shared path), Q3 in 2D (nb = 16) and
# Q3 in 3D (nb = 64: the run-time-nb shared path)
DG_KERNEL_CASES = [((DG_CELLS,) * 3, 1, "float32", ("mm", "em"), "mm"),
                   ((DGMG_CELLS[0],) * 3, 1, "float32", ("mm",), None),
                   ((20, 16, 12), 1, "float64", ("mm", "em"), None),
                   ((37, 29, 23), 2, "float64", ("mm", "em"), None),
                   ((2048, 2048), 2, "float32", ("em",), "em"),
                   ((32, 32), 2, "float64", ("em",), None),
                   ((32, 32), 1, "float64", ("em",), None),
                   ((40, 24), 3, "float64", ("em",), None),
                   ((10, 8, 6), 3, "float64", ("mm", "em"), None)]
# the block stencil against its plain version: max abs error over max|y|
BLOCK_TOL = {"float32": 1e-6, "float64": 1e-13}
# phase 7a on random weights: an nb whose weights the shared path stages in
# more than one part (Q6 in 3D: 13*343 rows of 8 fp64 values > 227 KB)
BIG_NB_CASE = ((6, 5, 4), 343, "float64")
# the config3 golden's BiCGStab step count is set by rounding (it stalls
# near the 1e-10 target; tests/test_torch_dg.py CONFIG3_STEPS_BAND), so it
# is held to a band, its L2 error to CONFIG3_L2_BAND of the golden, and the
# L2 error solved to 1e-13 to the JAX package's on the CPU (fp64,
# models/configs.py config3_convdiff_sipg(reduction=1e-13)).
CONFIG3_STEPS_BAND = 20
CONFIG3_L2_BAND = 2e-5
CONFIG3_L2_TIGHT = 1.5662241489950314e-05
# config7: the JAX package's CG steps today (6; the golden's 7 predates its
# face-parity smoother, tests/test_torch_dgmg.py test_config7_golden)
CONFIG7_STEPS = 6
GMG_CELLS = (32, 64)   # phase 8a: 3D Q2 CG + GeometricMultigrid (64^3: N = 2,146,689)
C2_CELLS = 16          # phase 8b: the config2 golden
DGGMG_CELLS = 32       # phase 8c: DGTwoLevel(gmg_kwargs) on 2D Q1 SIPG
HEAT_CELLS = 128       # phase 9a: 3D Q1 heat, N = 2,146,689
HEAT_L2_MAX = 4e-5     # phase 9a: L2 error at the end (CN, dt = 0.02; 1.91e-5 measured at t = 0.2)
HEAT_STEPS = 5         # phase 9a: steps of 0.02 (few: the command's time limit)
HEAT_NEWTON_MAX = 2    # phase 9a: Newton iterations per step (a linear problem)
NL_CELLS = 128         # phase 9c: -lap u + u^3 = f, 3D Q1
NL_L2_MAX = 4.2e-5     # phase 9c: L2 error of the Newton solution (2.09e-5 measured)
NL_NEWTON = 4          # phase 9c: Newton iterations (quadratic from the first step)
NL_SMALL = 63          # phase 9c: nonlinear direct ELL against probing
STOKES_CELLS = (32, 64)   # phase 10a: 3D Taylor-Hood, N = 859,812 / 6,714,692
STOKES_PLATEAU = 12       # phase 10a: its[64^3] <= its[32^3] + 12 (tests/test_stokes3d.py:116)
# phase 10a: the fp64 true relative residual of the fp32 solve at 32^3; it is
# fp32's floor and grows as h^-2 (2.40e-6, 7.16e-6 at 8^3, 16^3 on the CPU,
# 2.755e-5, 1.100e-4 at 32^3, 64^3 on an H100, PERF.md), so a size n^3 is held
# to STOKES_TRUE_REL * max(1, (n / 32)^2); the fp64 solve at the largest size
# to STOKES_TRUE_REL64
STOKES_TRUE_REL = 1e-4
STOKES_TRUE_REL64 = 1e-5
# phase 10a: fp32's recomputed preconditioned defect reduction (GMRES to 1e-6;
# 1.490e-6 / 1.914e-6 measured at 32^3 / 64^3 on an H100, PERF.md)
STOKES_PREC_RED32 = 3e-6
JAX_CONFIG5_ITS = 32      # phase 10b: config5 on the JAX package today (the golden's 42
#                           predates its mass Chebyshev: mass_cheby=0 reproduces it)
CC_CELLS = 256            # phase 10c: Cahouet-Chabard instationary Stokes, 2D, fp64
CC_ITS_MAX = 80           # phase 10c: GMRES iterations per step (tests/test_stokes3d.py:185)
CC_L2_MAX = 5e-4          # phase 10c: velocity L2 error at T (tests/test_stokes3d.py:184)
CC_T = 0.04               # phase 10c: T, 2 steps of 0.02 (the command's time limit)
CAVITY_CELLS = 64         # phase 10d: Newton lid-driven cavity, StokesGMGSchur GMRES
DGNS_CELLS = 32           # phase 10d: DGNavierStokes Q2dg/Q1dg, N = 22,528
DGNS_APPLY_REL = 1e-12    # phase 10d: card against CPU residual and J.v (fp64, of max|y|)
DGNS_GMRES_ITS = 50       # phase 10d: block-Jacobi GMRES iterations, card and CPU
DGNS_GMRES_GAP = 1e-8     # phase 10d: relative gap of the card's and the CPU's reductions
AMG_SIZES = (256, 512, 1024)   # phase 11b: 2D simplex P1, N = 66,049 / 263,169 / 1,050,625
AMG_ITS_MAX = 25          # phase 11b: AMG-CG iterations (tests/test_amg.py:93-103)
AMG_ITS_SPREAD = 5        # phase 11b: max - min iterations over the sizes
AMG_L2_RATIO = (3.0, 5.0)  # phase 11b: L2 error ratio per halving of h (~h^2)
AMG_TET_CELLS = 64        # phase 11c: 3D Kuhn tetrahedra, 1,572,864 tets, N = 274,625
AMG_TET_ITS_MAX = 30      # phase 11c (tests/test_amg.py:200-210)
README_JACOBI_ITS = 149   # phase 4's fp32 Jacobi-CG iterations at 127^3 (PERF.md)
DGMG_GMG_ITS = 6          # phase 7c's gmg-coarse iterations at 64^3 (PERF.md)
DIRECT_CELLS = 128        # phase 11f: SEQ_SuperLU on 2D Q2 Poisson
EIGEN_CELLS = 128         # phase 11f: lobpcg on the 2D Q1 Dirichlet Laplacian with mass
GENEO_CELLS = 128         # phase 11f: GenEO (method="ilu"), boxes (4, 4)
ADAPT_UNIFORM = (256, 512, 1024)   # phase 12b: uniform L-shapes, N up to 788,481
ADAPT_START = 64          # phase 12b: the adaptive loop's initial L-shape (64^2 square)
ADAPT_TARGET = 5 * 10 ** 4   # phase 12b: run until N >= this (the command's time limit)
ADAPT_MAX_CYCLES = 25     # phase 12b: or this many cycles
ADAPT_ITS_MAX = 25        # phase 12b: AMG-CG iterations per cycle
ADAPT_SLOPE_NMIN = 10 ** 4   # phase 12b: the slope is fitted over cycles with N >= this
ADAPT_AMG = {"smoother": "chebyshev"}   # phase 12: the AMG smoother (with Jacobi
# smoothing AMG-CG drifts to 29 iterations on 12b's graded meshes by 7e4 DOFs, and
# the DGTwoLevel coarse solve of 12f to 29 iterations at 64^2; CPU runs)
FICHERA_UNIFORM = (16, 32)   # phase 12c: uniform Kuhn Fichera meshes
FICHERA_TARGET = 25_000   # phase 12c: adaptive loop until N >= this (time limit)
FICHERA_MAX_CYCLES = 30   # Doerfler 0.6 grows N ~1.5x a cycle: 2e5 at cycle 26
HANG_UNIFORM = 256        # phase 12d: uniform Q1 run, N = 66,049
HANG_TARGET = 25_000      # phase 12d: AdaptiveMesh loop until N >= this (time limit)
HANG_MAX_CYCLES = 40
PERIODIC_CELLS = (32, 64)   # phase 12e: periodic 3D Poisson
HEAT_PERIODIC_CELLS = 256   # phase 12e: fully periodic 2D heat
MAPPED_CELLS = (256, 512)   # phase 12f: curved Poisson on the annulus
MAPPED_DG_CELLS = (128, 256)   # phase 12f: SIPG on the curved mesh
SIMPLEX_DG_CELLS = (128, 256)  # phase 12g: SIPG PkDGFEM(1, 2) on triangles
# phase 13 (slice 13a), fp64 unless stated
# 13k: every (dim, nb) phase 13 launches the block stencil at, in fp32 and
# fp64, in each layout the kernel has there: (operator kind, cells,
# layouts): nb = 1 (CCFV on P0), nb = 6 (SIPG on MonomialDGFEM and OPBFEM at
# k = 2), nb = 9 (LegendreDGFEM at k = 2), nb = 4 in 3D (MonomialDGFEM at
# k = 1). Their launches are not counted.
P13_KERNEL_CASES = [("ccfv", (1024, 1024), ("em",)),
                    ("ccfv", (128, 128, 128), ("mm", "em")),
                    ("MonomialDGFEM", (256, 256), ("em",)),
                    ("OPBFEM", (256, 256), ("em",)),
                    ("LegendreDGFEM", (256, 256), ("em",)),
                    ("MonomialDGFEM", (32, 32, 32), ("mm", "em"))]
TP_C11_CELLS = 24         # 13a: config11 golden (models/configs.py:440-487)
# 13b: config11's displacement at N = 32,768 on square cells: 32 cells
# across the front (x) by 512 rows on [0, 1] x [0, 16], periodic in y, so
# every row sees the same operator (the problem is 1D in x). With 64 or
# more cells across, the first step of dt = 1e-3 does not converge within
# 4 halvings, in the JAX package too (a line search failure at 64, 128 and
# 256 cells across; 48 needs all 4; models/configs.py config11 runs 24);
# with walls in y the rows' Jacobi diagonals differ and whether it
# converges depends on the row count (the JAX package fails at 32 x 64).
TP_CELLS = (32, 512)
TP_HEIGHT = 16.0
TP_TEND = 0.004           # 13b: 4 implicit Euler steps of dt = 1e-3
TP_WELLS_CELLS = 128      # 13b: wells (tests/test_twophase.py:79-127)
# 13b: config11's first three steps on the card and on the CPU: 8 x 4 cells
# (13 Newton iterations, ~40 s of the CPU's eager general-jvp applies); at
# 48 x 4 the first step fails 4 times and the CPU side takes minutes
TP_SMALL_CELLS = 8
# 13b: the wells' storage change per step against the injected amount. At
# 128^2 the injected amount per step is 3.1e-8 (256x smaller than at the
# test's 8^2) and the JAX package's own run of this problem with the test's
# settings misses the test's 1e-6 (1.67e-6 at step 2; 9.8e-9 and 4.1e-7 at
# steps 1 and 3): Newton stops on its absolute defect limit
TP_WELLS_REL = 1e-5
# the states agree to the solves' accuracy, not to rounding: Newton stops at
# a 1e-7 defect reduction with BiCGStab to 1e-4, so the card's and the CPU's
# iterates part at ~1e-9 (2.1e-9 of max|x| measured)
TP_SMALL_TOL = 1e-8
CCFV_2D = (512, 1024)     # 13c: N = 1,048,576 at 1024^2 (K6, nb = 1)
CCFV_3D = (64, 128)       # 13c: N = 2,097,152 at 128^3 (K5, nb = 1)
CCFV_UPWIND = 512         # 13c: upwind transport (tests/test_ccfv.py:49-64)
CCFV_UPWIND_SMALL = 128   # 13c: the largest size whose Jacobi-BiCGStab holds its bounds
CCFV_ORDER_MIN = 1.7      # tests/test_ccfv.py:43
MODAL_CELLS = (128, 256)  # 13d: SIPG on the modal bases
MODAL_ORDER_MIN = 2.5     # tests/test_fe_zoo.py:81
MODAL_3D_CELLS = 32       # 13d: MonomialDGFEM(1, 3), nb = 4 (K5)
VARORDER_CELLS = 64       # 13d: variable order (tests/test_variableorder.py:62-85)
ELAST_CELLS = (128, 256)  # 13e: N = 132,098 / 526,338
ELAST_SMALLER = (64, 128)
ELAST_BUDGET_S = 40.0
ELAST_ORDER_MIN = 2.7     # tests/test_elasticity.py:85
ACOUSTICS_CELLS = 256     # 13f: 2D Q2 standing wave, N = 1,769,472
MAXWELL_CELLS = 32        # 13f: 3D Q1 cavity, 32^3 cells, N = 1,572,864
WAVE_STEPS = 25          # phase 13f: shu3 steps (few: the command's time limit)
WAVE_SMALL_TOL = 1e-12
PROJ_CELLS = 64           # 13g: L2 projections of polynomials
PROJ_TOL = 1e-12
P14_MIXED_RED = 1e-11       # 14a/14b: MINRES reduction (tests/test_mixed.py:59)
P14_MINRES_MAX = 60000
P14_CONSERVE = 1e-9         # 14a/14b: max |r_p| of the converged solves
P14_RT0_CELLS = (128, 256)  # 14a: RT0/P0, N = 197,120 at 256^2
P14_RT1_CELLS = (32, 64)    # 14a: RT1/Q1DG
P14_RT2_CELLS = (16, 32)    # 14a: RT2/Q2DG (MINRES to 1e-12, tests/test_rt_higher.py:96)
P14_BDM1_CELLS = 128        # 14a: BDM1/P0
P14_TRI_CELLS = (64, 128)   # 14b: RT0 triangles (x 2 per square)
P14_BDM1_TRI = 128          # 14b: BDM1 triangles
P14_RT1_TRI = (32, 64)      # 14b: RT1/P1DG triangles
P14_TET_CELLS = 16          # 14b: RT0 tets, 16^3 x 6 = 24,576 tets
P14_HEX_CELLS = (8, 16)     # 14b: RTkCube3D(1)/Q1DG
P14_ANNULUS_CELLS = (64, 128)   # 14b: RT0/P0 on the quarter annulus
P14_CURL_CELLS = (128, 256)     # 14c: curl-curl on N0Cube(2)
P14_DERHAM_CELLS = 32           # 14c: N0Cube(3), N = 104,544
P14_WHITNEY_CELLS = (8, 16)     # 14c: Whitney tets
P14_CAVITY_CELLS = 32           # 14c: Maxwell cavity, 1,984 free edges
P14_MFD_CELLS = (256, 512)      # 14d: DiffusionMFD, N = 525,312 at 512^2
P14_MFD_3D = 32                 # 14d: 3D mimetic, N = 101,376
P14_ADJ_CELLS = 256             # 14e: adjoint gradient, N = 66,049
P14_ADJ_SMALL = 10              # 14e: card against CPU
P14_ROLL_CELLS = 128            # 14e: rollout, N = 16,641
P14_ROLL_STEPS = 20
P14_ROLL_DT = 1e-3
P14_SMALL = 8                   # 14f: 8^2 (4^3 in 3D)
P14_CASES = ("mixed-RT0", "mixed-BDM1", "mixed-RT1", "mixed-RT2", "mixed-RT0tri",
             "mixed-BDM1tri", "mixed-RT0tet", "mixed-annulus", "curl-cube2", "curl-cube3",
             "curl-simplex2", "curl-simplex3", "mfd")
# phase 15 (slice 12, parallel/): ranks on the one card, one process each
P15_CELLS = 256           # 15a: 3D Q1 Poisson, 257^3 = 16,974,593 DOFs, fp32
P15_RANKS = 4             # 15a/15b/15c: ranks sharing the card over gloo
P15_GMG_TOL = 1e-8        # 15a: GMG-CG recurrence reduction (phase 5a's)
P15_TRUE_REL = 1e-5       # 15a: fp32 true relative defect after GMG-CG
P15_GATHER_BELOW = 32 ** 3   # 15a: levels below this many DOFs run replicated
# 15a: the sharded apply against the sequential one (fp32, of max|y|): the
# same taps and order of sums reach every interior point, so any difference
# is a fault; the bound allows fp32 rounding of a reordered sum anyway
P15_APPLY_REL = 1e-6
P15_DG_CELLS = 256        # 15b: 256^2 degree-1 SIPG, 262,144 DOFs, fp64
P15_DG_REL = 1e-12        # 15b: sharded residual and J.v against one rank's (fp64)
P15_AMG_CELLS = 1024      # 15c: phase 11b's simplex P1 problem, 1,050,625 DOFs, fp64
# phase 16 (slice 13d: io, models, selective assembly)
P16_ASCII_CELLS = 32      # 16a: the ASCII .vtu written from the card and from the CPU
P16_PARTS = 4             # 16a: ParallelVTKWriter pieces (parallel/ load balancing)
P16_MSH_CELLS = 56        # 16b: 6 * 56^3 = 1,053,696 Kuhn tets (the Python parser
                          #      takes ~7 s on an 8-core CPU box)
P16_DGF_CELLS = 512       # 16c: a 512^2 Interval block, Q1
P16_SEL_Q1 = 512          # 16d: complementary skip_entity, 2D Q1
P16_SEL_DG = 256          # 16d: skip_intersection partition, 2D SIPG degree 1
P16_SEL_CPU = 16          # 16d: card against the CPU
P16_SEL_K3 = 64           # 16d: K3 declines a selective 3D Q1 operator
P16_SEL_REL = 1e-12
P16_HEAT_CELLS = 256      # 16e: the INI heat problem, CN dt 0.025 to 0.2
P16_HEAT_L2_MAX = 0.01    # 16e: tests/test_boilerplate_config.py's bound
P16_INI = """
[time]
scheme = crank_nicolson
dt = 0.025
tend = 0.2

[linear_solver]
type = cg
preconditioner = jacobi
maxiter = 4000
"""
P17_RANKS = 8             # 17: ex07, ex08 and ex14's sharded AMG on 8 gloo ranks
P17_ORDER = (1.8, 2.2)    # 17: ex02's SIPG order over 16^2 -> 32^2 (the reference: 2.02)
P17_THETA_ERR = 1e-6      # 17: ex11's recovered theta against theta_true
P17_PARITY = 1e-12        # 17: ex07/ex14 sharded against sequential solutions
P17_HELPER_THREADS = 2    # 17: CPU threads of each helper process (five processes share 8 cores)
CARD = "card not read yet"   # nvidia-smi name and power limit, set by main()
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (data sheet)
FP32_FLOPS = 67e12          # H100 SXM fp32 outside the tensor cores


def log(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def bound(nbytes, flops):
    """Least time the card could take: the larger of the bytes over the
    memory rate and the fp32 operations over the fp32 (non-tensor) peak."""
    t_bytes, t_ops = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * flops / FP32_FLOPS
    return ({"bound_ms": t_bytes, "bound_by": "bytes"} if t_bytes >= t_ops
            else {"bound_ms": t_ops, "bound_by": "operations"})


def cuda_ms(torch, fn, reps):
    """Mean milliseconds of fn() over reps launches, timed with CUDA events
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def graph_ms(torch, fn, reps):
    """Mean milliseconds of fn() over reps launches replayed from one CUDA
    graph: the device's time without the host's per-call cost, which hides
    it at small shapes."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    g.replay()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def ptxas_report(build_log):
    """(kernel, registers, spills) of each entry function of the ptxas -v
    log."""
    out, name, spill = [], None, ""
    for ln in build_log.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1] if "'" in ln else ln
            spill = ""
        elif "spill" in ln:
            spill = ln.strip()
        elif "Used" in ln and "registers" in ln and name is not None:
            out.append((name, ln.split(":", 1)[-1].strip(), spill))
            name = None
    return out


def faces_grid(torch, dims, dev):
    """(nz, ny, nx) bool grid, True on every boundary face of the lattice."""
    nx, ny, nz = dims
    faces = torch.zeros((nz, ny, nx), dtype=torch.bool, device=dev)
    faces[0] = faces[-1] = True
    faces[:, 0] = faces[:, -1] = True
    faces[:, :, 0] = faces[:, :, -1] = True
    return faces


def q1_laplace_taps(h):
    """(3, 3, 3) taps of the 3D Q1 Laplacian on a cube of side h."""
    import numpy as np
    w = np.zeros((3, 3, 3))
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                nnz = abs(dx) + abs(dy) + abs(dz)
                w[dz + 1, dy + 1, dx + 1] = {0: 8 / 3, 1: 0.0, 2: -1 / 6,
                                             3: -1 / 12}[nnz] * h
    return w


def phase_kernels(torch, dims_list, main_dims, dev):
    """Phase 2: kernels against plain versions on the card."""
    import numpy as np
    from dune_pdelab_tpu_torch.kernels import fused_cg as fk
    from dune_pdelab_tpu_torch.kernels import stencil27 as sk

    rng = np.random.default_rng(2024)
    record = {}
    for dims, dtype in dims_list:
        nx, ny, nz = dims
        tag = f"{nx}x{ny}x{nz} {str(dtype).replace('torch.', '')}"
        w27 = q1_laplace_taps(1.0 / (nx - 1)) * (1 + 0.1 * rng.standard_normal((3, 3, 3)))
        tol = 1e-6 if dtype == torch.float32 else 1e-13
        dtol = 1e-5 if dtype == torch.float32 else 1e-12
        faces = faces_grid(torch, dims, dev)
        mask = faces.reshape(-1)

        def rand():
            v = torch.as_tensor(rng.standard_normal((nz, ny, nx)), dtype=dtype,
                                device=dev)
            return torch.where(faces, 0.0, v)

        def err(a, b):
            e = float((a - b).abs().max())
            lim = tol * float(b.abs().max())
            if not e <= lim:
                raise AssertionError(f"{tag}: max abs err {e:.3e} > {lim:.3e}")
            return e

        def rel(a, b):
            e = abs(float(a) - float(b)) / abs(float(b))
            if not e <= dtol:
                raise AssertionError(f"{tag}: dot rel err {e:.3e} > {dtol:.1e}")
            return e

        z = torch.as_tensor(rng.standard_normal(nx * ny * nz), dtype=dtype, device=dev)
        e_st = err(sk.stencil27(z, mask, w27, dims), sk.stencil27_reference(z, mask, w27, dims))

        r, p, x = rand(), rand(), rand()
        beta = torch.tensor(0.37, dtype=dtype, device=dev)
        alpha = torch.tensor(0.21, dtype=dtype, device=dev)
        pn, pap = fk.fused_cg_k1(r, p, beta, w27)
        pn_p, pap_p = fk.fused_cg_k1_reference(r, p, beta, w27)
        e_k1, d_k1 = err(pn, pn_p), rel(pap, pap_p)
        xn, rn, rr = fk.fused_cg_k2(x, r, p, alpha, w27)
        xn_p, rn_p, rr_p = fk.fused_cg_k2_reference(x, r, p, alpha, w27)
        e_k2, d_k2 = max(err(xn, xn_p), err(rn, rn_p)), rel(rr, rr_p)
        torch.cuda.synchronize()

        reps = 20 if nx * ny * nz > 10**7 else 50
        t = {
            "stencil27": (cuda_ms(torch, lambda: sk.stencil27(z, mask, w27, dims), reps),
                          cuda_ms(torch, lambda: sk.stencil27_reference(z, mask, w27, dims), reps)),
            "fused_cg_k1": (cuda_ms(torch, lambda: fk.fused_cg_k1(r, p, beta, w27), reps),
                            cuda_ms(torch, lambda: fk.fused_cg_k1_reference(r, p, beta, w27), reps)),
            "fused_cg_k2": (cuda_ms(torch, lambda: fk.fused_cg_k2(x, r, p, alpha, w27), reps),
                            cuda_ms(torch, lambda: fk.fused_cg_k2_reference(x, r, p, alpha, w27), reps)),
        }
        errs = {"stencil27": e_st, "fused_cg_k1": e_k1, "fused_cg_k2": e_k2}
        nbytes = nx * ny * nz * (2 * z.element_size() + 1)
        log(f"[phase 2] {tag}: max abs err stencil27 {e_st:.3e}, k1 {e_k1:.3e} "
            f"(dot rel {d_k1:.2e}), k2 {e_k2:.3e} (dot rel {d_k2:.2e}); "
            f"stencil27 {t['stencil27'][0]:.4f} ms "
            f"(plain {t['stencil27'][1]:.4f}, {nbytes / t['stencil27'][0] / 1e6:.1f} GB/s "
            f"effective), k1 {t['fused_cg_k1'][0]:.4f} ms (plain "
            f"{t['fused_cg_k1'][1]:.4f}), k2 {t['fused_cg_k2'][0]:.4f} ms "
            f"(plain {t['fused_cg_k2'][1]:.4f})")
        if tuple(dims) == tuple(main_dims) and dtype == torch.float32:
            n, es = nx * ny * nz, z.element_size()
            # bytes each input read once / output written once; 27 FMAs
            # per point (+ the update and dot of the CG passes)
            work = {"stencil27": (n * (2 * es + 1), 54 * n),
                    "fused_cg_k1": (n * 3 * es, 58 * n),
                    "fused_cg_k2": (n * 5 * es, 60 * n)}
            wt = torch.as_tensor(w27, dtype=dtype, device=dev).reshape(1, 1, 3, 3, 3)
            zg = z.reshape(1, 1, nz, ny, nx)
            library = {"stencil27": cuda_ms(torch, lambda: torch.nn.functional.conv3d(
                zg, wt, padding=1), reps)}
            record = {k: {"max_abs_err": errs[k], "ms": t[k][0], "plain_ms": t[k][1],
                          **bound(*work[k]), "library_ms": library.get(k)}
                      for k in errs}
            log(f"[phase 2] {tag}: library conv3d (3x3x3, TF32 off, no mask) "
                f"{library['stencil27']:.4f} ms; bounds "
                + ", ".join(f"{k} {record[k]['bound_ms']:.4f} ms ({record[k]['bound_by']})"
                            for k in record))
        del z, r, p, x, pn, pn_p, xn, rn, xn_p, rn_p
        torch.cuda.empty_cache()
    if not record:
        raise AssertionError("phase 2 did not run the main path's shape")
    return record


def phase_stencil_levels(torch, dev):
    """Phase 2 (stencil27): the kernel against its plain version in fp32
    and fp64 at every LatticeGMG level shape of phase 5a, 3^3 and 67x45x33
    (random z and taps, all-faces mask); a repeated launch gives the same
    bits; the fp32 time at each shape."""
    import numpy as np
    from dune_pdelab_tpu_torch.kernels import stencil27 as sk

    rng = np.random.default_rng(513)
    times = {}
    for dims in MG_LEVEL_DIMS + [(3, 3, 3), (67, 45, 33)]:
        nx, ny, nz = dims
        n = nx * ny * nz
        mask = faces_grid(torch, dims, dev).reshape(-1)
        w27 = q1_laplace_taps(1.0 / (nx - 1)) * (1 + 0.1 * rng.standard_normal((3, 3, 3)))
        for dtype, tol in ((torch.float32, 1e-6), (torch.float64, 1e-13)):
            tag = f"{nx}x{ny}x{nz} {str(dtype).replace('torch.', '')}"
            z = torch.as_tensor(rng.standard_normal(n), dtype=dtype, device=dev)
            y = sk.stencil27(z, mask, w27, dims)
            y_p = sk.stencil27_reference(z, mask, w27, dims)
            err = float((y - y_p).abs().max())
            lim = tol * float(y_p.abs().max())
            if not (bool(torch.isfinite(y).all()) and err <= lim):
                raise AssertionError(f"stencil27 {tag}: max abs err {err:.3e} > {lim:.3e}")
            if not torch.equal(y, sk.stencil27(z, mask, w27, dims)):
                raise AssertionError(f"stencil27 {tag}: a repeated launch differs")
            line = f"[phase 2] stencil27 {tag}: max abs err {err:.3e}, repeat bit-equal"
            if dtype == torch.float32:
                run = lambda: sk.stencil27(z, mask, w27, dims)
                reps = 20 if n > 10**7 else (100 if n > 10**5 else 500)
                # small shapes are host-bound when launched one by one; the
                # graph replay shows the device's time
                times[dims] = (cuda_ms(torch, run, reps),
                               graph_ms(torch, run, 200) if n <= 10**7 else None)
                line += f", {times[dims][0]:.4f} ms" + (
                    f" ({times[dims][1]:.4f} ms from a CUDA graph)" if times[dims][1] else "")
            log(line)
            del z, y, y_p
        torch.cuda.empty_cache()
    log("[phase 2] stencil27 fp32 ms per level shape (eager / graph): "
        + ", ".join(f"{d[0]}x{d[1]}x{d[2]} {t:.4f}" + (f" / {g:.4f}" if g else "")
                    for d, (t, g) in times.items()))


def unit_source_problem():
    """3D Poisson with f == 1 and homogeneous Dirichlet data (bench.py:183-185)."""
    import torch
    from dune_pdelab_tpu_torch.ops import ConvectionDiffusionProblem

    class UnitSource(ConvectionDiffusionProblem):
        def f(self, x):
            return torch.ones(x.shape[:-1], dtype=x.dtype, device=x.device)
    return UnitSource()


def field_a_problem():
    """The varsolve problem (bench.py:582-590): A = 1 + 0.5 sin(pi x)
    sin(pi y) sin(pi z), f == 1, homogeneous Dirichlet data."""
    import torch
    from dune_pdelab_tpu_torch.ops import ConvectionDiffusionProblem

    class FieldA(ConvectionDiffusionProblem):
        def A(self, x):
            s = (torch.sin(math.pi * x[..., 0]) * torch.sin(math.pi * x[..., 1])
                 * torch.sin(math.pi * x[..., 2]))
            return 1.0 + 0.5 * s

        def f(self, x):
            return torch.ones(x.shape[:-1], dtype=x.dtype, device=x.device)
    return FieldA()


def tensor_conv_problem():
    """Full anisotropic tensor + convection + reaction + source
    (tests/test_structured_fused.py TensorConv)."""
    import torch
    from dune_pdelab_tpu_torch.ops import ConvectionDiffusionProblem

    class TensorConv(ConvectionDiffusionProblem):
        def A(self, x):
            base = torch.eye(3, dtype=x.dtype, device=x.device) + 0.3
            return (1.0 + x[..., 1] * x[..., 2])[..., None, None] * base

        def b(self, x):
            return torch.stack([x[..., 1], -x[..., 0], 0.5 * torch.ones_like(x[..., 0])],
                               dim=-1)

        def c(self, x):
            return 0.2 + x[..., 2]

        def f(self, x):
            return torch.cos(2 * x[..., 0]) * x[..., 1]
    return TensorConv()


def q1_operator(torch, pt, problem, cells, dev, quad_order=None):
    """GridOperator of ConvectionDiffusionFEM(problem) on the unit cube,
    Q1, Dirichlet on every face, constraints on `dev`."""
    from dune_pdelab_tpu_torch.ops import ConvectionDiffusionFEM
    mesh = pt.StructuredMesh([0, 0, 0], [1, 1, 1], cells)
    V = pt.FunctionSpace(mesh, pt.QkFEM(1, 3))
    cgm = pt.constraints(problem.dirichlet_bctype(), V, device=dev)
    lop = ConvectionDiffusionFEM(problem)
    return V, cgm, lop, pt.GridOperator(V, lop, constraints=cgm, skip_boundary=True,
                                        quad_order=quad_order)


def phase_fused_kernel(torch, pt, dev):
    """Phase 2 (structured_fused): kernel against its plain version on the
    card at the main path's 512^3 cells, a ragged 66x44x32 cells and one
    cell (2x2x2 nodes), both modes, a field-A and a tensor-A + b + c + f
    problem, on the default rule (q = 2 Gauss points per axis, the kernel's
    specialisation); at 66x44x32 cells also on quad_order 4 (q = 3, the
    runtime-q instantiation): fp32 field-A J.v and fp64 tensor residual. A
    repeated launch gives the same bits."""
    import numpy as np
    from dune_pdelab_tpu_torch.assembly.structured_fused import (
        make_fused_japply, make_fused_residual)
    from dune_pdelab_tpu_torch.kernels import structured_fused as sfk

    rng = np.random.default_rng(77)
    record = {}
    problems = {"field-A": field_a_problem, "tensor-A+b+c+f": tensor_conv_problem}
    makes = {"residual": make_fused_residual, "japply": make_fused_japply}
    every = [(p, m) for p in problems for m in makes]
    # (cells, dtype, quad_order, [(problem, mode)])
    cases = ([(c, torch.float32, None, every) for c in FUSED_CELLS]
             + [(c, torch.float64, None, every) for c in FUSED_CELLS[1:]]
             + [(FUSED_CELLS[1], torch.float32, 4, [("field-A", "japply")]),
                (FUSED_CELLS[1], torch.float64, 4, [("tensor-A+b+c+f", "residual")])])
    for cells, dtype, quad_order, runs in cases:
        for pname in dict.fromkeys(p for p, _ in runs):
            V, cgm, _, go = q1_operator(torch, pt, problems[pname](), cells, dev, quad_order)
            x = torch.as_tensor(rng.standard_normal(V.ndofs), dtype=dtype, device=dev)
            for mode in [m for p, m in runs if p == pname]:
                op = makes[mode](go)
                t0 = time.perf_counter()
                tab, coef = op.state(x.dtype, x.device)
                torch.cuda.synchronize()
                eval_s = time.perf_counter() - t0
                y = op(x)
                y_p = sfk.structured_fused_reference(x, cgm.mask, tab, coef, op.dims,
                                                     mode == "japply")
                torch.cuda.synchronize()
                if not bool(torch.isfinite(y).all()):
                    raise AssertionError(f"structured_fused {cells} {pname} {mode}: non-finite")
                err = float((y - y_p).abs().max())
                tol = 1e-5 if dtype == torch.float32 else 1e-12
                lim = tol * float(y_p.abs().max())
                tag = (f"{cells[0]}x{cells[1]}x{cells[2]} cells "
                       f"{str(dtype).replace('torch.', '')} {pname} {mode} "
                       f"q={sfk.tensor_rule(tab).q}")
                if not err <= lim:
                    raise AssertionError(f"structured_fused {tag}: max abs err "
                                         f"{err:.3e} > {lim:.3e}")
                if not torch.equal(y, op(x)):
                    raise AssertionError(f"structured_fused {tag}: a repeated launch differs")
                big = V.ndofs > 10**7
                ms = cuda_ms(torch, lambda: op(x), 10 if big else 50)
                plain_ms = cuda_ms(torch, lambda: sfk.structured_fused_reference(
                    x, cgm.mask, tab, coef, op.dims, mode == "japply"), 2 if big else 10)
                nel = int(np.prod(cells))
                log(f"[phase 2] structured_fused {tag}: max abs err {err:.3e}, repeat bit-equal "
                    f"(max|y| {float(y_p.abs().max()):.3e}), {ms:.4f} ms "
                    f"({nel / ms / 1e6:.3f} Gelem/s; plain {plain_ms:.4f} ms), "
                    f"coefficients {sum(t.numel() for t in coef[2:] if t is not None) * x.element_size() / 2**30:.2f} GiB "
                    f"evaluated in {eval_s:.2f} s")
                if (tuple(cells) == FUSED_CELLS[0] and pname == "field-A"
                        and mode == "japply" and quad_order is None):
                    record["structured_fused"] = {
                        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                        **bound(*k3_work(V.ndofs, x.element_size(), coef, nel)),
                        "library_ms": None}
                    nbytes, flops = k3_work(V.ndofs, x.element_size(), coef, nel)
                    log(f"[phase 2] structured_fused bound {tag}: "
                        f"{record['structured_fused']['bound_ms']:.4f} ms "
                        f"({record['structured_fused']['bound_by']}; {nbytes / nel:.1f} "
                        f"B/element, {flops / nel:.0f} flop/element sum-factorised)")
                del op, tab, coef, y, y_p
                torch.cuda.empty_cache()
            del x, go, cgm, V
            torch.cuda.empty_cache()
    if not record:
        raise AssertionError("phase 2 did not run structured_fused at the main path's size")
    return record


def k3_work(ndofs, es, coef, nel):
    """(bytes, operations) of the function one structured_fused launch
    computes. Bytes: x, the mask and y per node plus every coefficient
    value once. Operations: what a sum-factorised Q1 evaluation needs on
    q^3 Gauss points (fewer than the kernel's own per-point sums), an FMA
    counted as 2. u and grad u: 2 + 3 + 4 one-dimensional contractions
    (2 -> q points, a 2-term dot per output); the transposed sweep: 4 + 3
    + 2 contractions (q -> 2, a q-term dot per output) and the adds that
    join the fields; per point A g (3 or 15), - u b (6), c u (1), - f (1)
    and 4 weight scalings."""
    a_kind, _, A, b, c, f = coef
    arrays = [t for t in (A, b, c, f) if t is not None]
    nqp = arrays[0].shape[0] if arrays else 8
    q = round(nqp ** (1 / 3))
    if q**3 != nqp:
        raise AssertionError(f"k3_work: {nqp} quadrature points are not a tensor rule")
    interp = 3 * (2 * 4 * q + 3 * 2 * q**2 + 4 * q**3)
    test = (2 * q - 1) * (4 * 2 * q**2 + 3 * 4 * q + 2 * 8) + 2 * q**2 + 4 * q + 8
    per_qp = ((15 if a_kind == 3 else 3) + 6 * (b is not None)
              + (c is not None) + (f is not None) + 4)
    nbytes = ndofs * (2 * es + 1) + sum(t.numel() for t in arrays) * es
    return nbytes, (interp + test + per_qp * nqp) * nel


def choose_nslabs(torch, pt, lop, cells, dev, tag="phase 3"):
    """Slab count for residual_slabbed from the measured peak memory of one
    8-plane slab, so that a slab stays within a quarter of free memory."""
    from dune_pdelab_tpu_torch.assembly.gridoperator import GridOperator
    n = cells
    h = 1.0 / n
    mesh = pt.StructuredMesh([0, 0, 0], [1, 1, 8 * h], (n, n, 8))
    go = GridOperator(pt.FunctionSpace(mesh, pt.QkFEM(1, 3)), lop, skip_boundary=True)
    x = torch.zeros(go.space.ndofs, dtype=torch.float32, device=dev)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    go.residual_unconstrained(x)
    torch.cuda.synchronize()
    per_elem = (torch.cuda.max_memory_allocated() - base) / mesh.nelements
    del go, x
    torch.cuda.empty_cache()
    free, _ = torch.cuda.mem_get_info()
    nslabs = max(1, math.ceil(n**3 * per_elem / (0.25 * free)))
    log(f"[{tag}] slab probe: {per_elem:.1f} B/element peak, {free / 2**30:.1f} GiB "
        f"free -> nslabs = {nslabs}")
    return nslabs


def phase_main(torch, pt, cells, iters, dev):
    """Phase 3: the bench chain at full size."""
    from dune_pdelab_tpu_torch.assembly import stencil as stencil_mod
    from dune_pdelab_tpu_torch.assembly.fused_cg import make_fused_cg, qualifies
    from dune_pdelab_tpu_torch.assembly.slabbed import residual_slabbed
    from dune_pdelab_tpu_torch.kernels.stencil27 import stencil27_reference
    from dune_pdelab_tpu_torch.linalg import cg
    from dune_pdelab_tpu_torch.ops import ConvectionDiffusionFEM

    f32 = torch.float32
    t0 = time.perf_counter()
    prob = unit_source_problem()
    mesh = pt.StructuredMesh([0, 0, 0], [1, 1, 1], (cells,) * 3)
    V = pt.FunctionSpace(mesh, pt.QkFEM(1, 3))
    cgm = pt.constraints(prob.dirichlet_bctype(), V, device=dev)
    lop = ConvectionDiffusionFEM(prob)
    go = pt.GridOperator(V, lop, constraints=cgm, skip_boundary=True)
    N = V.ndofs
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    log(f"[phase 3] setup: N = {N} DOFs, {setup_s:.2f} s")

    nslabs = choose_nslabs(torch, pt, lop, cells, dev)
    x0 = V.zero(f32, dev)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    b = residual_slabbed(V, lop, cgm, x0, nslabs=nslabs)
    torch.cuda.synchronize()
    res_s = time.perf_counter() - t0
    bnorm = float(torch.linalg.norm(b))
    if not (math.isfinite(bnorm) and bnorm > 0):
        raise AssertionError(f"RHS norm {bnorm}")
    log(f"[phase 3] residual_slabbed: nslabs {nslabs}, {res_s:.2f} s, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, |b| = {bnorm:.6e}")

    proxy = (mesh.nelements > stencil_mod.PROXY_MIN_ELEMENTS
             and stencil_mod._coefficients_spatially_constant(lop, mesh))
    if not proxy:
        raise AssertionError("compile_stencil would not take the proxy branch")
    t0 = time.perf_counter()
    st = stencil_mod.compile_stencil(go, dtype=f32, device=dev)
    torch.cuda.synchronize()
    comp_s = time.perf_counter() - t0
    if st is None or not qualifies(st):
        raise AssertionError("stencil did not compile or does not qualify for fused CG")
    # the first call pays torch.func's one-off imports; the second is the
    # compile's own cost
    t0 = time.perf_counter()
    stencil_mod.compile_stencil(go, dtype=f32, device=dev)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    log(f"[phase 3] compile_stencil (proxy branch): {comp_s:.2f} s first call, "
        f"{warm_s:.2f} s second call, centre tap {st.w27[1, 1, 1]:.6e}")

    solve = make_fused_cg(st, maxiter=iters, tol=0.0)
    solve(b)                                   # warm-up (allocator, caches)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    z, stats = solve(b)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    defect = float(stats.defect)
    if stats.iterations != iters:
        raise AssertionError(f"fused CG ran {stats.iterations} iterations, not {iters}")
    if not bool(torch.isfinite(z).all()) or not math.isfinite(defect):
        raise AssertionError("fused CG produced non-finite values")
    # CG minimises the energy 1/2 z.Az - b.z monotonically from 0 at z0 = 0;
    # the residual norm is not monotone (at 512^3 it is above |b| after 50
    # iterations, and the plain CG below shows the same)
    Az = st(z)
    energy = float(0.5 * torch.dot(z.double(), Az.double()) - torch.dot(b.double(), z.double()))
    if not energy < 0.0:
        raise AssertionError(f"CG energy {energy:.3e} did not fall below 0")
    true_res = float(torch.linalg.norm(b - Az))
    ratio = true_res / defect
    if not 0.1 <= ratio <= 10.0:
        raise AssertionError(f"true residual {true_res:.3e} vs recurrence {defect:.3e}")
    log(f"[phase 3] fused CG: {iters} iterations in {solve_s:.4f} s = "
        f"{1e3 * solve_s / iters:.4f} ms/iteration, {N * iters / solve_s:.6e} "
        f"dof-iterations/s; defect {bnorm:.4e} -> {defect:.4e}, true residual "
        f"{true_res:.4e}, energy {energy:.6e}")

    t0 = time.perf_counter()
    z_p, s_p = cg(lambda v: stencil27_reference(v, st.mask, st.w27, st.dims), b,
                  tol=0.0, atol=1e-30, maxiter=iters)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    rel = float(torch.linalg.norm(z - z_p) / torch.linalg.norm(z_p))
    d_rel = abs(float(s_p.defect) - defect) / float(s_p.defect)
    log(f"[phase 3] plain CG ({s_p.iterations} iterations, plain stencil) in "
        f"{plain_s:.2f} s, defect {float(s_p.defect):.4e}; fused vs plain: "
        f"solution rel L2 {rel:.3e}, defect rel {d_rel:.3e}")
    if not (rel <= 1e-3 and d_rel <= 1e-2):
        raise AssertionError("fused CG disagrees with the plain CG")


def phase_readme(torch, pt, cells, dev):
    """Phase 4: StationaryLinearProblemSolver + SEQ_CG_Jacobi (README)."""
    from dune_pdelab_tpu_torch.kernels import stencil27 as sk
    from dune_pdelab_tpu_torch.linalg import cg
    from dune_pdelab_tpu_torch.ops import ConvectionDiffusionFEM
    from dune_pdelab_tpu_torch.solvers import SEQ_CG_Jacobi

    for dtype, red in ((torch.float32, 1e-6), (torch.float64, 1e-10)):
        prob = unit_source_problem()
        mesh = pt.StructuredMesh([0, 0, 0], [1, 1, 1], (cells,) * 3)
        V = pt.FunctionSpace(mesh, pt.QkFEM(1, 3))
        cgm = pt.constraints(prob.dirichlet_bctype(), V, device=dev)
        go = pt.GridOperator(V, ConvectionDiffusionFEM(prob), constraints=cgm,
                             skip_boundary=True)
        x0 = V.zero(dtype, dev)
        ls = SEQ_CG_Jacobi()
        before = sk.launches
        t0 = time.perf_counter()
        x = pt.StationaryLinearProblemSolver(go, ls, reduction=red, verbose=0).apply(x0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rep = ls.report(go)
        its = ls.stats_history[-1].iterations
        log(f"[phase 4] {dtype} {V.ndofs} DOFs: {its} iterations, {wall:.2f} s\n{rep}")
        if "compiled stencil" not in rep or "stencil27 CUDA kernel" not in rep:
            raise AssertionError("README path did not take the compiled-stencil tier")
        if not sk.launches > before:
            raise AssertionError("README path launched no stencil27 kernel")
        if not bool(torch.isfinite(x).all()):
            raise AssertionError("README path produced non-finite values")
        if dtype == torch.float64:
            st = ls._stencil_for(go, x0, 0.0)
            r = go.residual(x0)
            diag = st.diagonal(dtype=dtype, device=dev)
            z_p, s_p = cg(lambda v: sk.stencil27_reference(v, st.mask, st.w27, st.dims),
                          r, M=lambda v: v / diag, tol=red, maxiter=5000)
            x_p = x0 - z_p
            rel = float(torch.linalg.norm(x - x_p) / torch.linalg.norm(x_p))
            log(f"[phase 4] fp64 plain CG: {s_p.iterations} iterations, rel L2 {rel:.3e}")
            if abs(its - s_p.iterations) > 1 or not rel <= 1e-9:
                raise AssertionError(f"fp64 README path vs plain CG: iterations "
                                     f"{its} vs {s_p.iterations}, rel {rel:.3e}")


def mg_solve_and_refine(torch, pt, cells, dev):
    """Phase 5 (a) and (b): LatticeGMG-CG at `cells`^3 in fp32 to 1e-8
    (bench.py:641-714), then fp64 defect correction around it to a true
    relative defect of 1e-8 (bench.py:478-560). One fine stencil, probed in
    fp64, serves both precisions, as in the reference."""
    from dune_pdelab_tpu_torch.assembly.slabbed import residual_slabbed
    from dune_pdelab_tpu_torch.assembly.stencil import compile_stencil
    from dune_pdelab_tpu_torch.kernels import stencil27 as sk
    from dune_pdelab_tpu_torch.linalg.gmg_lattice import LatticeGMG
    from dune_pdelab_tpu_torch.solvers.refinement import refine_solve

    V, cgm, lop, go = q1_operator(torch, pt, unit_source_problem(), (cells,) * 3, dev)
    N = V.ndofs
    nslabs = choose_nslabs(torch, pt, lop, cells, dev)
    t0 = time.perf_counter()
    b64 = -residual_slabbed(V, lop, cgm, V.zero(torch.float64, dev), nslabs=2 * nslabs)
    b = b64.to(torch.float32)
    torch.cuda.synchronize()
    rhs_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    st = compile_stencil(go, dtype=torch.float64, device=dev)
    gmg = LatticeGMG(V, lop, fine_stencil=st)
    before = sk.launches
    float(torch.sum(gmg.apply(b)))                 # warm the V-cycle
    setup_s = time.perf_counter() - t0
    per_cycle = sk.launches - before
    expected = (gmg.nlevels - 1) * (gmg.pre + gmg.post + 1)
    if cells == MG_CELLS and [tuple(d) for d in gmg.dims[:-1]] != MG_LEVEL_DIMS:
        raise AssertionError(f"LatticeGMG levels {gmg.dims} are not phase 2's "
                             f"MG_LEVEL_DIMS {MG_LEVEL_DIMS} and a coarsest LU level")
    if not (gmg.nlevels >= 3 and all(s.uses_stencil27 for s in gmg.stencils[:-1])
            and per_cycle == expected):
        raise AssertionError(f"LatticeGMG levels {gmg.nlevels}: stencil27 launches per "
                             f"V-cycle {per_cycle}, expected {expected} (every level "
                             f"above the coarsest)")
    log(f"[phase 5a] LatticeGMG {cells}^3 cells (N = {N}): {gmg.nlevels} levels "
        f"{[d[0] for d in gmg.dims]}, RHS (fp64, slabbed) {rhs_s:.2f} s, setup "
        f"(compile_stencil + hierarchy + first V-cycle) {setup_s:.2f} s, stencil27 "
        f"launches per V-cycle {per_cycle} on {gmg.nlevels - 1} levels")

    gmg.solve_host(b, tol=1e-8, maxiter=100)       # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x, info = gmg.solve_host(b, tol=1e-8, maxiter=100)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    true_rel = info["true_defect"] / info["defect0"]
    log(f"[phase 5a] solve: {info['iterations']} iterations in {solve_s:.4f} s "
        f"({N / solve_s:.6e} DOFs/s, {1e3 * solve_s / max(1, info['iterations']):.3f} "
        f"ms/iteration), converged {info['converged']}, true rel defect {true_rel:.3e}")
    if not (info["converged"] and bool(torch.isfinite(x).all()) and true_rel < 1e-2):
        raise AssertionError(f"LatticeGMG solve failed: {info}")
    del x

    inner_its = []

    def inner(r32):
        z, inf = gmg.solve_host(r32, tol=1e-4, maxiter=30)
        inner_its.append(inf["iterations"])
        return z

    float(torch.sum(st(b64)))                      # warm the fp64 stencil
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x64, stats = refine_solve(st, inner, b64, tol=1e-8, max_outer=8)
    torch.cuda.synchronize()
    ref_s = time.perf_counter() - t0
    true64 = float(torch.linalg.norm(b64 - st(x64))) / float(torch.linalg.norm(b64))
    log(f"[phase 5b] refine: {stats.outer_iterations} outer sweeps "
        f"({'+'.join(map(str, inner_its))} = {sum(inner_its)} inner iterations) in "
        f"{ref_s:.4f} s ({ref_s / solve_s:.2f}x the fp32 solve), true fp64 rel "
        f"defect {true64:.3e}, converged {stats.converged}")
    if not (stats.converged and true64 <= 1e-8):
        raise AssertionError(f"fp64 refinement: rel defect {true64:.3e}, {stats}")


def mg_varsolve(torch, pt, sizes, dev):
    """Phase 5 (c): VarCoeffGMG-CG on the fused structured operator
    (bench.py:562-639), fp32, tol 1e-8; flat iteration counts."""
    from dune_pdelab_tpu_torch.assembly.structured_fused import make_fused_residual
    from dune_pdelab_tpu_torch.kernels import structured_fused as sfk
    from dune_pdelab_tpu_torch.linalg.gmg_varcoeff import VarCoeffGMG

    its = {}
    for n in sizes:
        before = sfk.launches
        V, _, _, go = q1_operator(torch, pt, field_a_problem(), (n,) * 3, dev)
        N = V.ndofs
        t0 = time.perf_counter()
        res = make_fused_residual(go)
        b = -res(V.zero(torch.float32, dev))
        del res
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        rhs_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        gmg = VarCoeffGMG(go, coarsest_cells=4)
        float(torch.sum(gmg.apply(b)))
        setup_s = time.perf_counter() - t0
        gmg.solve_host(b, tol=1e-8, maxiter=100)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x, info = gmg.solve_host(b, tol=1e-8, maxiter=100)
        torch.cuda.synchronize()
        solve_s = time.perf_counter() - t0
        its[n] = info["iterations"]
        true_rel = info["true_defect"] / info["defect0"]
        k3 = sfk.launches - before
        log(f"[phase 5c] varsolve {n}^3 cells (N = {N}): {gmg.nlevels} levels, lmax "
            f"{[round(v, 4) for v in gmg.lmax]}, RHS (fused residual) {rhs_s:.2f} s, setup "
            f"{setup_s:.2f} s, {info['iterations']} iterations in {solve_s:.4f} s "
            f"({N / solve_s:.6e} DOFs/s), converged {info['converged']}, true rel "
            f"defect {true_rel:.3e}; structured_fused launches {k3}")
        if not (info["converged"] and bool(torch.isfinite(x).all()) and k3 > 0):
            raise AssertionError(f"varsolve {n}^3 failed: {info}, K3 launches {k3}")
        del x, b, gmg, go, V
        torch.cuda.empty_cache()
    if len(sizes) > 1 and not its[sizes[-1]] <= its[sizes[0]] + 2:
        raise AssertionError(f"varsolve iterations not flat: {its}")


def mg_config13(torch, pt, cells, dev):
    """Phase 5 (d): the port's ALL_CONFIGS["config13"] (one process, so
    without the sharded cross-check) in fp64 on the card, held against
    tests/golden_parity.json."""
    from dune_pdelab_tpu_torch.models import ALL_CONFIGS

    golden = json.loads((ROOT / "tests" / "golden_parity.json").read_text())[
        "config13_scale_lattice_gmg"]
    got, wall = timed(torch, lambda: ALL_CONFIGS["config13"](cells=cells, device=dev))
    l2 = got["l2_error"]
    rel = abs(l2 - golden["l2_error"]) / golden["l2_error"]
    log(f"[phase 5d] config13 {cells}^3 fp64 (N = {got['ndofs']}): {got['iterations']} "
        f"iterations, {got['levels']} levels, L2 error {l2:.16e} (golden "
        f"{golden['l2_error']:.16e}, rel {rel:.2e}), true rel defect "
        f"{got['true_rel_defect']:.3e}, {wall:.2f} s")
    if not (got["iterations"] == golden["iterations"] and got["levels"] == golden["levels"]
            and got["ndofs"] == golden["ndofs"] and rel <= 1e-6):
        raise AssertionError("config13 golden mismatch")


def phase_multigrid(torch, pt, dev):
    """Phase 5: the multigrid solve routes."""
    mg_solve_and_refine(torch, pt, MG_CELLS, dev)
    torch.cuda.empty_cache()
    mg_varsolve(torch, pt, VAR_CELLS, dev)
    mg_config13(torch, pt, C13_CELLS, dev)
    torch.cuda.empty_cache()


def varcoeff_problem():
    """bench.py:737-752's assembled-path problem: A = (1 + 0.5 sin(3x) y) I,
    c = 0.7 + x, f == 1, homogeneous Dirichlet data."""
    import torch
    from dune_pdelab_tpu_torch.ops import ConvectionDiffusionProblem

    class VarCoeff(ConvectionDiffusionProblem):
        def A(self, x):
            a = 1.0 + 0.5 * torch.sin(3 * x[..., 0]) * x[..., 1]
            return a[..., None, None] * torch.eye(x.shape[-1], dtype=x.dtype,
                                                  device=x.device)

        def c(self, x):
            return 0.7 + x[..., 0]

        def f(self, x):
            return torch.ones(x.shape[:-1], dtype=x.dtype, device=x.device)
    return VarCoeff()


def timed(torch, fn):
    """(result, seconds) of fn() ending in a device sync."""
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def asm_residuals(torch, pt, go, lop, cgm, cells, dev):
    """Phase 6a: general and fused (K3) residual rates, elements/s
    (bench.py:759-792), and the fused residual and J.v against the general
    ones at a random x. Returns the fused residual at 0 (the solve's RHS)."""
    from dune_pdelab_tpu_torch.assembly.slabbed import residual_slabbed
    from dune_pdelab_tpu_torch.assembly.structured_fused import (
        make_fused_japply, make_fused_residual)
    from dune_pdelab_tpu_torch.kernels import structured_fused as sfk

    V, E = go.space, go.mesh.nelements
    x0 = V.zero(torch.float32, dev)
    nslabs = choose_nslabs(torch, pt, lop, cells, dev, tag="phase 6a")
    if nslabs == 1:
        which, res = "go.residual (batched)", lambda: go.residual(x0)
    else:
        which = f"residual_slabbed (nslabs {nslabs})"
        res = lambda: residual_slabbed(V, lop, cgm, x0, nslabs=nslabs)
    r_gen, _ = timed(torch, res)
    torch.cuda.reset_peak_memory_stats()
    t_gen = min(timed(torch, res)[1] for _ in range(3))
    peak = torch.cuda.max_memory_allocated() / 2**30
    fused = make_fused_residual(go)
    r_f, t_first = timed(torch, lambda: fused(x0))
    t_f = min(timed(torch, lambda: fused(x0))[1] for _ in range(3))
    rel = float(torch.linalg.norm(r_f - r_gen) / torch.linalg.norm(r_gen))
    log(f"[phase 6a] {which}: {t_gen * 1e3:.2f} ms = {E / t_gen:.6e} elements/s "
        f"(peak {peak:.2f} GiB); fused residual (K3): {t_f * 1e3:.2f} ms = "
        f"{E / t_f:.6e} elements/s (first call with coefficients {t_first:.2f} s); "
        f"fused vs general rel L2 {rel:.3e}")
    if not (bool(torch.isfinite(r_f).all()) and rel <= 1e-5):
        raise AssertionError(f"fused residual disagrees with go.residual: {rel:.3e}")
    del r_gen
    torch.cuda.empty_cache()

    # at x = 0 only the source term is computed: hold K3's diffusion and
    # reaction terms at this size too, at a seeded random x (launches of
    # these comparisons are not counted)
    saved = sfk.launches
    gen = torch.Generator(device=dev).manual_seed(6)
    x = torch.randn(V.ndofs, generator=gen, dtype=torch.float32, device=dev)
    japply = make_fused_japply(go)
    for name, got, want in (
            ("residual", lambda: fused(x),
             lambda: go.residual(x) if nslabs == 1 else
             residual_slabbed(V, lop, cgm, x, nslabs=nslabs)),
            ("japply", lambda: japply(x), lambda: go.jacobian_apply(x0, x))):
        y_ref = want()
        err = float((got() - y_ref).abs().max())
        lim = 1e-5 * float(y_ref.abs().max())
        log(f"[phase 6a] fused {name} vs go at a random x: max abs err {err:.3e} "
            f"(limit {lim:.3e})")
        if not err <= lim:
            raise AssertionError(f"fused {name} disagrees with the general path")
        del y_ref
        torch.cuda.empty_cache()
    sfk.launches = saved
    del fused, japply, x
    torch.cuda.empty_cache()
    return r_f


def asm_direct(torch, pt, go, cells_small, dev):
    """Phase 6b: assemble_ell_direct at the full size: a first call, a
    second (nothing is cached, so it builds again) and one with check=True;
    and direct against probed values on a small mesh."""
    from dune_pdelab_tpu_torch.assembly.ell import (
        assemble_ell_device, assemble_ell_direct)

    x0 = go.space.zero(torch.float32, dev)
    torch.cuda.reset_peak_memory_stats()
    ell, first = timed(torch, lambda: assemble_ell_direct(go, x0))
    peak = torch.cuda.max_memory_allocated() / 2**30
    del ell
    ell, second = timed(torch, lambda: assemble_ell_direct(go, x0))
    del ell
    ell, checked = timed(torch, lambda: assemble_ell_direct(go, x0, check=True))
    gb = ell.values.numel() * ell.values.element_size() / 1e9
    log(f"[phase 6b] assemble_ell_direct {go.space.ndofs} DOFs: first call {first:.3f} s "
        f"(peak {peak:.2f} GiB), second {second:.3f} s, with check=True {checked:.3f} s "
        f"(passed: ELL apply vs jacobian_apply within 1e-5); values {gb:.3f} GB")
    del ell
    torch.cuda.empty_cache()

    _, _, _, gs = q1_operator(torch, pt, varcoeff_problem(), (cells_small,) * 3, dev)
    xs = gs.space.zero(torch.float32, dev)
    d = assemble_ell_direct(gs, xs).values
    p, t_probe = timed(torch, lambda: assemble_ell_device(gs, xs).values)
    err = float((d - p).abs().max())
    lim = 1e-6 * float(p.abs().max())
    log(f"[phase 6b] {cells_small}^3 cells: direct vs probed (27 jacobian_apply "
        f"sweeps, {t_probe:.3f} s) max abs {err:.3e} (limit {lim:.3e})")
    if not err <= lim:
        raise AssertionError("direct and probed ELL values disagree")


def asm_kernel(torch, cgm, dims, dev):
    """Phase 6c: ell27 against its plain version (fp32 at the full size,
    fp64 on a ragged lattice with a random mask), random values and z; the
    kernel, plain and cuSPARSE CSR times. Its launches are not counted."""
    import numpy as np
    from dune_pdelab_tpu_torch.kernels import ell27 as ek

    saved = ek.launches
    rng = np.random.default_rng(31)
    record = None
    for shape, dtype, tol in ((dims, torch.float32, 1e-6),
                              ((67, 45, 33), torch.float64, 1e-13)):
        nx, ny, nz = shape
        n = nx * ny * nz
        gen = torch.Generator(device=dev).manual_seed(int(rng.integers(2**31)))
        vals = torch.randn((27, nz, ny, nx), generator=gen, dtype=dtype, device=dev)
        z = torch.randn(n, generator=gen, dtype=dtype, device=dev)
        mask = (cgm.mask_on(dev) if shape == dims else
                torch.rand(n, generator=gen, device=dev) < 0.2)
        y = ek.ell27(vals, z, mask, shape)
        y_p = ek.ell27_reference(vals, z, mask, shape)
        err = float((y - y_p).abs().max())
        lim = tol * float(y_p.abs().max())
        tag = f"{nx}x{ny}x{nz} {str(dtype).replace('torch.', '')}"
        if not err <= lim:
            raise AssertionError(f"ell27 {tag}: max abs err {err:.3e} > {lim:.3e}")
        big = n > 10**7
        ms = cuda_ms(torch, lambda: ek.ell27(vals, z, mask, shape), 20 if big else 50)
        plain_ms = cuda_ms(torch, lambda: ek.ell27_reference(vals, z, mask, shape),
                           3 if big else 10)
        nbytes = (vals.numel() + 2 * n) * z.element_size() + n
        line = (f"[phase 6c] ell27 {tag}: max abs err {err:.3e} (max|y| "
                f"{float(y_p.abs().max()):.3e}), {ms:.4f} ms ({120 * n / ms / 1e6:.1f} "
                f"GB/s against 120 B/DOF), plain {plain_ms:.4f} ms")
        if shape == dims:
            del y, y_p
            torch.cuda.empty_cache()
            A, y_csr = csr_of(torch, vals, mask, z, shape)
            lib_ms = cuda_ms(torch, lambda: torch.mv(A, z), 20)
            d_csr = float((y_csr - ek.ell27(vals, z, mask, shape)).abs().max())
            record = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                      **bound(nbytes, 54 * n), "library_ms": lib_ms}
            line += (f", cuSPARSE CSR matvec {lib_ms:.4f} ms (nnz {A.values().numel()}, "
                     f"vs kernel max abs {d_csr:.3e}); bound {record['bound_ms']:.4f} ms "
                     f"({record['bound_by']}, {nbytes / n:.0f} B/DOF), kernel at "
                     f"{100 * record['bound_ms'] / ms:.1f}% of it")
            del A, y_csr
        log(line)
        del vals, z, mask
        torch.cuda.empty_cache()
    ek.launches = saved
    return record


def csr_of(torch, vals, mask, z, dims):
    """The same masked operator as a torch CSR matrix built on the card
    (int32 indices): unmasked rows keep their in-grid taps whose column is
    unmasked, masked rows are identity. Returns (A, A z)."""
    nx, ny, nz = dims
    n = nx * ny * nz
    dev = vals.device
    i = torch.arange(n, device=dev, dtype=torch.int64)
    x, y, zz = i % nx, (i // nx) % ny, i // (nx * ny)
    cols, keep = [], []
    for t in range(27):
        dz, dy, dx = t // 9 - 1, (t // 3) % 3 - 1, t % 3 - 1
        ok = ((x + dx >= 0) & (x + dx < nx) & (y + dy >= 0) & (y + dy < ny)
              & (zz + dz >= 0) & (zz + dz < nz))
        c = (i + dz * nx * ny + dy * nx + dx).clamp_(0, n - 1)
        ok &= ~mask & ~mask[c]
        ok |= mask & (t == 13)                   # identity on masked rows
        cols.append(c.to(torch.int32))
        keep.append(ok)
    del i, x, y, zz
    cols = torch.stack(cols, 1)                  # (n, 27), row-major
    keep = torch.stack(keep, 1)
    v = torch.where(mask[:, None], 1.0, vals.reshape(27, n).t())
    counts = keep.sum(1, dtype=torch.int32)
    crow = torch.zeros(n + 1, dtype=torch.int32, device=dev)
    crow[1:] = torch.cumsum(counts, 0, dtype=torch.int32)
    A = torch.sparse_csr_tensor(crow, cols[keep], v[keep], (n, n))
    del cols, keep, v
    torch.cuda.empty_cache()
    return A, torch.mv(A, z)


def asm_solve(torch, pt, go, b, cells_small, dev):
    """Phase 6d: LinearSolverBackend(cg, jacobi, matrix_free=False) at the
    full size (the ell27 kernel drives the loop), and its iteration count
    against the general-jvp tier on a small mesh."""
    from dune_pdelab_tpu_torch.solvers import LinearSolverBackend

    N = go.space.ndofs
    x0 = go.space.zero(torch.float32, dev)
    ls = LinearSolverBackend(solver="cg", precond="jacobi", matrix_free=False)
    (z, stats), first = timed(torch, lambda: ls.solve(go, x0, b, 1e-8))
    (z, stats), wall = timed(torch, lambda: ls.solve(go, x0, b, 1e-8))
    rep = ls.report(go)
    ell = ls._setup_cache[(id(go), "matval")]
    true_rel = float(torch.linalg.norm(b - ell(z)) / torch.linalg.norm(b))
    log(f"[phase 6d] assembled Jacobi-CG {N} DOFs: {stats.iterations} iterations in "
        f"{wall:.4f} s ({N / wall:.6e} DOFs/s, {1e3 * wall / stats.iterations:.4f} "
        f"ms/iteration), first solve with ELL assembly {first:.3f} s, converged "
        f"{bool(stats.converged)}, true rel defect {true_rel:.3e}\n{rep}")
    if "assembled EllMatrix [ell27 CUDA kernel]" not in rep:
        raise AssertionError("assembled solve did not take the ell27 tier")
    if not (bool(stats.converged) and bool(torch.isfinite(z).all()) and true_rel < 1e-2):
        raise AssertionError(f"assembled solve failed: {stats}, true rel {true_rel:.3e}")
    del z, ls, ell
    torch.cuda.empty_cache()

    # both tiers take the same Jacobi diagonal (go.jacobian_diagonal, the
    # same from call to call), so the counts compare the operators alone.
    # Iteration counts are held within 1 in fp32 to 1e-6 and fp64 to 1e-8.
    # fp32 to 1e-8 lies below fp32's attainable defect here, where the
    # count follows the two operators' rounding: it holds the solutions
    # (within 1e-5 relative) and logs the counts.
    _, _, _, gs = q1_operator(torch, pt, varcoeff_problem(), (cells_small,) * 3, dev)
    d = [gs.jacobian_diagonal(gs.space.zero(torch.float32, dev)) for _ in range(2)]
    if not torch.equal(d[0], d[1]):
        raise AssertionError("go.jacobian_diagonal differs between two calls")
    log("[phase 6d] go.jacobian_diagonal fp32 twice: equal bit for bit")
    for dtype, red, count_held in ((torch.float32, 1e-6, True),
                                   (torch.float64, 1e-8, True),
                                   (torch.float32, 1e-8, False)):
        xs = gs.space.zero(dtype, dev)
        bs = gs.residual(xs)
        its, sol = {}, {}
        for name, ls in (("assembled ELL", LinearSolverBackend(matrix_free=False)),
                         ("general-jvp", LinearSolverBackend(use_stencil=False))):
            (sol[name], s), w = timed(torch, lambda: ls.solve(gs, xs, bs, red))
            its[name] = s.iterations
            log(f"[phase 6d] {cells_small}^3 cells {str(dtype).replace('torch.', '')} "
                f"Jacobi-CG to {red:.0e} {name}: {s.iterations} iterations, {w:.3f} s; "
                f"{ls.report(gs).splitlines()[0]}")
        dz = float(torch.linalg.norm(sol["assembled ELL"] - sol["general-jvp"])
                   / torch.linalg.norm(sol["general-jvp"]))
        log(f"[phase 6d] {cells_small}^3 cells {str(dtype).replace('torch.', '')} to "
            f"{red:.0e}: iterations {its} ({'held within 1' if count_held else 'logged'}), "
            f"solutions rel L2 {dz:.3e}")
        if count_held and abs(its["assembled ELL"] - its["general-jvp"]) > 1:
            raise AssertionError(f"assembled vs matrix-free iterations {its}")
        if not dz <= 1e-5:
            raise AssertionError(f"assembled vs matrix-free solutions differ: {dz:.3e}")


def asm_ilu(torch, pt, dev):
    """Phase 6e: the config9_assembled_ilu golden through the port's
    ALL_CONFIGS in fp64 on the card, and SEQ_CG_ILU0 on the assembled-path
    problem next to Jacobi-CG."""
    from dune_pdelab_tpu_torch.linalg.ilu import ilu0_preconditioner
    from dune_pdelab_tpu_torch.models import ALL_CONFIGS
    from dune_pdelab_tpu_torch.solvers import LinearSolverBackend, SEQ_CG_ILU0

    golden = json.loads((ROOT / "tests" / "golden_parity.json").read_text())[
        "config9_assembled_ilu"]
    info = {}
    got, wall = timed(torch, lambda: ALL_CONFIGS["config9"](cells=C9_CELLS, device=dev,
                                                            info=info))
    l2, its = got["l2_error"], got["iterations"]
    rel = abs(l2 - golden["l2_error"]) / golden["l2_error"]
    log(f"[phase 6e] config9 {C9_CELLS}^3 fp64 (N = {got['ndofs']}): {its} iterations, L2 "
        f"{l2:.16e} (golden {golden['l2_error']:.16e}, rel {rel:.2e}), {wall:.2f} s; "
        f"{info['ls'].report(info['go']).splitlines()[0]}")
    if not (its == golden["iterations"] and got["ndofs"] == golden["ndofs"] and rel <= 1e-6):
        raise AssertionError("config9 golden mismatch")

    _, _, _, go = q1_operator(torch, pt, varcoeff_problem(), (ILU_CELLS,) * 3, dev)
    x0 = go.space.zero(torch.float32, dev)
    b = go.residual(x0)
    _, setup = timed(torch, lambda: ilu0_preconditioner(go, x0))
    ls = SEQ_CG_ILU0()
    (z, s), wall = timed(torch, lambda: ls.solve(go, x0, b, 1e-8))
    jac = LinearSolverBackend(matrix_free=False)
    (_, sj), wall_j = timed(torch, lambda: jac.solve(go, x0, b, 1e-8))
    log(f"[phase 6e] SEQ_CG_ILU0 {ILU_CELLS}^3 cells fp32 (N = {go.space.ndofs}): ILU "
        f"setup (ELL probing + factorization) {setup:.3f} s; solve {s.iterations} "
        f"iterations in {wall:.3f} s incl. setup (general-jvp operator), converged "
        f"{bool(s.converged)}; Jacobi-CG (assembled ELL) {sj.iterations} iterations "
        f"in {wall_j:.3f} s")
    if not (bool(s.converged) and bool(torch.isfinite(z).all())
            and s.iterations < sj.iterations):
        raise AssertionError("SEQ_CG_ILU0 failed or took no fewer iterations than Jacobi")


def phase_assembled(torch, pt, dev, record):
    """Phase 6: the assembled lattice-ELL path (bench.py:717-832) at 255^3
    cells fp32, plus the ILU backends; the ell27 comparison (6c) goes into
    `record`."""
    V, cgm, lop, go = q1_operator(torch, pt, varcoeff_problem(), (ASM_CELLS,) * 3, dev)
    log(f"[phase 6] assembled half: N = {V.ndofs}, E = {go.mesh.nelements}")
    b = asm_residuals(torch, pt, go, lop, cgm, ASM_CELLS, dev)
    asm_direct(torch, pt, go, ASM_SMALL, dev)
    record["ell27"] = asm_kernel(torch, cgm, V._dof_grid_dims, dev)
    asm_solve(torch, pt, go, b, ASM_SMALL, dev)
    del b, go, cgm, V
    torch.cuda.empty_cache()
    asm_ilu(torch, pt, dev)


def dg_operator(pt, cells, k, problem):
    """GridOperator of ConvectionDiffusionDG(problem) (SIPG) on the unit
    cube or square with QkDG(k). bench.py's DG problem (bench.py:851-853)
    is unit_source_problem(): f == 1, homogeneous Dirichlet data, imposed
    weakly (Nitsche)."""
    from dune_pdelab_tpu_torch.ops import ConvectionDiffusionDG
    dim = len(cells)
    mesh = pt.StructuredMesh([0] * dim, [1] * dim, cells)
    V = pt.FunctionSpace(mesh, pt.QkDGFEM(k, dim))
    return V, pt.GridOperator(V, ConvectionDiffusionDG(problem))


def block_work(cells, nb, es):
    """(bytes, operations) of one block-stencil apply: z read and y written
    once plus the 13 nb x nb weight blocks; an FMA counted as 2 per weight,
    for every tap whose neighbour lies in the grid and every boundary
    side's dD block on its face elements."""
    import numpy as np
    cells = [int(c) for c in cells]
    E = int(np.prod(cells))
    blocks = E                                       # centre tap
    for c in cells:
        blocks += 2 * (E // c) * (c - 1)             # -/+ neighbours
        blocks += 2 * (E // c)                       # dD on both sides
    return 2 * E * nb * es + 13 * nb * nb * es, 2 * nb * nb * blocks


def block_err(what, y, y_p):
    """Max abs error of the block stencil's y against its plain version
    y_p; raises unless y is finite and within BLOCK_TOL of max|y_p|."""
    err = float((y - y_p).abs().max())
    lim = BLOCK_TOL[str(y.dtype).replace("torch.", "")] * float(y_p.abs().max())
    if not (bool(y.isfinite().all()) and err <= lim):
        raise AssertionError(f"{what}: max abs err {err:.3e} > {lim:.3e}")
    return err


def conv_ms(torch, z, W, cells, reps):
    """Time of one TF32-off convolution with the block stencil's taps
    (nb -> nb channels, 3^dim kernel, padding 1, no dD) on z."""
    import torch.nn.functional as F
    nb = W.shape[-1]
    dim = len(cells)
    grid = tuple(reversed([int(c) for c in cells]))
    x = z.reshape(grid + (nb,)).movedim(-1, 0)[None].contiguous()
    K = torch.zeros((nb, nb) + (3,) * dim, dtype=z.dtype, device=z.device)
    from dune_pdelab_tpu_torch.kernels.blockstencil import TAP_ORDER
    for t, off in enumerate(TAP_ORDER[:2 * dim + 1]):
        K[(slice(None), slice(None)) + tuple(off[dim - 1 - s] + 1 for s in range(dim))] = W[t]
    conv = F.conv3d if dim == 3 else F.conv2d
    return cuda_ms(torch, lambda: conv(x, K, padding=1), reps)


def dg_kernels(torch, pt, dev):
    """Phase 7a: block_stencil_mm / block_stencil_em against their plain
    versions on the card, on SIPG weights; kernel, plain and convolution
    times against the bound. Returns the JSON records; its launches are
    not counted."""
    import numpy as np
    from dune_pdelab_tpu_torch.assembly.blockstencil import compile_block_stencil
    from dune_pdelab_tpu_torch.assembly.blockstencil_mm import try_mm_block_stencil
    from dune_pdelab_tpu_torch.kernels import blockstencil as bk

    saved = bk.launches_mm, bk.launches_em
    rng = np.random.default_rng(70)
    record = {}
    for cells, k, dtype_name, layouts, recorded in DG_KERNEL_CASES:
        dtype = getattr(torch, dtype_name)
        _, go = dg_operator(pt, cells, k, unit_source_problem())
        st = compile_block_stencil(go, dtype=torch.float64, device=dev)
        if st is None:
            raise AssertionError(f"compile_block_stencil declined at {cells}")
        W, dD = st.taps(dtype, dev)
        nb = st.nb
        z = torch.as_tensor(rng.standard_normal(st.ndofs), dtype=dtype, device=dev)
        path = bk.block_path(dtype, nb)
        tag = "x".join(map(str, cells)) + f" Q{k} nb={nb} {str(dtype).replace('torch.', '')}"
        big = st.ndofs > 10**7
        nbytes, flops = block_work(cells, nb, z.element_size())
        for layout in layouts:
            if layout == "mm":
                mm = try_mm_block_stencil(st)
                arg = mm.to_mm(z)
            else:
                arg = z
            fn = getattr(bk, f"block_stencil_{layout}")
            run = lambda: fn(arg, W, dD, cells)
            plain = lambda: getattr(bk, f"block_stencil_{layout}_reference")(arg, W, dD, cells)
            y, y_p, y2 = run(), plain(), run()
            torch.cuda.synchronize()
            err = block_err(f"block_stencil_{layout} {tag}", y, y_p)
            if not torch.equal(y, y2):
                raise AssertionError(f"block_stencil_{layout} {tag}: repeated launch differs")
            ms = cuda_ms(torch, run, 20 if big else 50)
            gms = "" if big else f", graph replay {graph_ms(torch, run, 200):.4f} ms"
            plain_ms = cuda_ms(torch, plain, 3 if big else 10)
            lib_ms = conv_ms(torch, z, W, cells, 10 if big else 30)
            b = bound(nbytes, flops)
            log(f"[phase 7a] block_stencil_{layout} {tag} ({path} "
                f"path): max abs err {err:.3e} (max|y| {float(y_p.abs().max()):.3e}), "
                f"repeat bit-equal, {ms:.4f} ms{gms} "
                f"({st.ndofs / ms / 1e6:.3f} Gdof/s), plain {plain_ms:.4f} ms, conv "
                f"{lib_ms:.4f} ms; bound {b['bound_ms']:.4f} ms ({b['bound_by']}), "
                f"kernel at {100 * b['bound_ms'] / ms:.1f}% of it")
            if layout == recorded:
                record[f"blockstencil_{layout}"] = {
                    "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **b,
                    "library_ms": lib_ms}
            del y, y_p, y2
        del z, arg, go, st
        torch.cuda.empty_cache()
    dg_kernel_limits(torch, bk, dev)
    bk.launches_mm, bk.launches_em = saved
    return record


def dg_kernel_limits(torch, bk, dev):
    """Phase 7a at BIG_NB_CASE: both layouts on random W, dD and z against
    their plain versions, a repeated launch bit-equal; and a z view off
    16-byte alignment refused."""
    import numpy as np
    cells, nb, dtype_name = BIG_NB_CASE
    dtype = getattr(torch, dtype_name)
    ch, rows = bk.shared_plan(dtype, nb)
    stages = -(-13 * nb // rows)
    if bk.block_path(dtype, nb) != "shared" or stages < 2:
        raise AssertionError(f"nb = {nb} would not stage its weights in parts")
    rng = np.random.default_rng(71)
    W = torch.as_tensor(rng.standard_normal((7, nb, nb)), dtype=dtype, device=dev)
    dD = torch.as_tensor(rng.standard_normal((3, 2, nb, nb)), dtype=dtype, device=dev)
    nx, ny, nz = cells
    grid = (nz, ny, nx, nb)
    z = torch.as_tensor(rng.standard_normal(grid), dtype=dtype, device=dev)
    for layout, arg in (("em", z.reshape(-1)), ("mm", z.permute(0, 3, 1, 2).contiguous())):
        fn = getattr(bk, f"block_stencil_{layout}")
        y, y_p, y2 = (fn(arg, W, dD, cells),
                      getattr(bk, f"block_stencil_{layout}_reference")(arg, W, dD, cells),
                      fn(arg, W, dD, cells))
        torch.cuda.synchronize()
        what = f"block_stencil_{layout} {'x'.join(map(str, cells))} nb={nb} {dtype_name}"
        err = block_err(what, y, y_p)
        if not torch.equal(y, y2):
            raise AssertionError(f"{what}: repeated launch differs")
        log(f"[phase 7a] {what} (random weights, shared path, {rows} of {13 * nb} "
            f"weight rows per stage, {stages} stages): max abs err {err:.3e} (max|y| "
            f"{float(y_p.abs().max()):.3e}), repeat bit-equal")
    off = torch.cat([z.reshape(-1)[:1], z.reshape(-1)])[1:]     # a view 1 element off
    try:
        bk.block_stencil_em(off, W, dD, cells)
    except ValueError as exc:
        if "16-byte" not in str(exc):
            raise
    else:
        raise AssertionError("block_stencil_em took a z off 16-byte alignment")
    log("[phase 7a] block_stencil_em refuses a z view off 16-byte alignment")


def dg_half(torch, pt, dev):
    """Phase 7b: bench.py's _dg_half at DG_CELLS^3 Q1 DG SIPG, fp32:
    compile_block_stencil (proxy branch), the mode-major apply timed, and
    the lowered operator against go.jacobian_apply at a random z."""
    from dune_pdelab_tpu_torch.assembly import stencil as stencil_mod
    from dune_pdelab_tpu_torch.assembly.blockstencil import compile_block_stencil
    from dune_pdelab_tpu_torch.assembly.blockstencil_mm import try_mm_block_stencil

    V, go = dg_operator(pt, (DG_CELLS,) * 3, 1, unit_source_problem())
    N = V.ndofs
    if not go.mesh.nelements > stencil_mod.PROXY_MIN_ELEMENTS:
        raise AssertionError("compile_block_stencil would not take the proxy branch")
    st, comp_s = timed(torch, lambda: compile_block_stencil(go))
    mm = try_mm_block_stencil(st)
    gen = torch.Generator(device=dev).manual_seed(7)
    z = torch.randn(N, generator=gen, dtype=torch.float32, device=dev)
    zmm = mm.to_mm(z)
    ms = cuda_ms(torch, lambda: mm.apply_mm(zmm), 20)
    y = mm(z)
    y_ref = go.jacobian_apply(torch.zeros_like(z), z)
    err = float((y - y_ref).abs().max())
    lim = 1e-4 * float(y_ref.abs().max())
    log(f"[phase 7b] dg half {DG_CELLS}^3 cells Q1 DG (N = {N}): compile_block_stencil "
        f"(proxy) {comp_s:.2f} s; mode-major apply {ms:.4f} ms = {N / ms / 1e6:.3f} "
        f"Gdof/s; lowered operator vs go.jacobian_apply max abs {err:.3e} "
        f"(limit {lim:.3e})")
    if not (bool(torch.isfinite(y).all()) and err <= lim):
        raise AssertionError("mode-major block stencil disagrees with go.jacobian_apply")


def dgmg_half(torch, pt, cells, dev, runs=1):
    """Phase 7c at cells^3: bench.py's _dgmg_half (bench.py:899-975):
    DGTwoLevel on the mode-major block stencil, a host PCG loop to 1e-8
    (bench.py:941-960), fp32; launches of the first timed run held against
    iterations x applies per iteration. Returns the iteration count and the
    ms per iteration of each of `runs` timed runs after one warm-up."""
    from dune_pdelab_tpu_torch.assembly.blockstencil import compile_block_stencil
    from dune_pdelab_tpu_torch.assembly.blockstencil_mm import try_mm_block_stencil
    from dune_pdelab_tpu_torch.kernels import blockstencil as bk
    from dune_pdelab_tpu_torch.kernels import stencil27 as sk
    from dune_pdelab_tpu_torch.linalg import DGTwoLevel
    from dune_pdelab_tpu_torch.ops import ConvectionDiffusionFEM

    p = unit_source_problem()
    V, go = dg_operator(pt, (cells,) * 3, 1, p)
    N = V.ndofs
    t0 = time.perf_counter()
    A = try_mm_block_stencil(compile_block_stencil(go))
    tl = DGTwoLevel(go, ConvectionDiffusionFEM(p))
    tl.setup(operator=A)
    b = -go.residual(V.zero(torch.float32))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    def run(bb, tol=1e-8, maxiter=60):
        x = torch.zeros_like(bb)
        r = bb
        z = tl.apply(r)
        pvec, rz = z, float(torch.dot(r, z))
        nb0 = float(torch.linalg.norm(bb))
        k, converged = 0, False
        while k < maxiter:
            Ap = A(pvec)
            alpha = rz / float(torch.dot(pvec, Ap))
            x = x + alpha * pvec
            r = r - alpha * Ap
            k += 1
            if float(torch.linalg.norm(r)) <= tol * nb0:
                converged = True
                break
            zv = tl.apply(r)
            rz_new = float(torch.dot(r, zv))
            pvec = zv + (rz_new / rz) * pvec
            rz = rz_new
        return x, k, converged

    run(b)                                        # warm-up
    torch.cuda.synchronize()
    gl = tl.gmg_lattice
    mm0, s27 = bk.launches_mm, sk.launches
    t0 = time.perf_counter()
    x, it, converged = run(b)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    got_mm, got_s27 = bk.launches_mm - mm0, sk.launches - s27
    ms_it = [1e3 * dt / max(it, 1)]
    for _ in range(runs - 1):
        t0 = time.perf_counter()
        run(b)
        torch.cuda.synchronize()
        ms_it.append(1e3 * (time.perf_counter() - t0) / max(it, 1))
    cycles = it if converged else it + 1
    # per V-cycle: 3 colour steps per sweep (the first one on z = 0 needs
    # no apply) and the residual before the coarse correction
    want_mm = it + cycles * 3 * (tl.pre + tl.post)
    want_s27 = cycles * (gl.nlevels - 1) * (gl.pre + gl.post + 1)
    true_rel = float(torch.linalg.norm(A(x) - b) / torch.linalg.norm(b))
    log(f"[phase 7c] dgmg {cells}^3 cells (N = {N}): setup {setup_s:.2f} s, {it} "
        f"iterations in {dt:.4f} s = {1e3 * dt / max(it, 1):.3f} ms/iteration, "
        f"converged {converged}, true rel residual {true_rel:.3e}; launches "
        f"blockstencil_mm {got_mm} (expected {want_mm}), stencil27 {got_s27} "
        f"(expected {want_s27}, {gl.nlevels} levels)")
    if not (converged and bool(torch.isfinite(x).all()) and true_rel < 1e-2):
        raise AssertionError(f"dgmg {cells}^3 failed")
    if (got_mm, got_s27) != (want_mm, want_s27):
        raise AssertionError(f"dgmg {cells}^3 launch counts {got_mm}, {got_s27} != "
                             f"{want_mm}, {want_s27}")
    del x, b, tl, A, go, V
    torch.cuda.empty_cache()
    return it, ms_it


def dg_goldens(torch, pt, dev):
    """Phase 7d: config3 (BiCGStab + Jacobi on the element-major block
    stencil) and config7 (CG + DGTwoLevel) through the port's ALL_CONFIGS in
    fp64 on the card, against tests/golden_parity.json and the JAX
    package's CPU numbers."""
    from dune_pdelab_tpu_torch.kernels import blockstencil as bk
    from dune_pdelab_tpu_torch.models import ALL_CONFIGS

    golden = json.loads((ROOT / "tests" / "golden_parity.json").read_text())
    want = golden["config3_convdiff_sipg"]
    for red in (1e-10, 1e-13):
        info = {}
        em0 = bk.launches_em
        got, wall = timed(torch, lambda: ALL_CONFIGS["config3"](reduction=red, device=dev,
                                                                info=info))
        l2, its = got["l2_error"], got["iterations"]
        rep = (info["ls"].report(info["go"]).splitlines()[0]
               + f"; block_stencil_em launches {bk.launches_em - em0}")
        ref = want["l2_error"] if red == 1e-10 else CONFIG3_L2_TIGHT
        rel = abs(l2 - ref) / ref
        log(f"[phase 7d] config3 fp64 to {red:.0e}: {its} BiCGStab steps, L2 {l2:.16e} "
            f"(rel {rel:.2e} to {'the golden' if red == 1e-10 else 'the JAX package at 1e-13'}"
            f"), {wall:.2f} s; {rep}")
        if "blockstencil CUDA kernel" not in rep or not got["converged"]:
            raise AssertionError("config3 did not run the element-major block stencil kernel")
        if red == 1e-10 and not (abs(its - want["iterations"]) <= CONFIG3_STEPS_BAND
                                 and rel <= CONFIG3_L2_BAND):
            raise AssertionError("config3 golden mismatch")
        if red == 1e-13 and not rel <= 1e-8:
            raise AssertionError("config3 converged L2 differs from the JAX package's")

    want = golden["config7_dg_twolevel"]
    em0 = bk.launches_em
    got, wall = timed(torch, lambda: ALL_CONFIGS["config7"](device=dev))
    l2, its = got["l2_error"], got["iterations"]
    rel = abs(l2 - want["l2_error"]) / want["l2_error"]
    log(f"[phase 7d] config7 fp64: {its} CG steps (the JAX package: {CONFIG7_STEPS}), L2 "
        f"{l2:.16e} (golden {want['l2_error']:.16e}, rel {rel:.2e}), {wall:.2f} s; "
        f"block_stencil_em launches {bk.launches_em - em0}")
    if not (got["converged"] and its == CONFIG7_STEPS and rel <= 1e-8):
        raise AssertionError("config7 golden mismatch")


def phase_dg(torch, pt, dev, record):
    """Phase 7: the DG path; the kernel comparison (7a) goes into
    `record`, uncounted."""
    record.update(dg_kernels(torch, pt, dev))
    dg_half(torch, pt, dev)
    torch.cuda.empty_cache()
    its = {n: dgmg_half(torch, pt, n, dev)[0] for n in DGMG_CELLS}
    if not its[DGMG_CELLS[-1]] <= its[DGMG_CELLS[0]] + 2:
        raise AssertionError(f"dgmg iterations not flat: {its}")
    dg_goldens(torch, pt, dev)


def sine3d_problem():
    """models/configs.py _Sine3D: -lap u = 3 pi^2 sin sin sin, u = 0 on the
    boundary."""
    import torch
    from dune_pdelab_tpu_torch.ops import ConvectionDiffusionProblem

    pi = math.pi

    class Sine3D(ConvectionDiffusionProblem):
        def exact(self, p):
            return torch.sin(pi * p[:, 0]) * torch.sin(pi * p[:, 1]) * torch.sin(pi * p[:, 2])

        def f(self, x):
            return 3 * pi**2 * (torch.sin(pi * x[..., 0]) * torch.sin(pi * x[..., 1])
                                * torch.sin(pi * x[..., 2]))
    return Sine3D()


def gmg_poisson(torch, pt, cells, dev):
    """(V, go, GeometricMultigrid, problem) of 3D Poisson Q2 on the unit
    cube (config2_poisson_3d_gmg, models/configs.py:66-82)."""
    from dune_pdelab_tpu_torch.linalg.multigrid import GeometricMultigrid
    from dune_pdelab_tpu_torch.ops import ConvectionDiffusionFEM

    p = sine3d_problem()
    mesh = pt.StructuredMesh([0.0] * 3, [1.0] * 3, (cells,) * 3)
    fem = pt.QkFEM(2, 3)
    V = pt.FunctionSpace(mesh, fem)
    go = pt.GridOperator(V, ConvectionDiffusionFEM(p),
                         constraints=pt.constraints(p.dirichlet_bctype(), V, device=dev))
    gmg = GeometricMultigrid(ConvectionDiffusionFEM(p), mesh, fem,
                             bctype=p.dirichlet_bctype(), device=dev)
    return V, go, gmg, p


def gmg_solve(torch, pt, cells, dev, instrument=False):
    """Phase 8a at cells^3: CG + GeometricMultigrid (Jacobi smoother) on 3D
    Poisson Q2, fp32, to 1e-8. With `instrument`, the same solve again with
    every jacobian_apply (the fine operator's and each level's) timed
    between two device syncs, for the share of the solve spent there, and
    one fine apply's wall time against its device time (torch.profiler).
    Returns the iteration count."""
    from dune_pdelab_tpu_torch.solvers import LinearSolverBackend

    (V, go, gmg, _), build_s = timed(torch, lambda: gmg_poisson(torch, pt, cells, dev))
    N = V.ndofs
    x0 = V.zero(torch.float32, dev)
    b = go.residual(x0)
    ls = LinearSolverBackend(solver="cg", precond=gmg)
    _, setup_s = timed(torch, lambda: gmg(go, x0, 0.0))
    (z, st), wall = timed(torch, lambda: ls.solve(go, x0, b, 1e-8))
    true_rel = float(torch.linalg.norm(b - go.jacobian_apply(x0, z)) / torch.linalg.norm(b))
    log(f"[phase 8a] 3D Q2 {cells}^3 cells (N = {N}, {gmg.nlevels} levels): CG + "
        f"GeometricMultigrid fp32 to 1e-8: {st.iterations} iterations in {wall:.4f} s = "
        f"{1e3 * wall / max(st.iterations, 1):.3f} ms/iteration, converged "
        f"{bool(st.converged)}, true rel defect {true_rel:.3e} (fp32); hierarchy "
        f"{build_s:.2f} s, setup {setup_s:.2f} s")
    # fp32 cannot go below about eps32 * cond(A) in the true defect
    if not (bool(st.converged) and bool(torch.isfinite(z).all()) and true_rel < 1e-3):
        raise AssertionError(f"CG + GeometricMultigrid at {cells}^3 failed: {st}, "
                             f"true rel {true_rel:.3e}")
    if instrument:
        spent = {"s": 0.0, "n": 0}

        def timed_apply(f):
            def apply(*a, **k):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = f(*a, **k)
                torch.cuda.synchronize()
                spent["s"] += time.perf_counter() - t0
                spent["n"] += 1
                return out
            return apply

        ops = [go] + gmg.gos
        for g in ops:
            g.jacobian_apply = timed_apply(g.jacobian_apply)
        (_, st2), wall2 = timed(torch, lambda: ls.solve(go, x0, b, 1e-8))
        for g in ops:
            del g.jacobian_apply
        w_ms, dev_ms, all_ms = device_ms(torch, lambda: go.jacobian_apply(x0, b), 5)
        log(f"[phase 8a] {cells}^3 instrumented solve {wall2:.4f} s ({st2.iterations} "
            f"iterations): {spent['n']} jacobian_apply calls {spent['s']:.4f} s = "
            f"{100 * spent['s'] / wall2:.1f}% of it; one fine jacobian_apply "
            f"{w_ms:.3f} ms wall, {dev_ms:.3f} ms device time (torch.profiler kernel "
            f"rows; all rows {all_ms:.3f}, which counts each kernel twice)")
        if st2.iterations != st.iterations:
            raise AssertionError("the instrumented solve took other iterations")
    del z, b, ls, gmg, go, V
    torch.cuda.empty_cache()
    return st.iterations


def gmg_config2(torch, pt, dev):
    """Phase 8b: the config2_poisson_3d_gmg golden at C2_CELLS^3 through the
    port's ALL_CONFIGS in fp64."""
    from dune_pdelab_tpu_torch.models import ALL_CONFIGS

    want = json.loads((ROOT / "tests" / "golden_parity.json").read_text())[
        "config2_poisson_3d_gmg"]
    got, wall = timed(torch, lambda: ALL_CONFIGS["config2"](cells=C2_CELLS, device=dev))
    l2, its = got["l2_error"], got["iterations"]
    rel = abs(l2 - want["l2_error"]) / want["l2_error"]
    log(f"[phase 8b] config2 fp64 {C2_CELLS}^3 (ndofs {got['ndofs']}): {its} CG iterations "
        f"on {got['levels']} levels, L2 {l2:.16e} (golden {want['l2_error']:.16e}, rel "
        f"{rel:.2e}), {wall:.2f} s")
    if not (got["converged"] and its == want["iterations"] and got["levels"] == want["levels"]
            and got["ndofs"] == want["ndofs"] and rel <= 1e-8):
        raise AssertionError("config2 golden mismatch")


def gmg_dg_two_level(torch, pt, dev):
    """Phase 8c: DGTwoLevel with gmg_kwargs (GeometricMultigrid on the Q1
    subspace) against the default path (LatticeGMG) on 2D Q1 SIPG at
    DGGMG_CELLS^2, fp64, CG to 1e-10 on the general-jvp tier."""
    from dune_pdelab_tpu_torch.linalg import DGTwoLevel
    from dune_pdelab_tpu_torch.linalg.multigrid import GeometricMultigrid
    from dune_pdelab_tpu_torch.ops import ConvectionDiffusionFEM
    from dune_pdelab_tpu_torch.solvers import LinearSolverBackend

    p = unit_source_problem()
    V, go = dg_operator(pt, (DGGMG_CELLS,) * 2, 1, p)
    b = go.residual(V.zero(torch.float64, dev))
    its, sols = {}, {}
    for name, kw in (("LatticeGMG", None),
                     ("GeometricMultigrid", {"pre_sweeps": 2, "post_sweeps": 2})):
        tl = DGTwoLevel(go, ConvectionDiffusionFEM(p), gmg_kwargs=kw, device=dev)
        if (tl.gmg_lattice is None) != (kw is not None) or (
                kw is not None and not isinstance(tl.gmg, GeometricMultigrid)):
            raise AssertionError(f"DGTwoLevel took the wrong coarse solve for {name}")
        ls = LinearSolverBackend(solver="cg", precond=tl, use_stencil=False)
        (sols[name], s), wall = timed(torch, lambda: ls.solve(
            go, V.zero(torch.float64, dev), b, 1e-10))
        its[name] = s.iterations
        log(f"[phase 8c] DGTwoLevel coarse {name} on {DGGMG_CELLS}^2 Q1 SIPG (N = "
            f"{V.ndofs}) fp64: {s.iterations} CG iterations, converged "
            f"{bool(s.converged)}, {wall:.2f} s")
        if not bool(s.converged):
            raise AssertionError(f"DGTwoLevel with {name} did not converge")
    dz = float(torch.linalg.norm(sols["LatticeGMG"] - sols["GeometricMultigrid"])
               / torch.linalg.norm(sols["LatticeGMG"]))
    log(f"[phase 8c] iterations {its}; solutions rel L2 {dz:.3e}")
    if not dz <= 1e-8:
        raise AssertionError(f"the two DGTwoLevel paths disagree: {dz:.3e}")


def phase_gmg(torch, pt, dev):
    """Phase 8: geometric multigrid on re-discretised levels (the general
    GridOperator: no hand kernel on the level applies)."""
    its = {n: gmg_solve(torch, pt, n, dev, instrument=n == GMG_CELLS[-1])
           for n in GMG_CELLS}
    if not its[GMG_CELLS[-1]] <= its[GMG_CELLS[0]] + 2:
        raise AssertionError(f"GeometricMultigrid iterations not flat: {its}")
    gmg_config2(torch, pt, dev)
    gmg_dg_two_level(torch, pt, dev)


def heat_problem(dim):
    """du/dt - lap u = f with u = exp(-t) prod_d sin(pi x_d) (the heat
    problem of models/configs.py:113-145 in `dim` dimensions)."""
    import torch
    from dune_pdelab_tpu_torch.ops import ConvectionDiffusionProblem

    pi = math.pi

    def s(x):
        out = torch.sin(pi * x[..., 0])
        for d in range(1, dim):
            out = out * torch.sin(pi * x[..., d])
        return out

    class Heat(ConvectionDiffusionProblem):
        def u_exact(self, t):
            return lambda p: math.exp(-t) * s(p)

        def f(self, x):
            return (dim * pi**2 - 1.0) * math.exp(-self.time) * s(x)
    return Heat()


def heat_run(torch, pt, dim, cells, dtype, dev, matrix_free, steps=10, dt=0.02, tag=""):
    """Crank-Nicolson + Newton (reduction 1e-9) with Jacobi-CG per stage,
    `steps` steps of dt (config4's recipe). Returns (L2 error at the end,
    Newton iterations, per-step records)."""
    from dune_pdelab_tpu_torch.instationary import OneStepMethod, crank_nicolson
    from dune_pdelab_tpu_torch.ops import L2, ConvectionDiffusionFEM
    from dune_pdelab_tpu_torch.solvers import LinearSolverBackend
    from dune_pdelab_tpu_torch.solvers import linear as linear_mod
    from dune_pdelab_tpu_torch.space.functions import l2_difference

    p = heat_problem(dim)
    V = pt.FunctionSpace(pt.StructuredMesh([0.0] * dim, [1.0] * dim, (cells,) * dim),
                         pt.QkFEM(1, dim))
    cgm = pt.constraints(p.dirichlet_bctype(), V, device=dev)
    go0 = pt.GridOperator(V, ConvectionDiffusionFEM(p), constraints=cgm)
    go1 = pt.GridOperator(V, L2(), constraints=cgm)
    ls = LinearSolverBackend(solver="cg", precond="jacobi", matrix_free=matrix_free)
    osm = OneStepMethod(crank_nicolson(), go0, go1, ls, pdesolver="newton", reduction=1e-9)
    x = V.interpolate(p.u_exact(0.0), dtype=dtype, device=dev)
    asm = {"s": 0.0, "first": None}
    assemble = linear_mod.assemble_ell

    def timed_assemble(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = assemble(*a, **k)
        torch.cuda.synchronize()
        asm["s"] += time.perf_counter() - t0
        if asm["first"] is None:
            asm["first"] = out
        return out

    linear_mod.assemble_ell = timed_assemble
    steps_rec = []
    t = 0.0
    try:
        for _ in range(steps):
            n0, l0, a0 = (osm.result.total_newton_iterations,
                          osm.result.total_linear_iterations, asm["s"])
            x, wall = timed(torch, lambda: osm.apply(t, dt, x))
            t += dt
            res = osm.pdesolver.result
            steps_rec.append((osm.result.total_newton_iterations - n0,
                              osm.result.total_linear_iterations - l0, wall,
                              asm["s"] - a0, res.defect / res.first_defect, res.defect))
    finally:
        linear_mod.assemble_ell = assemble
    l2 = float(l2_difference(V, x, p.u_exact(t)))
    return (l2, osm.result.total_newton_iterations, steps_rec, ls.report(), V.ndofs,
            asm["first"])


def ell_check(torch, mat, tag, dev):
    """ell27 against its plain version on an EllMatrix a solve assembled
    (its values, mask and lattice), with a random z: on the unconstrained
    rows the max abs error within 1e-13 of their max|y| (fp64), on the
    constrained rows y equal to z. Its launches are not counted."""
    from dune_pdelab_tpu_torch.kernels import ell27 as ek

    if mat is None or not mat.uses_ell27:
        raise AssertionError(f"{tag}: no lattice ELL was assembled")
    saved = ek.launches
    n = math.prod(mat.dims)
    gen = torch.Generator(device=dev).manual_seed(17)
    z = torch.randn(n, generator=gen, dtype=mat.values.dtype, device=dev)
    y = ek.ell27(mat.values, z, mat.mask, mat.dims)
    y_p = ek.ell27_reference(mat.values, z, mat.mask, mat.dims)
    ek.launches = saved
    free = ~mat.mask
    err = float((y - y_p)[free].abs().max())
    scale = float(y_p[free].abs().max())
    fixed_ok = bool(torch.equal(y[mat.mask], z[mat.mask]))
    log(f"[{tag}] ell27 on the assembled {'x'.join(map(str, mat.dims))} "
        f"{str(mat.values.dtype).replace('torch.', '')} ELL, random z: unconstrained "
        f"rows max abs err {err:.3e} (their max|y| {scale:.3e}, limit 1e-13 of it), "
        f"constrained rows equal to z: {fixed_ok}")
    if not (err <= 1e-13 * scale and fixed_ok):
        raise AssertionError(f"{tag}: ell27 disagrees with its plain version")


def newton_heat(torch, pt, dev):
    """Phase 9a: 3D Q1 heat at HEAT_CELLS^3, fp64, Crank-Nicolson + Newton
    with LinearSolverBackend(cg, jacobi, matrix_free=False): the stage
    operator's lattice ELL is assembled again at each Newton step and every
    Krylov apply is the ell27 kernel."""
    l2, nits, rec, rep, N, first = heat_run(torch, pt, 3, HEAT_CELLS, torch.float64, dev,
                                            matrix_free=False, steps=HEAT_STEPS)
    ell_check(torch, first, "phase 9a", dev)
    del first
    wall = sum(r[2] for r in rec)
    asm = sum(r[3] for r in rec)
    for i, (nn, nl, w, a, red, d) in enumerate(rec):
        log(f"[phase 9a] step {i + 1}: {nn} Newton, {nl} CG iterations, {w:.3f} s "
            f"(ELL assembly {a:.3f} s), defect {d:.3e} = {red:.3e} of the first")
    log(f"[phase 9a] heat 3D Q1 {HEAT_CELLS}^3 cells (N = {N}) fp64, CN + Newton, "
        f"{len(rec)} steps of 0.02: {nits} Newton and {sum(r[1] for r in rec)} CG "
        f"iterations, {wall / len(rec):.3f} s/step, ELL assembly {100 * asm / wall:.1f}% "
        f"of it; L2 error at t = {0.02 * len(rec):.2f}: {l2:.6e}\n{rep}")
    if "assembled EllMatrix [ell27 CUDA kernel]" not in rep:
        raise AssertionError("phase 9a did not take the ell27 tier")
    # Newton stops at 1e-9 of the first defect or at its absolute limit
    # 1e-12; a wrong Jacobian would still reach it, in more iterations
    if not (all(r[4] <= 1e-9 or r[5] <= 1e-12 for r in rec) and l2 < HEAT_L2_MAX
            and all(r[0] <= HEAT_NEWTON_MAX for r in rec)):
        raise AssertionError(f"heat run failed: L2 {l2:.3e}, reductions "
                             f"{[r[4] for r in rec]}, Newton {[r[0] for r in rec]}")


def newton_config4(torch, pt, dev):
    """Phase 9b: the config4_heat_theta_newton golden (2D 16^2 Q1, fp64,
    general-jvp tier) through the port's ALL_CONFIGS on the card."""
    from dune_pdelab_tpu_torch.models import ALL_CONFIGS

    want = json.loads((ROOT / "tests" / "golden_parity.json").read_text())[
        "config4_heat_theta_newton"]
    info = {}
    got, wall = timed(torch, lambda: ALL_CONFIGS["config4"](device=dev, info=info))
    l2, nits = got["l2_error"], got["newton_iterations"]
    rel = abs(l2 - want["l2_error"]) / want["l2_error"]
    log(f"[phase 9b] config4 fp64 (ndofs {got['ndofs']}): {nits} Newton iterations, L2 "
        f"{l2:.16e} (golden {want['l2_error']:.16e}, rel {rel:.2e}), {wall:.2f} s; "
        f"{info['ls'].report().splitlines()[0]}")
    if not (nits == want["newton_iterations"] and got["ndofs"] == want["ndofs"]
            and rel <= 1e-8):
        raise AssertionError("config4 golden mismatch")


def nonlinear_poisson(pt, dim, cells, dev):
    """(V, go, x0, u_exact) of -lap u + u^3 = f (examples/03_nonlinear_newton.py
    in `dim` dimensions): u = prod_d sin(pi x_d) + 0.5."""
    import torch
    from dune_pdelab_tpu_torch.ops import LocalOperator

    pi = math.pi

    def s(x):
        out = torch.sin(pi * x[..., 0])
        for d in range(1, dim):
            out = out * torch.sin(pi * x[..., d])
        return out

    class NonlinearPoisson(LocalOperator):
        def alpha_volume(self, ctx, u):
            tab = ctx.tab
            return (self.accumulate_gradient(tab, ctx.factor, self.gradient_at_qp(tab, u))
                    + self.accumulate_value(tab, ctx.factor, self.value_at_qp(tab, u) ** 3))

        def lambda_volume(self, ctx):
            sx = s(ctx.x)
            f = dim * pi**2 * sx + (sx + 0.5) ** 3
            return self.accumulate_value(ctx.tab, ctx.factor, -f)

    V = pt.FunctionSpace(pt.StructuredMesh([0.0] * dim, [1.0] * dim, (cells,) * dim),
                         pt.QkFEM(1, dim))
    cgm = pt.constraints(True, V, device=dev)
    go = pt.GridOperator(V, NonlinearPoisson(), constraints=cgm)
    u_exact = lambda p: s(p) + 0.5
    x0 = pt.interpolate_dirichlet(u_exact, V, cgm, V.zero(torch.float64, dev))
    return V, go, x0, u_exact


def newton_nonlinear(torch, pt, dev):
    """Phase 9c: Newton on -lap u + u^3 = f in 3D Q1 at NL_CELLS^3, fp64,
    LinearSolverBackend(cg, jacobi, matrix_free=False) (the ELL assembled at
    each linearization point, the ell27 kernel in every Krylov apply); then
    assemble_ell_direct of the nonlinear operator against colored probing
    at a random linearization point at NL_SMALL^3."""
    from dune_pdelab_tpu_torch.assembly.ell import assemble_ell, assemble_ell_direct
    from dune_pdelab_tpu_torch.solvers import LinearSolverBackend, NewtonMethod
    from dune_pdelab_tpu_torch.solvers import linear as linear_mod
    from dune_pdelab_tpu_torch.space.functions import l2_difference

    V, go, x0, u_exact = nonlinear_poisson(pt, 3, NL_CELLS, dev)
    ls = LinearSolverBackend(solver="cg", precond="jacobi", matrix_free=False)
    newton = NewtonMethod(go, ls, reduction=1e-10, verbose=0)
    defects, assembled = [], []
    line_search = newton._line_search

    def recorded(*a):
        out = line_search(*a)
        defects.append(out[1])
        return out

    def recorded_assembly(*a, **k):
        out = assemble(*a, **k)
        if not assembled:
            assembled.append(out)
        return out

    newton._line_search = recorded
    assemble = linear_mod.assemble_ell
    linear_mod.assemble_ell = recorded_assembly
    try:
        x, wall = timed(torch, lambda: newton.apply(x0))
    finally:
        linear_mod.assemble_ell = assemble
    res = newton.result
    l2 = float(l2_difference(V, x, u_exact))
    log(f"[phase 9c] -lap u + u^3 = f, 3D Q1 {NL_CELLS}^3 cells (N = {V.ndofs}) fp64: "
        f"{res.iterations} Newton iterations ({res.assemblies} assemblies, "
        f"{res.linear_solver_iterations} CG iterations) in {wall:.2f} s, first defect "
        f"{res.first_defect:.6e}, defect per step "
        f"{', '.join(f'{d:.3e}' for d in defects)}, L2 error {l2:.6e}; "
        f"{ls.report(go).splitlines()[0]}")
    if not (res.converged and l2 < NL_L2_MAX and res.iterations == NL_NEWTON):
        raise AssertionError("nonlinear Newton at full size failed")
    if "assembled EllMatrix [ell27 CUDA kernel]" not in ls.report(go):
        raise AssertionError("phase 9c did not take the ell27 tier")
    ell_check(torch, assembled[0], "phase 9c", dev)
    del x, x0, go, V, ls, assembled
    torch.cuda.empty_cache()

    V, go, _, _ = nonlinear_poisson(pt, 3, NL_SMALL, dev)
    gen = torch.Generator(device=dev).manual_seed(9)
    x_lin = 0.5 + 0.1 * torch.randn(V.ndofs, generator=gen, dtype=torch.float64, device=dev)
    direct, t_direct = timed(torch, lambda: assemble_ell_direct(go, x_lin=x_lin))
    probed, t_probed = timed(torch, lambda: assemble_ell(go, x_lin=x_lin))
    scale = float(probed.values.abs().max())
    err = float((direct.values - probed.values).abs().max())
    log(f"[phase 9c] nonlinear assemble_ell_direct {NL_SMALL}^3 at a random x_lin: "
        f"{t_direct:.3f} s, probed {t_probed:.3f} s, max abs diff {err:.3e} "
        f"({err / scale:.2e} of max |value|)")
    if not err <= 1e-12 * scale:
        raise AssertionError("nonlinear direct ELL disagrees with probing")


def phase_newton(torch, pt, dev):
    """Phase 9: Newton and one-step time stepping."""
    newton_heat(torch, pt, dev)
    torch.cuda.empty_cache()
    newton_config4(torch, pt, dev)
    newton_nonlinear(torch, pt, dev)

# -- phase 10: composite spaces and Taylor-Hood (Navier-)Stokes ---------------
def _a4(x):
    return x**2 * (1 - x) ** 2


def _da4(x):
    return 2 * x * (1 - x) * (1 - 2 * x)


def _dda4(x):
    return 12 * x**2 - 12 * x + 2


def _ddda4(x):
    return 24 * x - 12


def stokes_params(base, f, mu=1.0, rho=0.0):
    """A NavierStokesParameters of `base` class with body force f(x)."""
    class P(base):
        pass
    P.f = lambda self, x: f(x)
    return P(mu=mu, rho=rho)


def stokes_f3d(x):
    """tests/test_stokes3d.py _f_stokes: -lap u + grad p of the div-free
    u = curl(0, 0, a(x) a(y) a(z)), p = x^3 + y^3 + z^3 - 3/4 (mu = 1)."""
    import torch
    xx, yy, zz = x[..., 0], x[..., 1], x[..., 2]
    lap1 = (_dda4(xx) * _da4(yy) * _a4(zz) + _a4(xx) * _ddda4(yy) * _a4(zz)
            + _a4(xx) * _da4(yy) * _dda4(zz))
    lap2 = -(_ddda4(xx) * _a4(yy) * _a4(zz) + _da4(xx) * _dda4(yy) * _a4(zz)
             + _da4(xx) * _a4(yy) * _dda4(zz))
    return torch.stack([-lap1 + 3 * xx**2, -lap2 + 3 * yy**2, 3 * zz**2], dim=-1)


def stokes_u3d(p):
    import torch
    x, y, z = p[:, 0], p[:, 1], p[:, 2]
    return torch.stack([_a4(x) * _da4(y) * _a4(z), -_da4(x) * _a4(y) * _a4(z),
                        torch.zeros_like(x)], dim=-1)


def stokes_f2d(x):
    """tests/test_stokes.py ManufacturedStokes.f (mu = 1)."""
    import torch
    xx, yy = x[..., 0], x[..., 1]
    f1 = -(_dda4(xx) * _da4(yy) + _a4(xx) * _ddda4(yy)) + 3 * xx**2
    f2 = (_ddda4(xx) * _a4(yy) + _da4(xx) * _dda4(yy)) + 3 * yy**2
    return torch.stack([f1, f2], dim=-1)


def stokes_u2d(p):
    import torch
    x, y = p[:, 0], p[:, 1]
    return torch.stack([_a4(x) * _da4(y), -_da4(x) * _a4(y)], dim=-1)


def velocity_l2(W, x, exact):
    """L2 error of the velocity components of a Taylor-Hood vector."""
    from dune_pdelab_tpu_torch.space.functions import l2_difference

    V = W.children[0]
    err2 = 0.0
    for c in range(V.k):
        err2 += float(l2_difference(V.child, V.restrict(W.restrict(x, 0), c),
                                    lambda p, c=c: exact(p)[:, c])) ** 2
    return math.sqrt(err2)


def synced_timer(torch, spent, key, f):
    """f wrapped so that each call adds its wall time between two device
    syncs to spent[key] = [seconds, calls]; a call made while a CUDA graph
    is being captured (solvers/linear.py GraphedApply) runs unsynced and
    uncounted."""
    def call(*a, **k):
        if torch.cuda.is_current_stream_capturing():
            return f(*a, **k)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = f(*a, **k)
        torch.cuda.synchronize()
        spent[key][0] += time.perf_counter() - t0
        spent[key][1] += 1
        return out
    return call


def device_ms(torch, fn, reps):
    """(wall ms, device ms, all-rows ms) per call of fn(): wall from synced
    timers; device time summed over torch.profiler's CUDA kernel rows
    only; all-rows: the sum over every row of key_averages() (the CPU
    operator rows repeat their kernels' device time)."""
    from torch.autograd import DeviceType

    _, wall = timed(torch, lambda: [fn() for _ in range(reps)])
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = prof.key_averages()
    kern = sum(e.self_device_time_total for e in rows if e.device_type == DeviceType.CUDA)
    every = sum(getattr(e, "self_device_time_total", 0.0) for e in rows)
    return 1e3 * wall / reps, kern / 1e3 / reps, every / 1e3 / reps


def stokes3d(torch, pt, cells, dev, instrument=False, dtype=None):
    """Phase 10a at cells^3: the 3D Taylor-Hood problem of
    tests/test_stokes3d.py:71-103 (unpinned pressure, triangular
    StokesGMGSchur, GMRES(100)) in fp32 (or `dtype`) to a reduction of 1e-6. With
    `instrument`, the solve again with the Taylor-Hood jacobian_apply,
    the velocity V-cycles and the pressure-mass Chebyshev timed between
    device syncs, and one apply of each against its device time.
    Returns (iterations, velocity L2 error)."""
    from dune_pdelab_tpu_torch.ops import NavierStokesParameters, TaylorHoodNavierStokes
    from dune_pdelab_tpu_torch.solvers import LinearSolverBackend
    from dune_pdelab_tpu_torch.solvers.stokes import (
        StokesGMGSchur, stokes_constraints, taylor_hood_space,
    )

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    def build():
        W = taylor_hood_space(pt.StructuredMesh([0.0] * 3, [1.0] * 3, (cells,) * 3), 2)
        go = pt.GridOperator(W, TaylorHoodNavierStokes(
            stokes_params(NavierStokesParameters, stokes_f3d)),
            constraints=stokes_constraints(W, pin_pressure=False, device=dev))
        return W, go, StokesGMGSchur(W, mu=1.0, triangular=True, device=dev)

    (W, go, pre), setup_s = timed(torch, build)
    if pre._vgmg is None:
        raise AssertionError("phase 10a: StokesGMGSchur fell back to diagonal Jacobi")
    ls = LinearSolverBackend(solver="gmres", precond=pre, restart=100, maxiter=2000)
    slp = pt.StationaryLinearProblemSolver(go, ls, reduction=1e-6, verbose=0)
    dtype = dtype or torch.float32
    x0 = W.zero(dtype, dev)
    x, wall = timed(torch, lambda: slp.apply(x0))
    its = slp.result.linear_solver_iterations
    peak = torch.cuda.max_memory_allocated() / 2**30
    x64 = x.double()
    red = float(ls.stats_history[-1].reduction)
    true_rel = float(torch.linalg.norm(go.residual(x64))
                     / torch.linalg.norm(go.residual(torch.zeros_like(x64))))
    l2 = velocity_l2(W, x64, stokes_u3d)
    prec = str(dtype).replace("torch.float", "fp")
    log(f"[phase 10a] ({CARD}) 3D Taylor-Hood Q2/Q1 {cells}^3 cells (N = {W.ndofs}, "
        f"{pre._vgmg.nlevels} velocity levels) {prec}, StokesGMGSchur GMRES(100) to 1e-6: "
        f"{its} iterations in {wall:.3f} s = {1e3 * wall / max(its, 1):.2f} ms/iteration, "
        f"converged {slp.result.converged} (recomputed preconditioned defect reduction "
        f"{red:.3e}); setup {setup_s:.2f} s; true rel residual "
        f"{true_rel:.3e} (fp64); velocity L2 error {l2:.6e}; peak memory {peak:.2f} GiB")
    # fp64: GMRES's own flag. fp32: the flag compares the recomputed
    # preconditioned defect with 1e-6 and reads False (the recurrence
    # reached 1e-6, the recomputed defect ends above it), so that
    # recomputed reduction is held to STOKES_PREC_RED32 instead
    if dtype == torch.float64:
        ok, bound_rel = slp.result.converged, STOKES_TRUE_REL64
    else:
        ok, bound_rel = red <= STOKES_PREC_RED32, STOKES_TRUE_REL * max(1.0, (cells / 32) ** 2)
    if not (ok and true_rel <= bound_rel and math.isfinite(l2)):
        raise AssertionError(f"phase 10a at {cells}^3 {prec} failed: {its} iterations, "
                             f"true rel {true_rel:.3e} (bound {bound_rel:.1e})")
    if instrument:
        spent = {"jacobian_apply": [0.0, 0], "V-cycles": [0.0, 0], "mass Chebyshev": [0.0, 0]}
        go.jacobian_apply = synced_timer(torch, spent, "jacobian_apply", go.jacobian_apply)
        pre._vgmg.apply = synced_timer(torch, spent, "V-cycles", pre._vgmg.apply)
        pre._mass_solve = synced_timer(torch, spent, "mass Chebyshev", pre._mass_solve)
        try:
            _, wall2 = timed(torch, lambda: slp.apply(x0))
        finally:
            del go.jacobian_apply, pre._vgmg.apply, pre._mass_solve
        if slp.result.linear_solver_iterations != its:
            raise AssertionError("phase 10a: the instrumented solve took other iterations")
        rest = wall2 - sum(v[0] for v in spent.values())
        log(f"[phase 10a] ({CARD}) {cells}^3 instrumented solve {wall2:.3f} s: "
            + ", ".join(f"{k} {v[0]:.3f} s ({v[1]} calls, {100 * v[0] / wall2:.1f}%)"
                        for k, v in spent.items())
            + f", the rest (GMRES, residual) {rest:.3f} s ({100 * rest / wall2:.1f}%)")
        gen = torch.Generator(device=dev).manual_seed(10)
        z = torch.randn(W.ndofs, generator=gen, device=dev)
        rb = torch.randn((3, pre.nv), generator=gen, device=dev)
        st = pre._vgmg.stencils[0]
        for name, fn in (("Taylor-Hood jacobian_apply", lambda: go.jacobian_apply(x0, z)),
                         ("velocity V-cycle (3 components)", lambda: pre._vgmg.apply(rb)),
                         (f"Q2 stencil apply {st.dims} (3 components)", lambda: st(rb)),
                         ("pressure-mass Chebyshev", lambda: pre._mass_solve(z[pre.pidx]))):
            w_ms, d_ms, all_ms = device_ms(torch, fn, 5)
            log(f"[phase 10a] ({CARD}) {cells}^3 one {name}: {w_ms:.3f} ms wall, "
                f"{d_ms:.3f} ms device time (torch.profiler kernel rows; all rows "
                f"{all_ms:.3f})")
    del x, x64, x0, slp, ls, pre, go, W
    torch.cuda.empty_cache()
    return its, l2


def stokes_at_scale(torch, pt, dev):
    """Phase 10a: both sizes in fp32, the plateau and the L2 checks, and
    the largest size again in fp64 (its answer past fp32's floor)."""
    res = {n: stokes3d(torch, pt, n, dev, instrument=n == STOKES_CELLS[-1])
           for n in STOKES_CELLS}
    (its0, l20), (its1, l21) = res[STOKES_CELLS[0]], res[STOKES_CELLS[-1]]
    its64, l264 = stokes3d(torch, pt, STOKES_CELLS[-1], dev, dtype=torch.float64)
    log(f"[phase 10a] ({CARD}) iterations {its0} / {its1} (fp64: {its64}), velocity L2 "
        f"{l20:.3e} / {l21:.3e} (fp64: {l264:.3e}) at {STOKES_CELLS[0]}^3 / "
        f"{STOKES_CELLS[-1]}^3")
    if not (its1 <= its0 + STOKES_PLATEAU and l21 < l20 and l264 < l20):
        raise AssertionError(f"phase 10a: no plateau or no L2 decrease: {res}")


def config5_run(torch, pt, dev, mass_cheby):
    """models/configs.py config5_stokes_taylor_hood's recipe on the port,
    fp64, with StokesGMGSchur's pressure-mass Chebyshev degree set."""
    from dune_pdelab_tpu_torch.ops import NavierStokesParameters, TaylorHoodNavierStokes
    from dune_pdelab_tpu_torch.solvers import LinearSolverBackend
    from dune_pdelab_tpu_torch.solvers.stokes import (
        StokesGMGSchur, stokes_constraints, taylor_hood_space,
    )

    W = taylor_hood_space(pt.StructuredMesh([0.0, 0.0], [1.0, 1.0], (8, 8)), 2)
    go = pt.GridOperator(W, TaylorHoodNavierStokes(
        stokes_params(NavierStokesParameters, stokes_f2d)),
        constraints=stokes_constraints(W, device=dev))
    ls = LinearSolverBackend(solver="gmres", restart=100, maxiter=20000,
                             precond=StokesGMGSchur(W, mu=1.0, mass_cheby=mass_cheby,
                                                    device=dev))
    slp = pt.StationaryLinearProblemSolver(go, ls, reduction=1e-9, verbose=0)
    x = slp.apply(W.zero(torch.float64, dev))
    return {"converged": slp.result.converged,
            "iterations": slp.result.linear_solver_iterations, "ndofs": W.ndofs,
            "velocity_l2_error": velocity_l2(W, x, stokes_u2d)}


def interleaved_residual(torch, pt, dev):
    """Two residuals of Taylor-Hood on an interleaved velocity (IndexDofMap
    scatter through the transpose map) at 32^3, fp32: bit-equal, and equal
    to the lexicographic layout's up to fp32 rounding."""
    import numpy as np
    from dune_pdelab_tpu_torch.assembly.dofmaps import IndexDofMap
    from dune_pdelab_tpu_torch.ops import NavierStokesParameters, TaylorHoodNavierStokes

    mesh = pt.StructuredMesh([0.0] * 3, [1.0] * 3, (32,) * 3)
    Vv, Vp = pt.FunctionSpace(mesh, pt.QkFEM(2, 3)), pt.FunctionSpace(mesh, pt.QkFEM(1, 3))
    lop = TaylorHoodNavierStokes(stokes_params(NavierStokesParameters, stokes_f3d))
    gos = {}
    for ordering in ("interleaved", "lexicographic"):
        W = pt.CompositeSpace(pt.PowerSpace(Vv, 3, ordering=ordering), Vp)
        gos[ordering] = pt.GridOperator(W, lop, constraints=pt.constraints(
            (True, None), W, device=dev))
    go = gos["interleaved"]
    if not all(isinstance(dm, IndexDofMap) for dm in go.dof_maps[:3]):
        raise AssertionError("interleaved velocity leaves did not take IndexDofMap")
    n, nv = go.space.ndofs, Vv.ndofs
    gen = torch.Generator(device=dev).manual_seed(11)
    x = torch.randn(n, generator=gen, device=dev)
    r1, r2 = go.residual(x), go.residual(x)
    if not torch.equal(r1, r2):
        raise AssertionError("interleaved residual differs between two calls")
    # the lexicographic index of every interleaved DOF
    i = np.arange(3 * nv)
    lex = np.concatenate([(i % 3) * nv + i // 3, np.arange(3 * nv, n)])
    perm = torch.as_tensor(lex, device=dev)
    xl = torch.empty_like(x)
    xl[perm] = x
    rl = gos["lexicographic"].residual(xl)
    err = float((rl[perm] - r1).abs().max() / rl.abs().max())
    log(f"[phase 10b] ({CARD}) Taylor-Hood residual on an interleaved velocity at 32^3 "
        f"fp32 (N = {n}): two calls bit-equal; against the lexicographic layout "
        f"{err:.2e} of max|r|")
    if not err <= 1e-5:
        raise AssertionError("interleaved and lexicographic residuals disagree")


def stokes_goldens(torch, pt, dev):
    """Phase 10b: config5 and config10 through the port's ALL_CONFIGS in fp64
    on the card (and config5's recipe with the Jacobi pressure-mass Schur,
    mass_cheby=0, that the golden was recorded with), and the interleaved
    residual's repeatability."""
    from dune_pdelab_tpu_torch.models import ALL_CONFIGS

    gold = json.loads((ROOT / "tests" / "golden_parity.json").read_text())
    c5, c10 = gold["config5_stokes_taylor_hood"], gold["config10_stokes_outflow"]
    runs = ((4, JAX_CONFIG5_ITS, lambda: ALL_CONFIGS["config5"](device=dev)),
            (0, c5["iterations"], lambda: config5_run(torch, pt, dev, 0)))
    for mass_cheby, want_its, run in runs:
        got, wall = timed(torch, run)
        its, l2 = got["iterations"], got["velocity_l2_error"]
        rel = abs(l2 - c5["velocity_l2_error"]) / c5["velocity_l2_error"]
        log(f"[phase 10b] ({CARD}) config5 fp64 (ndofs {got['ndofs']}), mass_cheby="
            f"{mass_cheby}: {its} GMRES iterations (want {want_its}), velocity L2 {l2:.16e} "
            f"(golden rel {rel:.2e}), {wall:.2f} s")
        if not (got["converged"] and its == want_its and got["ndofs"] == c5["ndofs"]
                and rel <= 1e-8):
            raise AssertionError("config5 golden mismatch")
    got, wall = timed(torch, lambda: ALL_CONFIGS["config10"](device=dev))
    its, l2v, l2p = got["iterations"], got["l2_v_error"], got["l2_p_error"]
    log(f"[phase 10b] ({CARD}) config10 fp64 (ndofs {got['ndofs']}): {its} GMRES iterations "
        f"(golden {c10['iterations']}), l2_v {l2v:.3e}, l2_p {l2p:.3e} (golden "
        f"{c10['l2_v_error']:.3e}, {c10['l2_p_error']:.3e}), {wall:.2f} s")
    if not (got["converged"] and its == c10["iterations"] and got["ndofs"] == c10["ndofs"]
            and abs(l2v - c10["l2_v_error"]) <= 1e-9 and abs(l2p - c10["l2_p_error"]) <= 1e-9):
        raise AssertionError("config10 golden mismatch")
    interleaved_residual(torch, pt, dev)


def cahouet_chabard(torch, pt, dev):
    """Phase 10c: the instationary Stokes problem of tests/test_stokes3d.py
    (_run_cc: u = e^-t u0, implicit Euler, dt 0.02, CahouetChabardSchur
    GMRES(150) to 1e-9) at CC_CELLS^2 cells to T = CC_T (the test runs to
    0.1), fp64."""
    from dune_pdelab_tpu_torch import instationary as inst
    from dune_pdelab_tpu_torch.ops import (
        NavierStokesMass, NavierStokesParameters, TaylorHoodNavierStokes,
    )
    from dune_pdelab_tpu_torch.solvers import LinearSolverBackend
    from dune_pdelab_tpu_torch.solvers.stokes import (
        CahouetChabardSchur, stokes_constraints, taylor_hood_space,
    )

    class Decaying(NavierStokesParameters):
        def f(self, x):
            xx, yy = x[..., 0], x[..., 1]
            u1, u2 = _a4(xx) * _da4(yy), -_da4(xx) * _a4(yy)
            fs = stokes_f2d(x)
            return math.exp(-self.time) * torch.stack([fs[..., 0] - u1, fs[..., 1] - u2],
                                                      dim=-1)

    def build():
        W = taylor_hood_space(pt.StructuredMesh([0.0, 0.0], [1.0, 1.0],
                                                (CC_CELLS, CC_CELLS)), 2)
        cgm = stokes_constraints(W, bctype=True, pin_pressure=True, device=dev)
        prm = Decaying(mu=1.0, rho=1.0)
        go_s = pt.GridOperator(W, TaylorHoodNavierStokes(prm), constraints=cgm)
        go_t = pt.GridOperator(W, NavierStokesMass(rho=1.0), constraints=cgm)
        ls = LinearSolverBackend(solver="gmres", restart=150, maxiter=20000,
                                 precond=CahouetChabardSchur(W, mu=1.0, rho=1.0, device=dev))
        osm = inst.OneStepMethod(inst.one_step_theta(1.0), go_s, go_t, ls,
                                 pdesolver="linear", reduction=1e-9)
        return W, osm

    (W, osm), setup_s = timed(torch, build)
    x = W.interpolate((stokes_u2d, lambda p: p[:, 0] ** 3 + p[:, 1] ** 3 - 0.5),
                      dtype=torch.float64, device=dev)
    t, per_step, walls = 0.0, [], []
    while t < CC_T - 1e-12:
        before = osm.result.total_linear_iterations
        x, w = timed(torch, lambda: osm.apply(t, 0.02, x))
        t += 0.02
        per_step.append(osm.result.total_linear_iterations - before)
        walls.append(w)
    l2 = velocity_l2(W, x, lambda p: math.exp(-t) * stokes_u2d(p))
    log(f"[phase 10c] ({CARD}) Cahouet-Chabard Stokes 2D Q2/Q1 {CC_CELLS}^2 cells (N = "
        f"{W.ndofs}) fp64, implicit Euler dt 0.02 to T = {t:.2f}: GMRES iterations per step "
        f"{per_step}, s per step {', '.join(f'{w:.2f}' for w in walls)} (first includes the "
        f"stage GMG build), setup {setup_s:.2f} s; velocity L2 error at T {l2:.6e}")
    if not (max(per_step) <= CC_ITS_MAX and l2 < CC_L2_MAX):
        raise AssertionError(f"phase 10c failed: iterations {per_step}, L2 {l2:.3e}")


def cavity_newton(torch, pt, dev):
    """Phase 10d (1): the Newton lid-driven cavity of tests/test_stokes.py:
    118-148 (mu 0.01, rho 1, regularized lid) at CAVITY_CELLS^2, fp64. The
    linear solver is StokesGMGSchur GMRES(150): the test's StokesBlockJacobi
    takes 46,495 GMRES iterations at 16^2 already (CPU, PERF.md)."""
    import numpy as np
    from dune_pdelab_tpu_torch.ops import NavierStokesParameters, TaylorHoodNavierStokes
    from dune_pdelab_tpu_torch.solvers import LinearSolverBackend, NewtonMethod
    from dune_pdelab_tpu_torch.solvers.stokes import (
        StokesGMGSchur, stokes_constraints, taylor_hood_space,
    )

    W = taylor_hood_space(pt.StructuredMesh([0.0, 0.0], [1.0, 1.0],
                                            (CAVITY_CELLS, CAVITY_CELLS)), 2)
    go = pt.GridOperator(W, TaylorHoodNavierStokes(NavierStokesParameters(mu=0.01, rho=1.0)),
                         constraints=stokes_constraints(W, device=dev))
    ls = LinearSolverBackend(solver="gmres", restart=150, maxiter=30000,
                             precond=StokesGMGSchur(W, mu=0.01, device=dev))
    newton = NewtonMethod(go, ls, reduction=1e-8, verbose=0, min_linear_reduction=1e-4)
    coords = W.children[0].child.dof_coords()
    lid = np.isclose(coords[:, 1], 1.0)
    ux = torch.as_tensor(np.where(lid, 4 * coords[:, 0] * (1 - coords[:, 0]), 0.0),
                         device=dev)
    x0 = W.zero(torch.float64, dev)
    x0 = W.embed(x0, 0, W.children[0].embed(W.restrict(x0, 0), 0, ux))
    x, wall = timed(torch, lambda: newton.apply(x0))
    res = newton.result
    vmax = float(W.children[0].restrict(W.restrict(x, 0), 0).abs().max())
    log(f"[phase 10d] ({CARD}) Newton lid-driven cavity Re 100, Q2/Q1 {CAVITY_CELLS}^2 "
        f"(N = {W.ndofs}) fp64: {res.iterations} Newton iterations, "
        f"{res.linear_solver_iterations} GMRES iterations, {wall:.2f} s, converged "
        f"{res.converged}, defect {res.defect:.3e} from {res.first_defect:.3e}, max |u_x| "
        f"{vmax:.4f}")
    if not (res.converged and 0.0 < vmax <= 1.01):
        raise AssertionError("phase 10d: the cavity Newton solve failed")


def dgns_run(torch, pt, dev):
    """10d's DGNavierStokes work on dev: the residual and J.v at a seeded x
    (numpy), then DGNS_GMRES_ITS iterations of block-Jacobi GMRES from zero:
    (residual, J.v, iterations, preconditioned reduction, true reduction,
    wall s, N)."""
    import numpy as np
    from dune_pdelab_tpu_torch.ops import DGNavierStokes, NavierStokesParameters
    from dune_pdelab_tpu_torch.solvers import LinearSolverBackend

    mesh = pt.StructuredMesh([0.0, 0.0], [1.0, 1.0], (DGNS_CELLS, DGNS_CELLS))
    Vv = pt.FunctionSpace(mesh, pt.QkDGFEM(2, 2))
    W = pt.CompositeSpace(pt.PowerSpace(Vv, 2), pt.FunctionSpace(mesh, pt.QkDGFEM(1, 2)))
    mask = np.zeros(W.ndofs, dtype=bool)
    mask[int(W.child_global(1, np.array([0]))[0])] = True
    go = pt.GridOperator(W, DGNavierStokes(stokes_params(NavierStokesParameters, stokes_f2d)),
                         constraints=pt.DirichletConstraints(mask, device=dev))
    rng = np.random.default_rng(12)
    x = torch.as_tensor(rng.standard_normal(W.ndofs), device=dev)
    z = torch.as_tensor(rng.standard_normal(W.ndofs), device=dev)
    r, jv = go.residual(x).cpu().numpy(), go.jacobian_apply(x, z).cpu().numpy()
    ls = LinearSolverBackend(solver="gmres", precond="block_jacobi",
                             restart=DGNS_GMRES_ITS, maxiter=DGNS_GMRES_ITS)
    x0 = W.zero(torch.float64, dev)
    b = go.residual(x0)
    t0 = time.perf_counter()
    zz, st = ls.solve(go, x0, b, 1e-9)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    true = float(torch.linalg.norm(go.residual(x0 - zz)) / torch.linalg.norm(b))
    return r, jv, int(st.iterations), float(st.reduction), true, wall, W.ndofs


def dgns_cpu(group):
    """dgns_run on the CPU, in a process of its own (cpu_aside)."""
    import torch
    import dune_pdelab_tpu_torch as pt
    return dgns_run(torch, pt, torch.device("cpu"))


def dg_navier_stokes(torch, pt, dev, aside):
    """Phase 10d (2): DGNavierStokes of tests/test_dgstokes.py:20-43 (Q2dg/Q1dg,
    one pinned pressure DOF) at DGNS_CELLS^2, fp64. The residual and J.v at
    a seeded x on the card against the same operator on the CPU; then
    DGNS_GMRES_ITS iterations of block-Jacobi GMRES (one cycle, from zero)
    on the card and on the CPU, whose reductions must agree: a converged
    solve takes block-Jacobi GMRES thousands of iterations at this size,
    each one general-jvp DG apply. The CPU side runs beside phase 10 in a
    process of its own (`aside`)."""
    import numpy as np

    r, jv, its, red, true, wall, n = dgns_run(torch, pt, dev)
    r_c, jv_c, its_c, red_c, true_c, wall_c, _ = aside_result(aside)
    errs = {"residual": float(np.abs(r - r_c).max() / np.abs(r_c).max()),
            "J.v": float(np.abs(jv - jv_c).max() / np.abs(jv_c).max())}
    gap = max(abs(red - red_c) / red_c, abs(true - true_c) / true_c)
    log(f"[phase 10d] ({CARD}) DGNavierStokes Q2dg/Q1dg {DGNS_CELLS}^2 (N = {n}) fp64: "
        f"card against CPU residual {errs['residual']:.2e}, J.v {errs['J.v']:.2e} of max|y|; "
        f"block-Jacobi GMRES, {its} iterations from zero: preconditioned reduction "
        f"{red:.6e} (CPU {red_c:.6e}), true reduction {true:.6e} (CPU {true_c:.6e}), "
        f"relative gap {gap:.2e}; {wall:.2f} s on the card = "
        f"{1e3 * wall / max(its, 1):.1f} ms/iteration (CPU {wall_c:.2f} s, beside)")
    if not (max(errs.values()) <= DGNS_APPLY_REL and its == its_c == DGNS_GMRES_ITS
            and red < 1.0 and true < 1.0 and gap <= DGNS_GMRES_GAP):
        raise AssertionError("phase 10d: the DG Stokes operator or GMRES disagrees with the CPU")


def phase_stokes(torch, pt, dev):
    """Phase 10: composite spaces and Taylor-Hood (Navier-)Stokes. No hand
    kernel: the Q2 velocity V-cycles run the plain k > 1 stencil form, the
    Taylor-Hood, pressure-mass and pressure-Laplacian applies the general
    torch.func.jvp."""
    aside = cpu_aside(dgns_cpu)         # 10d's CPU side, beside 10a-10d on the card
    stokes_at_scale(torch, pt, dev)
    stokes_goldens(torch, pt, dev)
    cahouet_chabard(torch, pt, dev)
    cavity_newton(torch, pt, dev)
    dg_navier_stokes(torch, pt, dev, aside)


# ---------------------------------------------------------------------------
# phase 11: algebraic solvers (AMG on simplex and lattice operators, the
# direct backend, LOBPCG and GenEO); no hand kernel of their own
# ---------------------------------------------------------------------------

def sine2d_problem():
    """models/configs.py _Sine2D: u = sin(pi x) cos(2 pi y) + x."""
    import torch
    from dune_pdelab_tpu_torch.ops import ConvectionDiffusionProblem

    pi = math.pi

    class Sine2D(ConvectionDiffusionProblem):
        def exact(self, p):
            return torch.sin(pi * p[:, 0]) * torch.cos(2 * pi * p[:, 1]) + p[:, 0]

        def f(self, x):
            return 5 * pi**2 * torch.sin(pi * x[..., 0]) * torch.cos(2 * pi * x[..., 1])

        def g(self, x):
            return torch.sin(pi * x[..., 0]) * torch.cos(2 * pi * x[..., 1]) + x[..., 0]
    return Sine2D()


def cycle_profile(torch, fn, reps):
    """(wall ms, device ms, kernel launches) per call of fn(): wall from
    synced timers, device time and launches from torch.profiler's CUDA
    kernel rows."""
    from torch.autograd import DeviceType

    fn()
    _, wall = timed(torch, lambda: [fn() for _ in range(reps)])
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    kern = sum(e.self_device_time_total for e in rows)
    return 1e3 * wall / reps, kern / 1e3 / reps, sum(e.count for e in rows) / reps


def cpu_aside(fn, *args):
    """Start fn(group, *args) in a CPU process of its own (a one-rank gloo
    RankPool on the CPU, dune_pdelab_tpu_torch.parallel.launch) and return
    (pool, task) at once: a card-against-CPU comparison computes its CPU
    side there while this process drives the card. `aside_result` waits,
    stops the process and returns fn's result."""
    import atexit
    from dune_pdelab_tpu_torch.parallel.launch import RankPool
    pool = RankPool(1, backend="gloo", device="cpu", threads=4, timeout=900)
    atexit.register(pool.close)          # stopped even if a phase raises first
    return pool, pool.submit(fn, *args)


def aside_result(aside):
    pool, task = aside
    try:
        return task.result()[0]
    finally:
        pool.close()


def simplex_poisson(pt, dim, cells, problem, dev):
    """(V, go) of P1 Poisson on the triangulated unit square / Kuhn-cut unit
    cube; pure Dirichlet, so the boundary kernels are dropped."""
    from dune_pdelab_tpu_torch.ops import ConvectionDiffusionFEM

    mesh = pt.SimplexMesh.from_structured(
        pt.StructuredMesh([0.0] * dim, [1.0] * dim, (cells,) * dim))
    V = pt.FunctionSpace(mesh, pt.PkFEM(1, dim))
    cgm = pt.constraints(problem.dirichlet_bctype(), V, device=dev)
    return V, pt.GridOperator(V, ConvectionDiffusionFEM(problem), constraints=cgm,
                              skip_boundary=True)


def amg_solve(torch, pt, V, go, problem, dev, tag, dtype=None, amg=None, red=1e-10):
    """StationaryLinearProblemSolver + CG + AlgebraicMultigrid on (V, go):
    setup (split) and solve timed apart, one V-cycle profiled, the true
    relative defect, peak memory. Returns (iterations, L2 error, amg)."""
    from dune_pdelab_tpu_torch.linalg.amg import AlgebraicMultigrid
    from dune_pdelab_tpu_torch.solvers import LinearSolverBackend, StationaryLinearProblemSolver
    from dune_pdelab_tpu_torch.space.functions import l2_difference

    dtype = dtype or torch.float64
    torch.cuda.reset_peak_memory_stats()
    x0 = pt.interpolate_dirichlet(problem.g, V, go.cg, V.zero(dtype, dev))
    fresh = amg is None
    amg = amg or AlgebraicMultigrid()
    _, setup_s = timed(torch, lambda: amg(go, x0, 0.0))
    ls = LinearSolverBackend(solver="cg", precond=amg)
    slp = StationaryLinearProblemSolver(go, ls, reduction=red)
    x, solve_s = timed(torch, lambda: slp.apply(x0))
    its = slp.result.linear_solver_iterations
    r0 = float(torch.linalg.norm(go.residual(x0)))
    true_rel = float(torch.linalg.norm(go.residual(x))) / r0
    l2 = float(l2_difference(V, x, problem.exact))
    peak = torch.cuda.max_memory_allocated() / 2**30
    info = amg.hierarchy_info()
    r = torch.randn(V.ndofs, dtype=dtype, device=dev,
                    generator=torch.Generator(dev).manual_seed(11))
    wall, dev_ms, launches = cycle_profile(torch, lambda: amg.apply(r), 5)
    split = ", ".join(f"{k} {v:.3f}" for k, v in amg.setup_times.items()) if fresh else "reused"
    log(f"[{tag}] N = {V.ndofs} ({V.mesh.nelements} simplices), {dtype}: {its} CG "
        f"iterations, converged {slp.result.converged}, true rel defect {true_rel:.3e}, "
        f"L2 {l2:.6e}; setup {setup_s:.3f} s ({split} s); solve {solve_s:.3f} s = "
        f"{1e3 * solve_s / max(its, 1):.3f} ms/iteration; {len(info['sizes'])} levels "
        f"{info['sizes']}, operator complexity {info['operator_complexity']:.6f}; one "
        f"V-cycle {wall:.3f} ms wall / {dev_ms:.3f} ms device, {launches:.0f} kernel "
        f"launches; peak {peak:.2f} GiB; {CARD}")
    if not (slp.result.converged and bool(torch.isfinite(x).all())):
        raise AssertionError(f"{tag}: AMG-CG did not converge")
    return its, l2, true_rel, amg


def amg_config12(torch, pt, dev):
    """Phase 11a: config12_simplex_amg at 32^2 through the port's ALL_CONFIGS
    in fp64 on the card, held against tests/golden_parity.json."""
    from dune_pdelab_tpu_torch.models import ALL_CONFIGS

    want = json.loads((ROOT / "tests" / "golden_parity.json").read_text())[
        "config12_simplex_amg"]
    got = ALL_CONFIGS["config12"](device=dev)
    log(f"[phase 11a] config12 on the card: {got} (golden {want}); {CARD}")
    ok = (got["iterations"] == want["iterations"] and got["levels"] == want["levels"]
          and got["ndofs"] == want["ndofs"] and got["converged"]
          and abs(got["operator_complexity"] / want["operator_complexity"] - 1) <= 1e-12
          and abs(got["l2_error"] / want["l2_error"] - 1) <= 1e-8)
    if not ok:
        raise AssertionError(f"config12 golden not reproduced: {got} vs {want}")


def amg_simplex(torch, pt, dev):
    """Phase 11b: AMG-CG on 2D simplex P1 Poisson in fp64 to 1e-10 at
    AMG_SIZES cells per axis, then one fp32 solve at the largest size to
    1e-6 on the same hierarchy."""
    p = sine2d_problem()
    its, errs = [], []
    for n in AMG_SIZES:
        V, go = simplex_poisson(pt, 2, n, p, dev)
        it, l2, true_rel, amg = amg_solve(torch, pt, V, go, p, dev, f"phase 11b {n}^2")
        if not (it <= AMG_ITS_MAX and true_rel <= 1e-9):
            raise AssertionError(f"11b {n}^2: {it} iterations, true rel {true_rel:.3e}")
        its.append(it)
        errs.append(l2)
        if n != AMG_SIZES[-1]:
            del V, go, amg
            torch.cuda.empty_cache()
    ratios = [a / b for a, b in zip(errs, errs[1:])]
    log(f"[phase 11b] iterations {its}, L2 ratios per halving of h {ratios}; {CARD}")
    if max(its) - min(its) > AMG_ITS_SPREAD:
        raise AssertionError(f"11b iterations spread: {its}")
    if not all(AMG_L2_RATIO[0] <= q <= AMG_L2_RATIO[1] for q in ratios):
        raise AssertionError(f"11b L2 error not falling as h^2: {errs}")
    it32, _, rel32, _ = amg_solve(torch, pt, V, go, p, dev, f"phase 11b {AMG_SIZES[-1]}^2 fp32",
                                  dtype=torch.float32, amg=amg, red=1e-6)
    if not (it32 <= AMG_ITS_MAX and rel32 <= 1e-5):
        raise AssertionError(f"11b fp32: {it32} iterations, true rel {rel32:.3e}")
    del V, go, amg
    torch.cuda.empty_cache()


def amg_tets(torch, pt, dev):
    """Phase 11c: AMG-CG on 3D tetrahedral P1 Poisson (sin sin sin) in fp64
    to 1e-10 at AMG_TET_CELLS^3 hexes cut into six Kuhn tetrahedra each."""
    p = sine3d_problem()
    V, go = simplex_poisson(pt, 3, AMG_TET_CELLS, p, dev)
    it, _, true_rel, _ = amg_solve(torch, pt, V, go, p, dev, f"phase 11c {AMG_TET_CELLS}^3 tets")
    if not (it <= AMG_TET_ITS_MAX and true_rel <= 1e-9):
        raise AssertionError(f"11c: {it} iterations, true rel {true_rel:.3e}")
    del V, go
    torch.cuda.empty_cache()


def amg_readme(torch, pt, dev):
    """Phase 11d: SEQ_CG_AMG on phase 4's README problem (3D Q1 Poisson,
    f == 1, README_CELLS^3 cells) in fp32 to 1e-8: the AMG hierarchy from
    the probed lattice ELL, the Krylov operator the compiled stencil, so
    stencil27 launches in every iteration."""
    from dune_pdelab_tpu_torch.kernels import stencil27 as sk
    from dune_pdelab_tpu_torch.ops import ConvectionDiffusionFEM
    from dune_pdelab_tpu_torch.solvers import SEQ_CG_AMG

    prob = unit_source_problem()
    mesh = pt.StructuredMesh([0, 0, 0], [1, 1, 1], (README_CELLS,) * 3)
    V = pt.FunctionSpace(mesh, pt.QkFEM(1, 3))
    cgm = pt.constraints(prob.dirichlet_bctype(), V, device=dev)
    go = pt.GridOperator(V, ConvectionDiffusionFEM(prob), constraints=cgm, skip_boundary=True)
    x0 = V.zero(torch.float32, dev)
    ls = SEQ_CG_AMG()
    _, setup_s = timed(torch, lambda: ls.precond(go, x0, 0.0))
    before = sk.launches
    x, solve_s = timed(torch, lambda: pt.StationaryLinearProblemSolver(
        go, ls, reduction=1e-8).apply(x0))
    st = ls.stats_history[-1]
    launched = sk.launches - before
    info = ls.precond.hierarchy_info()
    true_rel = float(torch.linalg.norm(go.residual(x)) / torch.linalg.norm(go.residual(x0)))
    split = ", ".join(f"{k} {v:.3f}" for k, v in ls.precond.setup_times.items())
    log(f"[phase 11d] SEQ_CG_AMG README problem {V.ndofs} DOFs fp32: {st.iterations} "
        f"iterations (phase 4 Jacobi-CG: {README_JACOBI_ITS}), converged "
        f"{bool(st.converged)}, true rel defect {true_rel:.3e}; setup {setup_s:.3f} s "
        f"({split} s), solve {solve_s:.3f} s = {1e3 * solve_s / max(st.iterations, 1):.3f} "
        f"ms/iteration; {len(info['sizes'])} levels, operator complexity "
        f"{info['operator_complexity']:.6f}; stencil27 launches {launched}; {CARD}\n"
        f"{ls.report(go)}")
    if "compiled stencil" not in ls.report(go) or launched < st.iterations:
        raise AssertionError("11d: the Krylov operator did not run on stencil27")
    if not (bool(st.converged) and bool(torch.isfinite(x).all())
            and st.iterations < README_JACOBI_ITS):
        raise AssertionError(f"11d: {st.iterations} iterations, converged {st.converged}")
    del x, go, V, ls
    torch.cuda.empty_cache()


def amg_dg(torch, pt, dev):
    """Phase 11e: DGTwoLevel(coarse="amg") on phase 7c's 64^3 Q1 SIPG
    problem in fp32, the smoother's operator the mode-major block stencil
    (blockstencil_mm), in the same host PCG loop to 1e-8."""
    from dune_pdelab_tpu_torch.assembly.blockstencil import compile_block_stencil
    from dune_pdelab_tpu_torch.assembly.blockstencil_mm import try_mm_block_stencil
    from dune_pdelab_tpu_torch.kernels import blockstencil as bk
    from dune_pdelab_tpu_torch.linalg import DGTwoLevel, cg
    from dune_pdelab_tpu_torch.ops import ConvectionDiffusionFEM

    cells = DGMG_CELLS[0]
    p = unit_source_problem()
    V, go = dg_operator(pt, (cells,) * 3, 1, p)
    t0 = time.perf_counter()
    A = try_mm_block_stencil(compile_block_stencil(go))
    tl = DGTwoLevel(go, ConvectionDiffusionFEM(p), coarse="amg")
    tl.setup(operator=A)
    b = -go.residual(V.zero(torch.float32))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    before = bk.launches_mm
    (x, st), solve_s = timed(torch, lambda: cg(A, b, M=tl.apply, tol=1e-8, maxiter=200))
    launched = bk.launches_mm - before
    true_rel = float(torch.linalg.norm(A(x) - b) / torch.linalg.norm(b))
    info = tl.amg.hierarchy_info()
    split = ", ".join(f"{k} {v:.3f}" for k, v in tl.amg.setup_times.items())
    log(f"[phase 11e] DGTwoLevel(coarse='amg') {cells}^3 Q1 SIPG (N = {V.ndofs}) fp32: "
        f"{st.iterations} CG iterations (7c gmg coarse: {DGMG_GMG_ITS}), converged "
        f"{bool(st.converged)}, true rel residual {true_rel:.3e}; setup {setup_s:.3f} s "
        f"(AMG {split} s; {len(info['sizes'])} levels on N = {info['sizes'][0]}); solve "
        f"{solve_s:.3f} s = {1e3 * solve_s / max(st.iterations, 1):.3f} ms/iteration; "
        f"blockstencil_mm launches {launched}; {CARD}")
    if launched == 0:
        raise AssertionError("11e: DGTwoLevel(coarse='amg') launched no blockstencil_mm")
    if not (bool(st.converged) and bool(torch.isfinite(x).all()) and true_rel < 1e-2):
        raise AssertionError(f"11e: {st.iterations} iterations, converged {st.converged}")
    del x, b, tl, A, go, V
    torch.cuda.empty_cache()


def direct_eigen_geneo(torch, pt, dev, aside):
    """Phase 11f: SEQ_SuperLU on 2D Q2 Poisson at DIRECT_CELLS^2 (fp64);
    lobpcg for the 4 smallest eigenpairs of the 2D Q1 Dirichlet Laplacian
    with mass at EIGEN_CELLS^2 (fp64, Jacobi preconditioned); GenEO
    (method="ilu", boxes (4, 4)) on the high-contrast 2D Q1 problem at
    GENEO_CELLS^2 (fp64), its CG iterations on the card against the same
    code on the CPU."""
    from dune_pdelab_tpu_torch.linalg import cg
    from dune_pdelab_tpu_torch.linalg.eigen import lobpcg
    from dune_pdelab_tpu_torch.linalg.geneo import geneo_preconditioner_for
    from dune_pdelab_tpu_torch.ops import ConvectionDiffusionFEM, ConvectionDiffusionProblem
    from dune_pdelab_tpu_torch.ops.l2 import L2
    from dune_pdelab_tpu_torch.solvers import SEQ_SuperLU

    f64 = torch.float64
    p = sine2d_problem()
    mesh = pt.StructuredMesh([0, 0], [1, 1], (DIRECT_CELLS,) * 2)
    V = pt.FunctionSpace(mesh, pt.QkFEM(2, 2))
    go = pt.GridOperator(V, ConvectionDiffusionFEM(p),
                         constraints=pt.constraints(p.dirichlet_bctype(), V, device=dev))
    x0 = pt.interpolate_dirichlet(p.g, V, go.cg, V.zero(f64, dev))
    ls = SEQ_SuperLU()
    x, wall = timed(torch, lambda: pt.StationaryLinearProblemSolver(
        go, ls, reduction=1e-12).apply(x0))
    st = ls.stats_history[-1]
    rel = float(st.defect) / float(st.defect0)
    true_rel = float(torch.linalg.norm(go.residual(x)) / torch.linalg.norm(go.residual(x0)))
    log(f"[phase 11f] SEQ_SuperLU 2D Q2 {DIRECT_CELLS}^2 (N = {V.ndofs}) fp64: relative "
        f"defect {rel:.3e} (host), true rel defect {true_rel:.3e} (card), {wall:.3f} s; "
        f"{CARD}")
    if not (rel <= 1e-12 and true_rel <= 1e-11 and x.device == x0.device):
        raise AssertionError(f"11f direct: rel defect {rel:.3e}, true {true_rel:.3e}")

    mesh = pt.StructuredMesh([0, 0], [1, 1], (EIGEN_CELLS,) * 2)
    V = pt.FunctionSpace(mesh, pt.QkFEM(1, 2))
    cons = pt.constraints(True, V, device=dev)
    goA = pt.GridOperator(V, ConvectionDiffusionFEM(ConvectionDiffusionProblem()),
                          constraints=cons)
    goB = pt.GridOperator(V, L2(), constraints=cons)
    z, m = V.zero(f64, dev), cons.mask
    d = torch.where(m, 1e6, goA.jacobian_diagonal(z))
    res, wall = timed(torch, lambda: lobpcg(
        lambda v: torch.where(m, 1e6 * v, goA.jacobian_apply(z, v)), k=4, n=V.ndofs,
        B=lambda v: torch.where(m, v, goB.jacobian_apply(z, v)), M=lambda r: r / d,
        tol=1e-4, maxiter=1000, dtype=f64, device=dev))
    lam = (res.eigenvalues / math.pi**2).tolist()
    exact = [2.0, 5.0, 5.0, 8.0]
    log(f"[phase 11f] lobpcg {EIGEN_CELLS}^2 Q1 (N = {V.ndofs}) fp64: lambda / pi^2 = "
        f"{lam}, residual norms {res.residual_norms.tolist()}, {res.iterations} "
        f"iterations, {wall:.3f} s; {CARD}")
    if not (all(abs(a - b) / b < 0.02 for a, b in zip(lam, exact))
            and bool((res.residual_norms <= 1e-4).all())):
        raise AssertionError(f"11f lobpcg: {lam}, {res.residual_norms.tolist()}")

    its = []
    for where, run in ((dev.type, geneo_solve(torch, pt, dev)), ("cpu", aside_result(aside))):
        it, converged, setup_s, split, solve_s = run
        its.append(it)
        log(f"[phase 11f] GenEO ilu {GENEO_CELLS}^2 (N = {(GENEO_CELLS + 1) ** 2}) on {where}: "
            f"{it} CG iterations, converged {converged}; setup {setup_s:.3f} s ({split} s), "
            f"solve {solve_s:.3f} s{' (a CPU process of its own, run beside phase 11)' if where == 'cpu' else ''}; {CARD}")
        if not converged:
            raise AssertionError(f"11f GenEO on {where} did not converge")
    if abs(its[0] - its[1]) > 1:
        raise AssertionError(f"11f GenEO iterations card {its[0]} vs CPU {its[1]}")


def geneo_solve(torch, pt, dev):
    """11f's GenEO (method="ilu", boxes (4, 4)) CG solve of
    tests/test_solver_utils.py's HighContrast problem (layered 1 / 1e4
    diffusion) at GENEO_CELLS^2 on dev: (iterations, converged, setup s,
    setup split, solve s)."""
    from dune_pdelab_tpu_torch.linalg import cg
    from dune_pdelab_tpu_torch.linalg.geneo import geneo_preconditioner_for
    from dune_pdelab_tpu_torch.ops import ConvectionDiffusionFEM, ConvectionDiffusionProblem

    class HighContrast(ConvectionDiffusionProblem):
        def A(self, x):
            return torch.where(torch.floor(x[..., 1] * 8) % 2 == 0, 1.0, 1e4)

        def f(self, x):
            return torch.ones(x.shape[:-1], dtype=x.dtype, device=x.device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    mesh = pt.StructuredMesh([0, 0], [1, 1], (GENEO_CELLS,) * 2)
    V = pt.FunctionSpace(mesh, pt.QkFEM(1, 2))
    go = pt.GridOperator(V, ConvectionDiffusionFEM(HighContrast()),
                         constraints=pt.constraints(True, V, device=dev))
    z = V.zero(torch.float64, dev)
    t0 = time.perf_counter()
    M = geneo_preconditioner_for(go, x_lin=z, boxes=(4, 4), nev=3, method="ilu")
    sync()
    setup_s = time.perf_counter() - t0
    b = go.residual(z)
    t0 = time.perf_counter()
    _, st = cg(lambda v: go.jacobian_apply(z, v), b, M=M, tol=1e-8, maxiter=2000)
    sync()
    split = ", ".join(f"{k} {v:.3f}" for k, v in M.setup_times.items())
    return int(st.iterations), bool(st.converged), setup_s, split, time.perf_counter() - t0


def geneo_cpu(group):
    """geneo_solve on the CPU, in a process of its own (cpu_aside)."""
    import torch
    import dune_pdelab_tpu_torch as pt
    return geneo_solve(torch, pt, torch.device("cpu"))


def phase_algebraic(torch, pt, dev):
    """Phase 11: the algebraic solvers. No hand kernel of their own: the AMG
    cycle is plain-torch ELL SpMVs, its setup host scipy; 11d's Krylov
    operator is stencil27, 11e's smoother operator blockstencil_mm."""
    aside = cpu_aside(geneo_cpu)       # 11f's CPU side, beside 11a-11f on the card
    amg_config12(torch, pt, dev)
    amg_simplex(torch, pt, dev)
    amg_tets(torch, pt, dev)
    amg_readme(torch, pt, dev)
    amg_dg(torch, pt, dev)
    direct_eigen_geneo(torch, pt, dev, aside)


# ---------------------------------------------------------------------------
# phase 12: adaptivity and mesh breadth (newest-vertex bisection and the
# config6 loop, hanging nodes, periodic and mapped meshes, simplex faces
# and PkDGFEM); no hand kernel applies to these operators
# ---------------------------------------------------------------------------

def _lshape_exact(torch, p):
    """u = r^(2/3) sin(2 theta / 3), theta in [0, 2 pi) (config6)."""
    r = torch.hypot(p[..., 0], p[..., 1])
    th = torch.remainder(torch.atan2(p[..., 1], p[..., 0]), 2 * math.pi)
    return torch.where(r == 0, torch.zeros_like(r), r ** (2 / 3) * torch.sin(2 * th / 3))


def lshape_problem():
    import torch
    from dune_pdelab_tpu_torch.ops import ConvectionDiffusionProblem

    class Corner(ConvectionDiffusionProblem):
        def exact(self, p):
            return _lshape_exact(torch, p)

        def f(self, x):
            return torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)

        def g(self, x):
            return _lshape_exact(torch, x)
    return Corner()


def lshape_mesh(pt, n):
    """The L-shape [-1, 1]^2 minus the lower-right quadrant, cut from a
    triangulated n^2 square and oriented for bisection (config6)."""
    sq = pt.SimplexMesh.from_structured(pt.StructuredMesh([-1, -1], [1, 1], (n, n)))
    c = sq.element_centers()
    return sq.submesh(~((c[:, 0] > 0) & (c[:, 1] < 0))).oriented_for_bisection()


def adapt_solve(torch, pt, V, problem, dev, solver="amg", reduction=1e-10):
    """One solve of the adaptive loop on `dev` in fp64: constraints, the
    GridOperator (boundary face groups built), AMG setup (or none for
    Jacobi), CG. Returns (x, iterations, true relative defect, seconds of
    {constraints, operator+setup, solve})."""
    from dune_pdelab_tpu_torch.ops import ConvectionDiffusionFEM

    t = {}
    t0 = time.perf_counter()
    cgm = pt.constraints(problem.dirichlet_bctype(), V, device=dev)
    x0 = pt.interpolate_dirichlet(problem.g, V, cgm, V.zero(torch.float64, dev))
    torch.cuda.synchronize()
    t["constraints"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    go = pt.GridOperator(V, ConvectionDiffusionFEM(problem), constraints=cgm)
    ls = pt.SEQ_CG_AMG(**ADAPT_AMG) if solver == "amg" else pt.SEQ_CG_Jacobi(maxiter=20000)
    if solver == "amg":
        ls.precond(go, x0, 0.0)
    torch.cuda.synchronize()
    t["operator+setup"] = time.perf_counter() - t0
    slp = pt.StationaryLinearProblemSolver(go, ls, reduction=reduction, verbose=0)
    x, t["solve"] = timed(torch, lambda: slp.apply(x0))
    r0 = float(torch.linalg.norm(go.residual(x0)))
    true_rel = float(torch.linalg.norm(go.residual(x))) / r0 if r0 > 0 else 0.0
    if not (slp.result.converged and bool(torch.isfinite(x).all())):
        raise AssertionError(f"phase 12: solve on N = {V.ndofs} did not converge")
    return x, slp.result.linear_solver_iterations, true_rel, t, go


def adapt_config6(torch, pt, dev):
    """Phase 12a: config6_adaptive_lshape through the port's ALL_CONFIGS on
    the card in fp64: P1 on the L-shape of an 8^2 square, Doerfler 0.5 on
    the edge-jump indicator, four bisection cycles, Jacobi-CG to 1e-12,
    held against tests/golden_parity.json."""
    from dune_pdelab_tpu_torch.models import ALL_CONFIGS

    want = json.loads((ROOT / "tests" / "golden_parity.json").read_text())[
        "config6_adaptive_lshape"]
    got = ALL_CONFIGS["config6"](device=dev)
    log(f"[phase 12a] config6 on the card: {got} (golden {want}); {CARD}")
    bad = [k for k in want if (abs(got[k] / want[k] - 1) > 1e-10 if k.startswith("l2")
                               else got[k] != want[k])]
    if bad:
        raise AssertionError(f"config6 golden not reproduced in {bad}: {got} vs {want}")


def _conforming(mesh):
    return int(mesh.faces()[2].max()) <= 2


def _slope(ns, errs, nmin):
    """Least-squares slope of log L2 against log N over the points N >= nmin."""
    import numpy as np

    sel = [i for i, n in enumerate(ns) if n >= nmin]
    return float(np.polyfit(np.log(np.asarray(ns)[sel]), np.log(np.asarray(errs)[sel]), 1)[0])


def adapt_loop(torch, pt, V, problem, dev, tag, target, max_cycles, fraction, f=None):
    """The simplex adaptive loop: solve (AMG-CG) -> p1_edge_jump_indicator
    -> mark_elements(error_fraction) -> adapt_local_simplex, until N >=
    target or max_cycles. Prints the per-cycle split; returns the list of
    (N, L2, iterations, true defect) and the final space."""
    from dune_pdelab_tpu_torch.adaptivity import (
        adapt_local_simplex, error_fraction, mark_elements, p1_edge_jump_indicator,
    )
    from dune_pdelab_tpu_torch.space.functions import l2_difference

    rows = []
    x = None
    for cyc in range(max_cycles + 1):
        split = {}
        if x is None:
            x, its, rel, ts, _ = adapt_solve(torch, pt, V, problem, dev)
        else:
            t0 = time.perf_counter()
            eta2 = p1_edge_jump_indicator(V, x, f)
            split["indicator"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            marks, _ = mark_elements(eta2, error_fraction(eta2, fraction))
            split["marking"] = time.perf_counter() - t0
            V, x = adapt_local_simplex(V, x, marks, timings=split)
            x, its, rel, ts, _ = adapt_solve(torch, pt, V, problem, dev)
        split["space+constraints"] = split.pop("space", 0.0) + ts["constraints"]
        split.update({"operator+AMG setup": ts["operator+setup"], "solve": ts["solve"]})
        l2 = float(l2_difference(V, x, problem.exact))
        rows.append((V.ndofs, l2, its, rel))
        log(f"[{tag}] cycle {cyc}: N = {V.ndofs}, {V.mesh.nelements} cells, L2 {l2:.6e}, "
            f"AMG-CG {its} iterations, true rel defect {rel:.3e}; s: "
            + ", ".join(f"{k} {v:.3f}" for k, v in split.items()))
        if V.ndofs >= target:
            break
    return rows, V


def adapt_lshape_full(torch, pt, dev):
    """Phase 12b: the slice's path at full size on the config6 problem:
    uniform baselines (L-shapes of triangulated ADAPT_UNIFORM^2 squares,
    SEQ_CG_AMG with a Chebyshev smoother to 1e-10) and the adaptive loop
    from an ADAPT_START^2 L-shape (Doerfler 0.5) to N >= ADAPT_TARGET."""
    from dune_pdelab_tpu_torch.space.functions import l2_difference

    p = lshape_problem()
    uni = []
    for n in ADAPT_UNIFORM:
        V = pt.FunctionSpace(lshape_mesh(pt, n), pt.PkFEM(1, 2))
        (x, its, rel, ts, _), wall = timed(torch, lambda: adapt_solve(torch, pt, V, p, dev))
        uni.append((V.ndofs, float(l2_difference(V, x, p.exact))))
        log(f"[phase 12b] uniform {n}^2 L-shape: N = {V.ndofs}, L2 {uni[-1][1]:.6e}, "
            f"AMG-CG {its} iterations, true rel defect {rel:.3e}, {wall:.3f} s ("
            + ", ".join(f"{k} {v:.3f}" for k, v in ts.items()) + ")")
    uni_slope = _slope([n for n, _ in uni], [e for _, e in uni], 0)
    t0 = time.perf_counter()
    V = pt.FunctionSpace(lshape_mesh(pt, ADAPT_START), pt.PkFEM(1, 2))
    rows, V = adapt_loop(torch, pt, V, p, dev, "phase 12b", ADAPT_TARGET, ADAPT_MAX_CYCLES, 0.5)
    loop_s = time.perf_counter() - t0
    ns, errs = [r[0] for r in rows], [r[1] for r in rows]
    slope = _slope(ns, errs, ADAPT_SLOPE_NMIN)
    n_big, e_big = uni[-1]
    better = [(n, e) for n, e in zip(ns, errs) if n <= n_big and e < e_big]
    log(f"[phase 12b] adaptive loop {loop_s:.2f} s over {len(rows) - 1} cycles, final N = "
        f"{ns[-1]}; slope of log L2 on log N (N >= {ADAPT_SLOPE_NMIN}) {slope:.4f}, uniform "
        f"{uni_slope:.4f}; "
        f"first adaptive iterate below the uniform {ADAPT_UNIFORM[-1]}^2 error "
        f"{e_big:.6e}: {better[:1]}; {CARD}")
    checks = {
        "N rises": all(b > a for a, b in zip(ns, ns[1:])),
        "L2 falls": all(b < a for a, b in zip(errs, errs[1:])),
        "iterations": all(r[2] <= ADAPT_ITS_MAX for r in rows),
        "true defect": all(r[3] <= 1e-9 for r in rows),
        "slope": slope < -0.75,
        "beats uniform": bool(better),
        "conforming": _conforming(V.mesh),
        # Doerfler 0.5 grows N ~1.2x a cycle: the cycle cap may end the loop first
        "end": ns[-1] >= ADAPT_TARGET or len(rows) == ADAPT_MAX_CYCLES + 1,
    }
    if not all(checks.values()):
        raise AssertionError(f"phase 12b holds failed: {checks}")


def fichera_problem():
    import torch
    from dune_pdelab_tpu_torch.ops import ConvectionDiffusionProblem

    a = 0.3

    class Fichera(ConvectionDiffusionProblem):
        def exact(self, p):
            return torch.linalg.norm(p, dim=-1) ** a

        def f(self, x):
            r = torch.sqrt(torch.sum(x * x, dim=-1) + 1e-30)
            return -a * (a + 1.0) * r ** (a - 2.0)

        def g(self, x):
            return torch.linalg.norm(x, dim=-1) ** a
    return Fichera()


def fichera_mesh(pt, n, orient=True):
    """[-1, 1]^3 minus [0, 1]^3 cut from n^3 Kuhn-triangulated cubes
    (tests/test_simplex_adapt3d.py:164)."""
    import numpy as np

    m = pt.SimplexMesh.from_structured(pt.StructuredMesh([-1] * 3, [1] * 3, (n,) * 3))
    m = m.submesh(~np.all(m.element_centers() > 0.0, axis=1))
    return m.oriented_for_bisection() if orient else m


def adapt_fichera(torch, pt, dev):
    """Phase 12c: 3D Traxler bisection on the Fichera problem
    (tests/test_simplex_adapt3d.py:123-200): uniform Kuhn meshes at
    FICHERA_UNIFORM^3 and the adaptive loop (Doerfler 0.6 on the facet-jump
    + source indicator) to N >= FICHERA_TARGET, AMG-CG."""
    from dune_pdelab_tpu_torch.space.functions import l2_difference

    p = fichera_problem()
    uni = []
    for n in FICHERA_UNIFORM:
        V = pt.FunctionSpace(fichera_mesh(pt, n, orient=False), pt.PkFEM(1, 3))
        x, its, rel, ts, _ = adapt_solve(torch, pt, V, p, dev)
        uni.append((V.ndofs, float(l2_difference(V, x, p.exact))))
        log(f"[phase 12c] uniform Fichera {n}^3: N = {V.ndofs}, L2 {uni[-1][1]:.6e}, AMG-CG "
            f"{its} iterations, true rel defect {rel:.3e}; s: "
            + ", ".join(f"{k} {v:.3f}" for k, v in ts.items()))
    V = pt.FunctionSpace(fichera_mesh(pt, 2), pt.PkFEM(1, 3))

    def src(c):
        return p.f(torch.as_tensor(c)).numpy()

    rows, V = adapt_loop(torch, pt, V, p, dev, "phase 12c", FICHERA_TARGET, FICHERA_MAX_CYCLES,
                         0.6, f=src)
    n32, e32 = uni[-1]
    better = [(r[0], r[1]) for r in rows if r[0] <= n32 and r[1] < e32]
    log(f"[phase 12c] final N = {rows[-1][0]}; first adaptive iterate below the uniform "
        f"{FICHERA_UNIFORM[-1]}^3 error {e32:.6e} (N = {n32}): {better[:1]}; {CARD}")
    if not (better and _conforming(V.mesh) and all(r[3] <= 1e-9 for r in rows)
            and (rows[-1][0] >= FICHERA_TARGET or len(rows) == FICHERA_MAX_CYCLES + 1)):
        raise AssertionError(f"phase 12c holds failed: {rows}, uniform {uni}")


def corner_q1_problem():
    """tests/test_adaptive.py:208 CornerSingularity: u = r^0.6, f = -lap u."""
    import torch
    from dune_pdelab_tpu_torch.ops import ConvectionDiffusionProblem

    lam = 0.6

    class CornerQ1(ConvectionDiffusionProblem):
        def _r(self, x):
            return torch.sqrt(x[..., 0] ** 2 + x[..., 1] ** 2 + 1e-30)

        def exact(self, p):
            return (torch.sqrt(p[:, 0] ** 2 + p[:, 1] ** 2) + 1e-30) ** lam

        def f(self, x):
            return -lam ** 2 * self._r(x) ** (lam - 2.0)

        def g(self, x):
            return self._r(x) ** lam
    return CornerQ1()


def adapt_hanging(torch, pt, dev):
    """Phase 12d: the hanging-node AdaptiveMesh Q1 loop of
    tests/test_adaptive.py:232-257 (volume_residual_indicator, Doerfler
    0.7, Jacobi-CG to 1e-10) grown to N >= HANG_TARGET against a uniform
    HANG_UNIFORM^2 run; on the final mesh jacobian_apply against the
    assembled jacobian (_affine_expand)."""
    import numpy as np
    from dune_pdelab_tpu_torch.adaptivity import (
        adapt_local, error_fraction, volume_residual_indicator,
    )
    from dune_pdelab_tpu_torch.ops import ConvectionDiffusionFEM
    from dune_pdelab_tpu_torch.space.functions import l2_difference

    p = corner_q1_problem()

    def solve(mesh):
        V = pt.FunctionSpace(mesh, pt.QkFEM(1, 2))
        cgm = pt.constraints(True, V, device=dev)
        go = pt.GridOperator(V, ConvectionDiffusionFEM(p), constraints=cgm, skip_boundary=True)
        x0 = pt.interpolate_dirichlet(p.g, V, cgm, V.zero(torch.float64, dev))
        slp = pt.StationaryLinearProblemSolver(go, pt.SEQ_CG_Jacobi(maxiter=20000),
                                               reduction=1e-10, verbose=0)
        x, s = timed(torch, lambda: slp.apply(x0))
        return V, go, x, slp.result.linear_solver_iterations, s

    Vu, _, xu, its_u, s_u = solve(pt.StructuredMesh([0, 0], [1, 1], (HANG_UNIFORM,) * 2))
    e_u = float(l2_difference(Vu, xu, p.exact))
    log(f"[phase 12d] uniform {HANG_UNIFORM}^2 Q1: N = {Vu.ndofs}, L2 {e_u:.6e}, Jacobi-CG "
        f"{its_u} iterations, {s_u:.3f} s")
    V, go, x, its, s = solve(pt.AdaptiveMesh([0, 0], [1, 1], (8, 8)))
    rows = []
    for cyc in range(HANG_MAX_CYCLES):
        e = float(l2_difference(V, x, p.exact))
        rows.append((V.ndofs, e))
        if V.ndofs >= HANG_TARGET:
            break
        t0 = time.perf_counter()
        eta2 = volume_residual_indicator(go, p, x)
        marks = eta2.cpu().numpy() >= error_fraction(eta2, 0.7)
        split = {"indicator+marking": time.perf_counter() - t0}
        V, x = adapt_local(V, x, marks, timings=split)
        t0 = time.perf_counter()
        nh = len(V.mesh.hanging_constraints()[0])      # kept on the mesh for constraints()
        split["hanging_constraints"] = time.perf_counter() - t0
        V, go, x, its, s = solve(V.mesh)
        log(f"[phase 12d] cycle {cyc}: N = {V.ndofs}, {V.mesh.nelements} leaves, "
            f"{nh} hanging rows, L2 {e:.6e} (before refining), Jacobi-CG {its} iterations "
            f"{s:.3f} s; s: " + ", ".join(f"{k} {v:.3f}" for k, v in split.items()))
    rng = np.random.default_rng(12)
    xr = torch.as_tensor(rng.standard_normal(V.ndofs), device=dev)
    z = torch.as_tensor(rng.standard_normal(V.ndofs), device=dev)
    y = go.jacobian_apply(xr, z)
    A = go.jacobian(xr)
    gap = float((torch.sparse.mm(A, z[:, None])[:, 0] - y).abs().max() / y.abs().max())
    better = [(n, e_) for n, e_ in rows if n <= Vu.ndofs and e_ < e_u]
    log(f"[phase 12d] final N = {rows[-1][0]}; first adaptive iterate below the uniform error: "
        f"{better[:1]}; assembled P^T J P vs jacobian_apply {gap:.3e} of max|y|; {CARD}")
    if not (better and rows[-1][0] >= HANG_TARGET and gap <= 1e-12):
        raise AssertionError(f"phase 12d holds failed: {rows}, gap {gap}")


def periodic_problem3():
    """tests/test_periodic.py:55-83: periodic in x and y, Dirichlet-0 in z."""
    import torch
    from dune_pdelab_tpu_torch.ops import ConvectionDiffusionProblem

    pi = math.pi

    class P3(ConvectionDiffusionProblem):
        def exact(self, q):
            return (torch.sin(2 * pi * q[:, 0]) * torch.sin(2 * pi * q[:, 1])
                    * torch.sin(pi * q[:, 2]))

        def f(self, x):
            return 9 * pi ** 2 * (torch.sin(2 * pi * x[..., 0]) * torch.sin(2 * pi * x[..., 1])
                                  * torch.sin(pi * x[..., 2]))

        def g(self, x):
            return torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    return P3()


def periodic_solves(torch, pt, dev):
    """Phase 12e: the periodic 3D Poisson of tests/test_periodic.py:55-83 at
    PERIODIC_CELLS^3 with its solver (Jacobi-CG, 1e-11), the fully periodic
    heat run (:85-114) at HEAT_PERIODIC_CELLS^2, and the fast tiers'
    declines."""
    from dune_pdelab_tpu_torch.assembly.structured_fused import (
        make_fused_japply, make_fused_residual,
    )
    from dune_pdelab_tpu_torch.instationary import OneStepMethod, crank_nicolson
    from dune_pdelab_tpu_torch.ops import ConvectionDiffusionFEM, ConvectionDiffusionProblem
    from dune_pdelab_tpu_torch.ops.l2 import L2
    from dune_pdelab_tpu_torch.space.functions import l2_difference

    p = periodic_problem3()
    errs, its = [], []
    for n in PERIODIC_CELLS:
        mesh = pt.StructuredMesh([0, 0, 0], [1, 1, 1], (n,) * 3, periodic=(True, True, False))
        V = pt.FunctionSpace(mesh, pt.QkFEM(1, 3))
        cgm = pt.constraints(True, V, device=dev)
        go = pt.GridOperator(V, ConvectionDiffusionFEM(p), constraints=cgm, skip_boundary=True)
        ls = pt.SEQ_CG_Jacobi(maxiter=5000)
        slp = pt.StationaryLinearProblemSolver(go, ls, reduction=1e-11, verbose=0)
        x, s = timed(torch, lambda: slp.apply(V.zero(torch.float64, dev)))
        errs.append(float(l2_difference(V, x, p.exact)))
        its.append(slp.result.linear_solver_iterations)
        log(f"[phase 12e] periodic 3D {n}^3: N = {V.ndofs}, L2 {errs[-1]:.6e}, Jacobi-CG "
            f"{its[-1]} iterations, converged {slp.result.converged}, {s:.3f} s")
        if not slp.result.converged:
            raise AssertionError("12e: periodic solve did not converge")
        tiers = ls.report().strip().splitlines()
        ell = pt.SEQ_CG_Jacobi(matrix_free=False, maxiter=1)
        ell.solve(go, V.zero(torch.float64, dev), go.residual(V.zero(torch.float64, dev)), 1e-1)
        k3 = make_fused_residual(go) is None and make_fused_japply(go) is None
        declined = [ln.strip() for ln in tiers + ell.report().strip().splitlines()
                    if "declined" in ln]
        log(f"[phase 12e] tiers at {n}^3: {declined}; K3 declined: {k3}")
        if not (k3 and any("compile_stencil declined" in ln for ln in declined)
                and any("assemble_ell declined" in ln for ln in declined)):
            raise AssertionError(f"12e: a fast tier did not decline: {declined}, K3 {k3}")
    ratio = errs[0] / errs[1]
    log(f"[phase 12e] L2 ratio {ratio:.4f}, iterations {its}")
    if not (3.0 <= ratio <= 5.0 and max(its) <= 5000 and errs[0] < 0.06):
        raise AssertionError(f"12e: ratio {ratio}, iterations {its}")

    decay = 8 * math.pi ** 2

    class Heat(ConvectionDiffusionProblem):
        def f(self, x):
            return torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)

    def u0(q):
        return torch.sin(2 * math.pi * q[:, 0]) * torch.sin(2 * math.pi * q[:, 1])

    n = HEAT_PERIODIC_CELLS
    V = pt.FunctionSpace(pt.StructuredMesh([0, 0], [1, 1], (n, n), periodic=(True, True)),
                         pt.QkFEM(1, 2))
    osm = OneStepMethod(crank_nicolson(),
                        pt.GridOperator(V, ConvectionDiffusionFEM(Heat()), skip_boundary=True),
                        pt.GridOperator(V, L2(), skip_boundary=True), pt.SEQ_CG_Jacobi(),
                        pdesolver="linear", reduction=1e-12)
    x = V.interpolate(u0, dtype=torch.float64, device=dev)
    t, dt, T = 0.0, 5e-4, 0.01
    t0 = time.perf_counter()
    while t < T - 1e-12:
        x = osm.apply(t, dt, x)
        t += dt
    torch.cuda.synchronize()
    err = float(l2_difference(V, x, lambda q: math.exp(-decay * t) * u0(q)))
    amp = float(x.abs().max()) / math.exp(-decay * t)
    log(f"[phase 12e] fully periodic heat {n}^2 CN, 20 steps: {time.perf_counter() - t0:.3f} s, "
        f"L2 {err:.3e}, decay ratio {amp:.6f}; {CARD}")
    if not (err < 5e-3 and 0.9 < amp < 1.1):
        raise AssertionError(f"12e heat: L2 {err}, ratio {amp}")


def annulus_mesh(pt, n, full=False):
    """The quarter annulus 1 <= r <= 2 (tests/test_mapped.py:31), or the full
    annulus with theta periodic (:178), as a mapped n^2 quad mesh."""
    import numpy as np

    idx = np.arange((n + 1) * (n + 1))
    r = 1.0 + (idx % (n + 1)) / n
    th = (2.0 if full else 0.5) * np.pi * (idx // (n + 1)) / n
    coords = np.stack([r * np.cos(th), r * np.sin(th)], axis=-1)
    return pt.StructuredMesh([0, 0], [1, 1], (n, n), coords=coords,
                             periodic=(False, True) if full else None)


def harmonic_problem(neumann=False):
    """tests/test_mapped.py:56 Harmonic (u = x^2 - y^2), with the Neumann
    flux on the outer arc (:148) when `neumann`."""
    import torch
    from dune_pdelab_tpu_torch.ops import ConvectionDiffusionProblem
    from dune_pdelab_tpu_torch.ops.convectiondiffusion import BCType

    class Harmonic(ConvectionDiffusionProblem):
        def exact(self, p):
            return p[:, 0] ** 2 - p[:, 1] ** 2

        def f(self, x):
            return torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)

        def g(self, x):
            return x[..., 0] ** 2 - x[..., 1] ** 2

        def bctype(self, x):
            x = torch.as_tensor(x)
            if not neumann:
                return torch.full(x.shape[:-1], BCType.DIRICHLET, device=x.device)
            # the outer arc: the test's r^2 > 3.9 band also takes in the
            # straight sides' last faces once h < 0.025 (n > 40), so the
            # sides (x = 0, y = 0) are excluded by position
            r2 = x[..., 0] ** 2 + x[..., 1] ** 2
            side = torch.minimum(x[..., 0].abs(), x[..., 1].abs()) < 1e-9
            return torch.where((r2 > 2.25) & ~side, BCType.NEUMANN, BCType.DIRICHLET)

        def j(self, x):
            r = torch.sqrt(x[..., 0] ** 2 + x[..., 1] ** 2)
            return -(2 * x[..., 0] ** 2 - 2 * x[..., 1] ** 2) / r
    return Harmonic()


def mapped_solves(torch, pt, dev):
    """Phase 12f: the curved Dirichlet and Neumann-arc Poisson problems of
    tests/test_mapped.py:121-175 at MAPPED_CELLS^2 (AMG-CG to 1e-12), the
    mapped-periodic full annulus (:222-262), SIPG on the curved mesh
    (tests/test_mapped_skeleton.py) at MAPPED_DG_CELLS^2, and the mapped
    operator against the uniform one on the identity map."""
    import numpy as np
    from dune_pdelab_tpu_torch.ops import ConvectionDiffusionFEM
    from dune_pdelab_tpu_torch.ops.convectiondiffusiondg import ConvectionDiffusionDG
    from dune_pdelab_tpu_torch.space.functions import l2_difference

    for name, full, neumann in (("Dirichlet", False, False), ("Neumann arc", False, True),
                                ("periodic full annulus", True, False)):
        p = harmonic_problem(neumann)
        errs = []
        for n in MAPPED_CELLS:
            V = pt.FunctionSpace(annulus_mesh(pt, n, full), pt.QkFEM(1, 2))
            cgm = pt.constraints(p.dirichlet_bctype(), V, device=dev)
            go = pt.GridOperator(V, ConvectionDiffusionFEM(p), constraints=cgm)
            x0 = pt.interpolate_dirichlet(p.g, V, cgm, V.zero(torch.float64, dev))
            slp = pt.StationaryLinearProblemSolver(go, pt.SEQ_CG_AMG(**ADAPT_AMG),
                                                   reduction=1e-12, verbose=0)
            x, s = timed(torch, lambda: slp.apply(x0))
            errs.append(float(l2_difference(V, x, p.exact)))
            log(f"[phase 12f] {name} {n}^2 Q1: N = {V.ndofs}, L2 {errs[-1]:.6e}, AMG-CG "
                f"{slp.result.linear_solver_iterations} iterations, {s:.3f} s")
            if not slp.result.converged:
                raise AssertionError(f"12f {name}: no convergence")
        ratio = errs[0] / errs[1]
        log(f"[phase 12f] {name}: L2 ratio {ratio:.4f}")
        if not 3.0 <= ratio <= 5.0:
            raise AssertionError(f"12f {name}: L2 ratio {ratio}")
    m = annulus_mesh(pt, 8, True)
    gf, gc = m.refine().coords.reshape(17, 17, 2), m.coords.reshape(9, 9, 2)
    if not (m.nvertices == 72 and np.allclose(gf[::2, ::2], gc) and np.allclose(gf[0], gf[-1])):
        raise AssertionError("12f: mapped periodic closure broken")

    p = harmonic_problem()
    errs = []
    for n in MAPPED_DG_CELLS:
        V = pt.FunctionSpace(annulus_mesh(pt, n), pt.QkDGFEM(1, 2))
        go = pt.GridOperator(V, ConvectionDiffusionDG(p))
        slp = pt.StationaryLinearProblemSolver(
            go, pt.LinearSolverBackend(solver="cg", precond=pt.DGTwoLevel(
                go, ConvectionDiffusionFEM(p), coarse="amg", amg_kwargs=ADAPT_AMG,
                device=dev)), reduction=1e-10, verbose=0)
        x, s = timed(torch, lambda: slp.apply(V.zero(torch.float64, dev)))
        errs.append(float(l2_difference(V, x, p.exact)))
        log(f"[phase 12f] SIPG Q1 on the curved mesh {n}^2: N = {V.ndofs}, L2 "
            f"{errs[-1]:.6e}, DGTwoLevel(amg)-CG {slp.result.linear_solver_iterations} "
            f"iterations, {s:.3f} s")
    ratio = errs[0] / errs[1]
    if not 3.0 <= ratio <= 5.0:
        raise AssertionError(f"12f SIPG: L2 ratio {ratio}")

    n = 64
    uni = pt.StructuredMesh([0, 0], [1, 1], (n, n))
    ident = pt.StructuredMesh([0, 0], [1, 1], (n, n), coords=uni.vertex_coords().copy())
    g = torch.Generator(dev).manual_seed(12)
    outs = []
    for mesh in (uni, ident):
        V = pt.FunctionSpace(mesh, pt.QkFEM(1, 2))
        go = pt.GridOperator(V, ConvectionDiffusionFEM(harmonic_problem(True)),
                             constraints=pt.constraints(True, V, device=dev))
        xr = torch.randn(V.ndofs, dtype=torch.float64, device=dev, generator=g)
        outs.append((go.residual(xr), go.jacobian_apply(xr, xr)))
        g.manual_seed(12)
    gap = max(float((a - b).abs().max() / b.abs().max()) for a, b in zip(*outs))
    log(f"[phase 12f] identity map vs uniform at {n}^2: residual and J.v gap {gap:.3e} of "
        f"max|y|; {CARD}")
    if gap > 1e-12:
        raise AssertionError(f"12f identity map: {gap}")


def sincos_problem():
    import torch
    from dune_pdelab_tpu_torch.ops import ConvectionDiffusionProblem

    pi = math.pi

    class SinSin(ConvectionDiffusionProblem):
        def exact(self, p):
            return torch.sin(pi * p[:, 0]) * torch.sin(pi * p[:, 1]) + p[:, 0]

        def f(self, x):
            return 2 * pi ** 2 * torch.sin(pi * x[..., 0]) * torch.sin(pi * x[..., 1])

        def g(self, x):
            return torch.sin(pi * x[..., 0]) * torch.sin(pi * x[..., 1]) + x[..., 0]
    return SinSin()


def simplex_dg(torch, pt, dev):
    """Phase 12g: SIPG PkDGFEM(1, 2) on 2D simplices at SIMPLEX_DG_CELLS^2
    with CG + DGTwoLevel (P1 subspace, AMG coarse); at 32^2 the residual and
    J.v on the card against the CPU and the interior-face residual twice
    bit-equal; dwr_indicators, dg_jump_indicator and MinmodSlopeLimiter at
    the sizes of their JAX tests, card against CPU."""
    from dune_pdelab_tpu_torch.adaptivity import (
        MinmodSlopeLimiter, dg_jump_indicator, dwr_indicators,
    )
    from dune_pdelab_tpu_torch.ops import ConvectionDiffusionFEM
    from dune_pdelab_tpu_torch.ops.convectiondiffusiondg import ConvectionDiffusionDG
    from dune_pdelab_tpu_torch.ops.l2 import L2
    from dune_pdelab_tpu_torch.space.functions import l2_difference

    cpu = torch.device("cpu")
    p = sincos_problem()
    errs, its = [], []
    for n in SIMPLEX_DG_CELLS:
        V = pt.FunctionSpace(pt.SimplexMesh.from_structured(
            pt.StructuredMesh([0, 0], [1, 1], (n, n))), pt.PkDGFEM(1, 2))
        go = pt.GridOperator(V, ConvectionDiffusionDG(p))
        tl = pt.DGTwoLevel(go, ConvectionDiffusionFEM(p), amg_kwargs=ADAPT_AMG, device=dev)
        x0 = V.zero(torch.float64, dev)
        _, setup_s = timed(torch, lambda: tl.setup(x0))
        slp = pt.StationaryLinearProblemSolver(
            go, pt.LinearSolverBackend(solver="cg", precond=tl), reduction=1e-10, verbose=0)
        x, s = timed(torch, lambda: slp.apply(x0))
        errs.append(float(l2_difference(V, x, p.exact)))
        its.append(slp.result.linear_solver_iterations)
        log(f"[phase 12g] SIPG P1 simplex {n}^2: N = {V.ndofs}, {len(go.skel_groups)} skeleton "
            f"+ {len(go.bnd_groups)} boundary groups, L2 {errs[-1]:.6e}, DGTwoLevel(amg)-CG "
            f"{its[-1]} iterations, setup {setup_s:.3f} s, solve {s:.3f} s")
        if not slp.result.converged:
            raise AssertionError("12g: SIPG solve did not converge")
    ratio = errs[0] / errs[1]
    log(f"[phase 12g] L2 ratio {ratio:.4f}, iterations {its}")
    if not (3.0 <= ratio <= 5.0 and max(its) - min(its) <= 3 and max(its) <= 50):
        raise AssertionError(f"12g: ratio {ratio}, iterations {its}")

    def both(build):
        """build(device) -> tensor on that device, for the card and the CPU."""
        a, b = build(dev), build(cpu)
        return float((a.cpu() - b).abs().max() / b.abs().max())

    V = pt.FunctionSpace(pt.SimplexMesh.from_structured(
        pt.StructuredMesh([0, 0], [1, 1], (32, 32))), pt.PkDGFEM(1, 2))
    go = pt.GridOperator(V, ConvectionDiffusionDG(p))
    xs = torch.randn(V.ndofs, dtype=torch.float64, generator=torch.Generator().manual_seed(7))
    gaps = {"residual": both(lambda d: go.residual(xs.to(d))),
            "J.v": both(lambda d: go.jacobian_apply(xs.to(d), xs.to(d).flip(0)))}
    r1 = go.residual_unconstrained(xs.to(dev))
    r2 = go.residual_unconstrained(xs.to(dev))
    gaps["dg_jump_indicator"] = both(lambda d: dg_jump_indicator(go, xs.to(d)))

    Vq = pt.FunctionSpace(pt.StructuredMesh([0, 0], [1, 1], (16, 16)), pt.QkDGFEM(1, 2))
    xq = torch.randn(Vq.ndofs, dtype=torch.float64, generator=torch.Generator().manual_seed(8))
    gaps["MinmodSlopeLimiter"] = both(lambda d: MinmodSlopeLimiter(Vq)(xq.to(d)))

    def dwr(d):
        mesh = pt.StructuredMesh([0, 0], [1, 1], (12, 12))
        Vl, Vr = pt.FunctionSpace(mesh, pt.QkFEM(1, 2)), pt.FunctionSpace(mesh, pt.QkFEM(2, 2))
        gol = pt.GridOperator(Vl, ConvectionDiffusionFEM(p),
                              constraints=pt.constraints(True, Vl, device=d))
        gor = pt.GridOperator(Vr, ConvectionDiffusionFEM(p),
                              constraints=pt.constraints(True, Vr, device=d))
        q = pt.GridOperator(Vr, L2()).jacobian_apply(
            Vr.zero(torch.float64, d), torch.ones(Vr.ndofs, dtype=torch.float64, device=d))
        xl = torch.linspace(0, 1, Vl.ndofs, dtype=torch.float64, device=d)
        return dwr_indicators(gol, gor, xl, lambda u: torch.dot(q, u))[0]

    gaps["dwr_indicators"] = both(dwr)
    log(f"[phase 12g] card vs CPU (of max|y|): {gaps}; interior-face residual twice "
        f"bit-equal: {bool(torch.equal(r1, r2))}; {CARD}")
    if not (torch.equal(r1, r2) and all(v <= 1e-12 for k, v in gaps.items()
                                        if k != "dwr_indicators")
            and gaps["dwr_indicators"] <= 1e-9):
        raise AssertionError(f"12g card vs CPU: {gaps}")


def phase_adaptivity(torch, pt, dev):
    """Phase 12: adaptivity and mesh breadth, fp64. No hand kernel applies
    (K1-K6 decline simplex, periodic, mapped and hanging-node operators);
    every apply is the general torch.func.jvp, the AMG cycle plain torch,
    the mesh work host numpy."""
    for name, run in (("12a", adapt_config6), ("12b", adapt_lshape_full),
                      ("12c", adapt_fichera), ("12d", adapt_hanging), ("12e", periodic_solves),
                      ("12f", mapped_solves), ("12g", simplex_dg)):
        t0 = time.perf_counter()
        run(torch, pt, dev)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        log(f"[phase {name}] {time.perf_counter() - t0:.2f} s")


# ---------------------------------------------------------------- phase 13

def p0_diffusion_problem(dim):
    """tests/test_ccfv.py's Diff (and its 3D extension): -lap u = f with
    u = prod_d sin(pi x_d), homogeneous Dirichlet data."""
    import torch
    from dune_pdelab_tpu_torch.ops import ConvectionDiffusionProblem

    pi = math.pi

    class Diff(ConvectionDiffusionProblem):
        def exact(self, p):
            out = torch.ones(p.shape[:-1], dtype=p.dtype, device=p.device)
            for d in range(dim):
                out = out * torch.sin(pi * p[..., d])
            return out

        def f(self, x):
            return dim * pi ** 2 * self.exact(x)
    return Diff()


def upwind_problem():
    """tests/test_ccfv.py:49-64: nearly pure upwinded advection, inflow 1
    on x = 0."""
    import torch
    from dune_pdelab_tpu_torch.ops import ConvectionDiffusionProblem

    class T(ConvectionDiffusionProblem):
        def A(self, x):
            return 1e-8

        def b(self, x):
            return torch.broadcast_to(torch.tensor([1.0, 0.3], dtype=x.dtype,
                                                   device=x.device), x.shape)

        def g(self, x):
            return torch.where(x[..., 0] < 1e-12, 1.0, 0.0).to(x.dtype)
    return T()


def modal_problem(dim):
    """tests/test_fe_zoo.py:64-81 (SinCos, 2D) and a 3D counterpart:
    u = sin(pi x) cos(2 pi y) [cos(pi z)] + x."""
    import torch
    from dune_pdelab_tpu_torch.ops import ConvectionDiffusionProblem

    pi = math.pi

    class SinCos(ConvectionDiffusionProblem):
        def _w(self, x):
            w = torch.sin(pi * x[..., 0]) * torch.cos(2 * pi * x[..., 1])
            return w * torch.cos(pi * x[..., 2]) if dim == 3 else w

        def exact(self, p):
            return self._w(p) + p[..., 0]

        def f(self, x):
            return (5 + (dim == 3)) * pi ** 2 * self._w(x)

        def g(self, x):
            return self._w(x) + x[..., 0]
    return SinCos()


def p0_space(pt, cells, upper=None, geometry="cube", periodic=None):
    from dune_pdelab_tpu_torch.fe import P0FEM
    dim = len(cells)
    mesh = pt.StructuredMesh([0.0] * dim, upper or [1.0] * dim, cells, periodic=periodic)
    if geometry == "simplex":
        mesh = pt.SimplexMesh.from_structured(mesh)
    return mesh, pt.FunctionSpace(mesh, P0FEM(dim, geometry))


def p13_operator(pt, kind, cells):
    """(space, GridOperator) of a phase 13 kernel case: `ccfv` (13c's
    diffusion CCFV, nb = 1) or SIPG on the modal basis `kind` of 13d
    (k = 2 in 2D, k = 1 in 3D)."""
    from dune_pdelab_tpu_torch import fe
    from dune_pdelab_tpu_torch.ops import ConvectionDiffusionCCFV, ConvectionDiffusionDG
    dim = len(cells)
    if kind == "ccfv":
        _, V = p0_space(pt, cells)
        return V, pt.GridOperator(V, ConvectionDiffusionCCFV(p0_diffusion_problem(dim)))
    mesh = pt.StructuredMesh([0.0] * dim, [1.0] * dim, cells)
    V = pt.FunctionSpace(mesh, getattr(fe, kind)(2 if dim == 2 else 1, dim))
    return V, pt.GridOperator(V, ConvectionDiffusionDG(modal_problem(dim)))


def p13_kernels(torch, pt, dev):
    """Phase 13k: block_stencil_mm / block_stencil_em at every new (dim,
    nb) of P13_KERNEL_CASES against their plain versions, fp32 and fp64 to
    BLOCK_TOL, a repeated launch bit-equal; kernel, plain and convolution
    times against block_work's bound. Launches not counted."""
    import numpy as np
    from dune_pdelab_tpu_torch.assembly.blockstencil import compile_block_stencil
    from dune_pdelab_tpu_torch.assembly.blockstencil_mm import try_mm_block_stencil
    from dune_pdelab_tpu_torch.kernels import blockstencil as bk

    saved = bk.launches_mm, bk.launches_em
    rng = np.random.default_rng(130)
    for kind, cells, layouts in P13_KERNEL_CASES:
        _, go = p13_operator(pt, kind, cells)
        st = compile_block_stencil(go, dtype=torch.float64, device=dev)
        if st is None:
            raise AssertionError(f"13k: compile_block_stencil declined {kind} {cells}")
        for dtype in (torch.float32, torch.float64):
            W, dD = st.taps(dtype, dev)
            nb = st.nb
            z = torch.as_tensor(rng.standard_normal(st.ndofs), dtype=dtype, device=dev)
            ch, rows = bk.shared_plan(dtype, nb)
            path = bk.block_path(dtype, nb)
            plan = f"{path} path" + (f", ch {ch}, {rows} rows" if path == "shared" else "")
            tag = (f"{kind} {'x'.join(map(str, cells))} nb={nb} "
                   f"{str(dtype).replace('torch.', '')}")
            nbytes, flops = block_work(cells, nb, z.element_size())
            for layout in layouts:
                arg = try_mm_block_stencil(st).to_mm(z) if layout == "mm" else z
                fn = getattr(bk, f"block_stencil_{layout}")
                ref = getattr(bk, f"block_stencil_{layout}_reference")
                run = lambda: fn(arg, W, dD, cells)
                plain = lambda: ref(arg, W, dD, cells)
                y, y_p, y2 = run(), plain(), run()
                torch.cuda.synchronize()
                err = block_err(f"13k block_stencil_{layout} {tag}", y, y_p)
                if not torch.equal(y, y2):
                    raise AssertionError(f"13k block_stencil_{layout} {tag}: repeat differs")
                ms = cuda_ms(torch, run, 50)
                plain_ms = cuda_ms(torch, plain, 10)
                lib_ms = conv_ms(torch, z, W, cells, 20)
                b = bound(nbytes, flops)
                log(f"[phase 13k] block_stencil_{layout} {tag} ({plan}): max abs err "
                    f"{err:.3e} (max|y| {float(y_p.abs().max()):.3e}), repeat bit-equal, "
                    f"{ms:.4f} ms, graph replay {graph_ms(torch, run, 200):.4f} ms, plain "
                    f"{plain_ms:.4f} ms, conv {lib_ms:.4f} ms; bound {b['bound_ms']:.4f} ms "
                    f"({b['bound_by']}), kernel at {100 * b['bound_ms'] / ms:.1f}% of it")
                del y, y_p, y2, arg
            del z
        del go, st
        torch.cuda.empty_cache()
    bk.launches_mm, bk.launches_em = saved


def peak_gib(torch):
    return torch.cuda.max_memory_allocated() / 2 ** 30


def displacement_params():
    """models/configs.py config11's Displacement: the wetting phase floods
    in from x = 0, outflow at x = 1."""
    import torch
    from dune_pdelab_tpu_torch.ops.twophase import TwoPhaseParameters

    class Displacement(TwoPhaseParameters):
        def is_dirichlet(self, x):
            return (x[..., 0] < 1e-9) | (x[..., 0] > 1 - 1e-9)

        def g_l(self, x):
            return torch.where(x[..., 0] < 0.5, 2.0, 0.0).to(x.dtype)

        def g_g(self, x):
            return torch.where(x[..., 0] < 0.5, 1.5, 1.5).to(x.dtype)
    return Displacement(phi=0.2, K=1.0, mu_l=1.0, mu_g=0.2, pc_scale=1.0)


def twophase_setup(torch, pt, cells, dev, upper=(1.0, 0.25), prm=None, reduction=1e-7,
                   min_lin=1e-4, start=(0.0, 0.5), periodic=None):
    """config11's discretisation on `cells` (implicit Euler, Newton,
    SEQ_BCGS_Jacobi): (mesh, W, osm, backend, x0), x0 = (p_l, p_g) = start
    in fp64 on dev."""
    from dune_pdelab_tpu_torch.instationary import OneStepMethod, implicit_euler
    from dune_pdelab_tpu_torch.ops.twophase import TwoPhaseCCFV, TwoPhaseStorage
    mesh, V = p0_space(pt, cells, list(upper), periodic=periodic)
    W = pt.PowerSpace(V, 2)
    prm = prm or displacement_params()
    backend = pt.SEQ_BCGS_Jacobi()
    osm = OneStepMethod(implicit_euler(), pt.GridOperator(W, TwoPhaseCCFV(prm)),
                        pt.GridOperator(W, TwoPhaseStorage(prm)), backend,
                        pdesolver="newton", reduction=reduction, max_iterations=40,
                        min_linear_reduction=min_lin)
    E = mesh.nelements
    x0 = torch.cat([torch.full((E,), start[0], dtype=torch.float64, device=dev),
                    torch.full((E,), start[1], dtype=torch.float64, device=dev)])
    return mesh, W, osm, backend, x0


def s_liquid(W, x):
    """config11's saturation sigmoid(4 (1/2 - (p_g - p_l)))."""
    pl, pg = W.restrict(x, 0), W.restrict(x, 1)
    return 1.0 / (1.0 + (-4.0 * (0.5 - (pg - pl))).exp())


def twophase_config11(torch, pt, dev):
    """Phase 13a: config11 through the port's ALL_CONFIGS on the card, held
    to tests/golden_parity.json: 34 Newton iterations, 2 failed steps, 96
    DOFs, t_final 0.008, s_inlet / s_outlet to 1e-8, its Krylov applies
    replayed from CUDA graphs (solvers/linear.py GraphedApply)."""
    from dune_pdelab_tpu_torch.models import ALL_CONFIGS

    gold = json.loads((ROOT / "tests" / "golden_parity.json").read_text())[
        "config11_twophase_displacement"]
    torch.cuda.reset_peak_memory_stats()
    info = {}
    got, s = timed(torch, lambda: ALL_CONFIGS["config11"](device=dev, info=info))
    osm = info["solver"]
    path = info["ls"].report(osm.igos)
    log(f"[phase 13a] config11 fp64 (N = {got['ndofs']}): {got['newton_iterations']} Newton "
        f"iterations, {got['failed_steps']} failed steps, "
        f"{osm.result.total_linear_iterations} BiCGStab iterations, t_final "
        f"{got['t_final']}, s_inlet {got['s_inlet']!r} (golden {gold['s_inlet']!r}), "
        f"s_outlet {got['s_outlet']!r} (golden {gold['s_outlet']!r}), {s:.2f} s, peak "
        f"{peak_gib(torch):.3f} GiB; {'; '.join(path.splitlines())}")
    if dev.type == "cuda" and ("CUDA graph replay" not in path or "graph declined" in path):
        raise AssertionError(f"13a: the general-jvp apply was not replayed from a graph: {path}")
    for key in ("newton_iterations", "failed_steps", "ndofs", "t_final"):
        if got[key] != gold[key]:
            raise AssertionError(f"13a config11 {key}: {got[key]} != golden {gold[key]}")
    for key in ("s_inlet", "s_outlet"):
        if not abs(got[key] - gold[key]) <= 1e-8:
            raise AssertionError(f"13a config11 {key}: {got[key]!r} vs {gold[key]!r}")


def twophase_small(torch, pt, dev):
    """config11's first three steps at TP_SMALL_CELLS x 4 on dev: (Newton
    iterations per step, failed steps, final state as numpy)."""
    _, _, osm_s, _, xs = twophase_setup(torch, pt, (TP_SMALL_CELLS, 4), dev)
    steps, t = [], 0.0
    for _ in range(3):
        n0 = osm_s.result.total_newton_iterations
        t, xs = osm_s.solve(t, 1e-3, t + 1e-3, xs, max_step_retries=4)
        steps.append(osm_s.result.total_newton_iterations - n0)
    return steps, osm_s.result.failed_steps, xs.cpu().numpy()


def twophase_small_cpu(group):
    """twophase_small on the CPU, in a process of its own (cpu_aside)."""
    import torch
    import dune_pdelab_tpu_torch as pt
    return twophase_small(torch, pt, torch.device("cpu"))


def twophase_at_size(torch, pt, dev, aside):
    """Phase 13b: config11's problem on TP_CELLS (periodic in y),
    implicit Euler steps of 1e-3 to TP_TEND with config11's Newton and
    BiCGStab settings: every row of cells equal to the first (the problem
    is 1D in x) to 1e-8, s_l in [0, 1] to 1e-8; the wells problem;
    config11's first three steps at TP_SMALL_CELLS x 4 on the card against
    the CPU (computed beside it in a CPU process of its own, `aside`)."""
    import numpy as np
    torch.cuda.reset_peak_memory_stats()
    mesh, W, osm, backend, x = twophase_setup(torch, pt, TP_CELLS, dev, (1.0, TP_HEIGHT),
                                              periodic=(False, True))
    spent = {"japply": [0.0, 0]}
    osm.igos.jacobian_apply = synced_timer(torch, spent, "japply", osm.igos.jacobian_apply)
    res = osm.result
    t, total = 0.0, 0.0
    while t < TP_TEND - 1e-12:
        n0, l0, f0 = res.total_newton_iterations, res.total_linear_iterations, res.failed_steps
        (t_new, x), s = timed(torch, lambda: osm.solve(t, 1e-3, t + 1e-3, x,
                                                       max_step_retries=4))
        total += s
        log(f"[phase 13b] step to t = {t_new:.4f}: {res.total_newton_iterations - n0} Newton, "
            f"{res.total_linear_iterations - l0} BiCGStab iterations, "
            f"{res.failed_steps - f0} failed steps, {s:.2f} s")
        t = t_new
    nx, ny = TP_CELLS
    rows = [W.restrict(x, c).reshape(ny, nx) for c in (0, 1)]
    row_gap = max(float((r - r[:1]).abs().max()) for r in rows)
    s_l = s_liquid(W, x)
    lo, hi = float(s_l.min()), float(s_l.max())
    log(f"[phase 13b] displacement {nx}x{ny} (N = {W.ndofs}) to t = {t}: "
        f"{res.total_newton_iterations} Newton, {res.total_linear_iterations} BiCGStab "
        f"iterations, {res.failed_steps} failed steps, {total / res.steps:.2f} s per step, "
        f"jacobian_apply {spent['japply'][1]} calls {spent['japply'][0]:.2f} s = "
        f"{100 * spent['japply'][0] / total:.1f}% of it; rows vs the first {row_gap:.3e}, "
        f"s_l in [{lo:.6f}, {hi:.6f}], peak {peak_gib(torch):.3f} GiB; "
        f"{'; '.join(backend.report(osm.igos).splitlines())}; {CARD}")
    if not (row_gap <= 1e-8 and lo >= -1e-8 and hi <= 1 + 1e-8):
        raise AssertionError(f"13b: rows {row_gap}, s_l in [{lo}, {hi}]")
    twophase_wells(torch, pt, dev)
    card = twophase_small(torch, pt, dev)
    host = aside_result(aside)
    gap = float(np.abs(card[2] - host[2]).max() / np.abs(host[2]).max())
    log(f"[phase 13b] config11 {TP_SMALL_CELLS}x4, 3 steps: Newton per step card "
        f"{card[0]} / CPU {host[0]}, failed {card[1]} / {host[1]}, states {gap:.3e} of max|x|")
    if card[:2] != host[:2] or not gap <= TP_SMALL_TOL:
        raise AssertionError(f"13b card vs CPU: {card[:2]} {host[:2]} {gap}")


def twophase_wells(torch, pt, dev):
    """Phase 13b: the wells problem of tests/test_twophase.py:79-127 at
    TP_WELLS_CELLS^2: each phase's storage changes per step by the
    injected amount to TP_WELLS_REL relative."""
    from dune_pdelab_tpu_torch.ops.twophase import TwoPhaseParameters
    n = TP_WELLS_CELLS
    Q, hx = 0.05, 1.0 / n

    class Wells(TwoPhaseParameters):
        def q_l(self, x):                            # injector at (0, 0)
            return torch.where((x[..., 0] < hx) & (x[..., 1] < hx), Q, 0.0).to(x.dtype)

        def q_g(self, x):                            # producer at (1, 1)
            return torch.where((x[..., 0] > 1 - hx) & (x[..., 1] > 1 - hx), -Q,
                               0.0).to(x.dtype)

    mesh, W, osm, _, x = twophase_setup(torch, pt, (n, n), dev, (1.0, 1.0),
                                        Wells(phi=0.2, pc_scale=2.0), 1e-10, 1e-5, (0.0, 1.0))
    E = mesh.nelements
    go1 = osm.igos.go1

    def masses(v):
        m = go1.residual_unconstrained(v)
        return float(m[:E].sum()), float(m[E:].sum())

    m0 = masses(x)
    t, dt, worst = 0.0, 0.01, 0.0
    for step in range(3):
        n0, l0 = osm.result.total_newton_iterations, osm.result.total_linear_iterations
        x, s = timed(torch, lambda: osm.apply(t, dt, x))
        t += dt
        m = masses(x)
        want = (step + 1) * dt * Q * hx * hx
        rel = max(abs((m[0] - m0[0]) - want), abs((m[1] - m0[1]) + want)) / want
        worst = max(worst, rel)
        log(f"[phase 13b] wells {n}^2 step {step + 1}: "
            f"{osm.result.total_newton_iterations - n0} Newton, "
            f"{osm.result.total_linear_iterations - l0} BiCGStab iterations, {s:.2f} s; "
            f"storage change vs injected: rel {rel:.3e}; "
            f"{'; '.join(osm.pdesolver.ls.report(osm.igos).splitlines())}")
    if not worst <= TP_WELLS_REL:
        raise AssertionError(f"13b wells: mass balance off by {worst}")


def ccfv_solves(torch, pt, dev):
    """Phase 13c: CCFV diffusion at CCFV_2D^2 (K6, nb = 1) and CCFV_3D^3
    (K5, nb = 1) with SEQ_CG_Jacobi to 1e-10 (center error order > 1.7),
    the upwind transport (upwind_runs), and the Darcy reconstruction on the
    largest 2D head: per cell, the RT0 fluxes' imbalance minus the source
    equals the solver's residual to 1e-10 of the largest face flux. Every
    Krylov solve's report names the block-stencil tier."""
    import numpy as np
    from dune_pdelab_tpu_torch.ops import ConvectionDiffusionCCFV, DarcyVelocityFromHeadCCFV

    def solve(problem, cells, backend, tag, tier="compiled block stencil", held=True):
        torch.cuda.reset_peak_memory_stats()
        mesh, V = p0_space(pt, cells)
        go = pt.GridOperator(V, ConvectionDiffusionCCFV(problem))
        slp = pt.StationaryLinearProblemSolver(go, backend, reduction=1e-10, verbose=0)
        x, s = timed(torch, lambda: slp.apply(V.zero(torch.float64, dev)))
        path = (backend.report(go).splitlines()[0] if hasattr(backend, "report")
                else f"solve path: {type(backend).__name__} (host sparse LU)")
        log(f"[phase 13c] {tag} {'x'.join(map(str, cells))} (N = {V.ndofs}): "
            f"{slp.result.linear_solver_iterations} iterations, {s:.2f} s, converged "
            f"{slp.result.converged}, peak {peak_gib(torch):.3f} GiB; {path}")
        if tier not in path or (held and not slp.result.converged):
            raise AssertionError(f"13c {tag}: converged {slp.result.converged}, {path}")
        return mesh, go, x

    head = None
    for dim, sizes in ((2, CCFV_2D), (3, CCFV_3D)):
        p = p0_diffusion_problem(dim)
        errs = []
        for n in sizes:
            mesh, go, x = solve(p, (n,) * dim, pt.SEQ_CG_Jacobi(), f"diffusion {dim}D CG")
            c = torch.as_tensor(mesh.element_centers(), device=dev)
            errs.append(float(((x - p.exact(c)) ** 2).mean().sqrt()))
            if dim == 2:
                head = (mesh, go, x)
        order = math.log2(errs[-2] / errs[-1])
        log(f"[phase 13c] diffusion {dim}D: center RMS errors {errs}, order {order:.3f}")
        if not order > CCFV_ORDER_MIN:
            raise AssertionError(f"13c {dim}D order {order}")
    upwind_runs(torch, pt, dev, solve)
    mesh, go, x = head
    p = p0_diffusion_problem(2)
    dv, s = timed(torch, lambda: DarcyVelocityFromHeadCCFV(mesh, p, x))
    vol = float(np.prod(mesh.h))
    fmid = p.f(torch.as_tensor(mesh.element_centers(), dtype=torch.float64)).numpy()
    r = go.residual(x).cpu().numpy()                  # outward fluxes - source, per cell
    gap = float(np.abs(dv.cell_divergence() * vol - fmid * vol - r).max())
    fmax = max(float(np.abs(V).max()) * vol / h for V, h in zip(dv.face_normal_velocities(),
                                                                 mesh.h))
    div_rel = float(np.abs(dv.cell_divergence() - fmid).max() / np.abs(fmid).max())
    log(f"[phase 13c] Darcy RT0 on the {mesh.cells[0]}^2 head: reconstruction {s:.2f} s; "
        f"per-cell imbalance minus the solver's residual {gap:.3e} (largest face flux "
        f"{fmax:.3e}); |div v - f| / max|f| = {div_rel:.3e}")
    if not gap <= 1e-10 * fmax:
        raise AssertionError(f"13c Darcy conservation {gap} > 1e-10 * {fmax}")


def upwind_runs(torch, pt, dev, solve):
    """Phase 13c: the upwind transport of tests/test_ccfv.py:49-64 with
    SEQ_BCGS_Jacobi on the block-stencil tier at CCFV_UPWIND_SMALL^2, held
    to the test's [-1e-6, 1 + 1e-6], and at CCFV_UPWIND^2, where Jacobi-
    BiCGStab breaks down in the JAX package too (its outcome is logged, not
    held); at CCFV_UPWIND^2 the bounds are held on SEQ_SuperLU's solution of
    the same system."""
    from dune_pdelab_tpu_torch.solvers import SEQ_SuperLU

    def bounds(x, tag):
        lo, hi = float(x.min()), float(x.max())
        log(f"[phase 13c] {tag}: solution in [{lo:.3e}, 1 {hi - 1:+.3e}], finite "
            f"{bool(x.isfinite().all())}")
        return lo, hi

    for n, backend, tag, held in (
            (CCFV_UPWIND_SMALL, pt.SEQ_BCGS_Jacobi(), "upwind BiCGStab", True),
            (CCFV_UPWIND, pt.SEQ_BCGS_Jacobi(), "upwind BiCGStab (logged only)", False),
            (CCFV_UPWIND, SEQ_SuperLU(), "upwind SuperLU", True)):
        tier = "compiled block stencil" if "BiCGStab" in tag else ""
        _, _, x = solve(upwind_problem(), (n, n), backend, tag, tier, held)
        lo, hi = bounds(x, f"{tag} {n}^2")
        if held and not (lo >= -1e-6 and hi <= 1 + 1e-6):
            raise AssertionError(f"13c {tag} {n}^2 bounds [{lo}, {hi}]")


def modal_solves(torch, pt, dev):
    """Phase 13d: SIPG on MonomialDGFEM(2, 2), OPBFEM(2, 2) (nb = 6) and
    LegendreDGFEM(2, 2) (nb = 9) at MODAL_CELLS^2 with SEQ_BCGS_Jacobi to
    1e-11 (L2 order > 2.5), MonomialDGFEM(1, 3) at MODAL_3D_CELLS^3 (nb = 4,
    K5), and variable order at VARORDER_CELLS^2 against the truncated
    lower-order space (tests/test_variableorder.py:62-85)."""
    import numpy as np
    from dune_pdelab_tpu_torch import fe
    from dune_pdelab_tpu_torch.constraints.variableorder import p_adaptive_constraints
    from dune_pdelab_tpu_torch.ops import ConvectionDiffusionDG, DGMethod
    from dune_pdelab_tpu_torch.space.functions import l2_difference

    def solve(V, p, tag, cg_=None, penalty=2.0, quad_order=None):
        torch.cuda.reset_peak_memory_stats()
        go = pt.GridOperator(V, ConvectionDiffusionDG(p, method=DGMethod.SIPG,
                                                      penalty=penalty),
                             constraints=cg_, quad_order=quad_order)
        backend = pt.SEQ_BCGS_Jacobi(maxiter=40000)
        slp = pt.StationaryLinearProblemSolver(go, backend, reduction=1e-11, verbose=0)
        x, s = timed(torch, lambda: slp.apply(V.zero(torch.float64, dev)))
        err = float(l2_difference(V, x, p.exact))
        path = backend.report(go).splitlines()[0]
        log(f"[phase 13d] {tag} (N = {V.ndofs}): {slp.result.linear_solver_iterations} "
            f"BiCGStab iterations, {s:.2f} s, L2 {err:.6e}, peak {peak_gib(torch):.3f} GiB; "
            f"{path}")
        if not slp.result.converged:
            raise AssertionError(f"13d {tag} did not converge")
        return x, err, path

    p2 = modal_problem(2)
    for name in ("MonomialDGFEM", "OPBFEM", "LegendreDGFEM"):
        errs = []
        for n in MODAL_CELLS:
            V = pt.FunctionSpace(pt.StructuredMesh([0, 0], [1, 1], (n, n)),
                                 getattr(fe, name)(2, 2))
            _, err, path = solve(V, p2, f"SIPG {name}(2, 2) {n}^2")
            if "compiled block stencil" not in path:
                raise AssertionError(f"13d {name}: {path}")
            errs.append(err)
        order = math.log2(errs[0] / errs[1])
        log(f"[phase 13d] {name}(2, 2): L2 order {order:.3f}")
        if not order > MODAL_ORDER_MIN:
            raise AssertionError(f"13d {name} order {order}")
    n = MODAL_3D_CELLS
    V = pt.FunctionSpace(pt.StructuredMesh([0] * 3, [1] * 3, (n,) * 3), fe.MonomialDGFEM(1, 3))
    _, err, path = solve(V, modal_problem(3), f"SIPG MonomialDGFEM(1, 3) {n}^3")
    if "MMBlockStencil" not in path or not err < 1e-2:
        raise AssertionError(f"13d MonomialDGFEM(1, 3): L2 {err}, {path}")
    n = VARORDER_CELLS
    mesh = pt.StructuredMesh([0, 0], [1, 1], (n, n))
    V2 = pt.FunctionSpace(mesh, fe.LegendreDGFEM(2, 2))
    cg_ = p_adaptive_constraints(V2, np.full(mesh.nelements, 1), device=dev)
    xt, _, _ = solve(V2, p2, f"variable order (k = 1 in LegendreDGFEM(2, 2)) {n}^2",
                     cg_, 2.0, 8)
    V1 = pt.FunctionSpace(mesh, fe.LegendreDGFEM(1, 2))
    x1, _, _ = solve(V1, p2, f"LegendreDGFEM(1, 2) {n}^2", None, 6.0, 8)
    keep = np.nonzero(V2.fem._mi.max(axis=1) <= 1)[0]
    xt, x1 = xt.cpu().numpy(), x1.cpu().numpy()
    d = float(np.abs(xt[V2.element_dofs[:, keep]] - x1[V1.element_dofs]).max())
    log(f"[phase 13d] variable order vs the truncated space: max coefficient gap {d:.3e}")
    if not d < 1e-7:
        raise AssertionError(f"13d variable order gap {d}")


def elasticity_solves(torch, pt, dev):
    """Phase 13e: the 2D Q2 manufactured elasticity problem of
    tests/test_elasticity.py:47-85 with SEQ_CG_Jacobi to 1e-10 (the
    general-jvp tier), L2 order > 2.7; at ELAST_SMALLER when the larger
    pair would take more than ELAST_BUDGET_S."""
    from dune_pdelab_tpu_torch.ops import LinearElasticity, LinearElasticityParameters
    from dune_pdelab_tpu_torch.space.functions import l2_difference
    from dune_pdelab_tpu_torch.space.space import VectorSpace

    pi = math.pi
    lam = mu = 1.0

    def u1(q):
        return torch.sin(pi * q[..., 0]) * torch.sin(pi * q[..., 1])

    class P(LinearElasticityParameters):
        def g(self, x):
            return torch.stack([u1(x), torch.zeros_like(x[..., 0])], -1)

        def f(self, x):
            px, py = pi * x[..., 0], pi * x[..., 1]
            return torch.stack([pi ** 2 * ((lam + 2 * mu) + mu) * torch.sin(px) * torch.sin(py),
                                -pi ** 2 * (lam + mu) * torch.cos(px) * torch.cos(py)], -1)

    def run(n):
        torch.cuda.reset_peak_memory_stats()
        W = VectorSpace(pt.StructuredMesh([0, 0], [1, 1], (n, n)), pt.QkFEM(2, 2))
        cg_ = pt.constraints((True, True), W, device=dev)
        go = pt.GridOperator(W, LinearElasticity(P(lam=lam, mu=mu)), constraints=cg_)
        x0 = pt.interpolate_dirichlet(
            lambda q: torch.stack([u1(q), torch.zeros_like(q[:, 0])], -1),
            W, cg_, W.zero(torch.float64, dev))
        backend = pt.SEQ_CG_Jacobi()
        slp = pt.StationaryLinearProblemSolver(go, backend, reduction=1e-10, verbose=0)
        x, s = timed(torch, lambda: slp.apply(x0))
        its = slp.result.linear_solver_iterations
        err = float(l2_difference(W.children[0], W.restrict(x, 0), u1))
        log(f"[phase 13e] Q2 elasticity {n}^2 (N = {W.ndofs}): {its} CG iterations, "
            f"{s:.2f} s ({1e3 * s / max(1, its):.2f} ms per iteration), L2(u_1) {err:.6e}, "
            f"peak {peak_gib(torch):.3f} GiB; {backend.report(go).splitlines()[0]}")
        if not slp.result.converged:
            raise AssertionError(f"13e {n}^2 did not converge")
        return err, s

    e0, s0 = run(ELAST_CELLS[0])
    # the CG iterations double with n and a host-bound apply costs about
    # the same: the larger solve takes ~2x the smaller one
    if 3.0 * s0 > ELAST_BUDGET_S:
        log(f"[phase 13e] {ELAST_CELLS[0]}^2 took {s0:.2f} s: the pair {ELAST_CELLS} would "
            f"take ~{3 * s0:.0f} s > {ELAST_BUDGET_S} s; running {ELAST_SMALLER} instead")
        (e0, _), (e1, _) = run(ELAST_SMALLER[0]), run(ELAST_SMALLER[1])
    else:
        e1, _ = run(ELAST_CELLS[1])
    order = math.log2(e0 / e1)
    log(f"[phase 13e] L2 order {order:.3f}")
    if not order > ELAST_ORDER_MIN:
        raise AssertionError(f"13e order {order}")


def wave_run(torch, pt, kind, cells, steps, dev):
    """(error, energy ratio, ms per step, N, x) of `steps` shu3 steps of
    the standing acoustic wave (2D Q2, tests/test_hyperbolic.py:18-44) or
    the Maxwell TM_110 cavity mode (3D Q1, :67-96) at the tests' CFL."""
    from dune_pdelab_tpu_torch.fe import QkDGFEM
    from dune_pdelab_tpu_torch.instationary import ExplicitOneStepMethod, shu3
    from dune_pdelab_tpu_torch.ops import L2, LinearAcousticsDG, MaxwellDG
    from dune_pdelab_tpu_torch.space.functions import l2_difference

    pi = math.pi
    dim, k = (2, 2) if kind == "acoustics" else (3, 1)
    leaf = pt.FunctionSpace(pt.StructuredMesh([0.0] * dim, [1.0] * dim, cells),
                            QkDGFEM(k, dim))
    n = cells[0]

    def zero(q):
        return torch.zeros(len(q), dtype=q.dtype)

    if kind == "acoustics":
        Q = pt.PowerSpace(leaf, 3)
        lop = LinearAcousticsDG(c=1.0, bc="reflect")
        x = Q.interpolate((lambda q: torch.cos(pi * q[:, 0]), zero, zero),
                          dtype=torch.float64, device=dev)
        dt, comp = 0.4 / (n * (2 * k + 1)), 0
    else:
        Q = pt.PowerSpace(leaf, 6)
        lop = MaxwellDG(bc="pec")
        x = Q.interpolate((zero, zero, lambda q: torch.sin(pi * q[:, 0]) * torch.sin(pi * q[:, 1]),
                           zero, zero, zero), dtype=torch.float64, device=dev)
        dt, comp = 0.3 / (n * (2 * k + 1)), 2
    go1 = pt.GridOperator(Q, L2())
    osm = ExplicitOneStepMethod(shu3(), pt.GridOperator(Q, lop), go1)
    energy0 = float(torch.dot(x, go1.jacobian_apply(x, x)))
    t = 0.0
    x, _ = osm.apply(t, dt, x)                      # the first step sets up the mass solve
    t += dt
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps - 1):
        x, _ = osm.apply(t, dt, x)
        t += dt
    if dev.type == "cuda":
        torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / max(1, steps - 1)
    w = math.sqrt(2.0) * pi
    if kind == "acoustics":
        def exact(q):
            return torch.cos(pi * q[:, 0]) * math.cos(pi * t)
    else:
        def exact(q):
            return torch.sin(pi * q[:, 0]) * torch.sin(pi * q[:, 1]) * math.cos(w * t)
    err = float(l2_difference(leaf, Q.restrict(x, comp), exact))
    ratio = float(torch.dot(x, go1.jacobian_apply(x, x))) / energy0
    return err, ratio, ms, Q.ndofs, x


def wave_runs(torch, pt, dev):
    """Phase 13f: LinearAcousticsDG (2D Q2 standing wave) at
    ACOUSTICS_CELLS^2 and MaxwellDG (3D Q1 cavity) at MAXWELL_CELLS^3, shu3
    for WAVE_STEPS steps: the error against the exact mode within the
    tests' bounds, the energy not growing; 3 steps at 8^2 / 8x8x2 on the
    card against the CPU to WAVE_SMALL_TOL."""
    for kind, cells, lim in (("acoustics", (ACOUSTICS_CELLS,) * 2, 0.02),
                             ("maxwell", (MAXWELL_CELLS,) * 3, 0.05)):
        torch.cuda.reset_peak_memory_stats()
        err, ratio, ms, N, _ = wave_run(torch, pt, kind, cells, WAVE_STEPS, dev)
        log(f"[phase 13f] {kind} {'x'.join(map(str, cells))} (N = {N}), {WAVE_STEPS} shu3 "
            f"steps: error vs the exact mode {err:.3e}, energy ratio {ratio:.9f}, "
            f"{ms:.2f} ms per step, peak {peak_gib(torch):.3f} GiB; {CARD}")
        if not (err < lim and 0.99 < ratio <= 1.0 + 1e-9):
            raise AssertionError(f"13f {kind}: error {err}, energy ratio {ratio}")
    for kind, cells in (("acoustics", (8, 8)), ("maxwell", (8, 8, 2))):
        xa = wave_run(torch, pt, kind, cells, 3, dev)[-1].cpu()
        xb = wave_run(torch, pt, kind, cells, 3, torch.device("cpu"))[-1]
        gap = float((xa - xb).abs().max() / xb.abs().max())
        log(f"[phase 13f] {kind} {'x'.join(map(str, cells))}, 3 steps: card vs CPU {gap:.3e}")
        if not gap <= WAVE_SMALL_TOL:
            raise AssertionError(f"13f {kind} card vs CPU {gap}")


def projections(torch, pt, dev):
    """Phase 13g: the L2 projection (CombinedOperator of L2 and
    L2VolumeFunctional, Jacobi-CG to 1e-14) of a polynomial in each new
    element's span at PROJ_CELLS^2 reproduces it to PROJ_TOL in L2."""
    from dune_pdelab_tpu_torch import fe
    from dune_pdelab_tpu_torch.ops import CombinedOperator, L2, L2VolumeFunctional
    from dune_pdelab_tpu_torch.space.functions import l2_difference

    def p0(x):
        return 0.75 + 0 * x[..., 0]

    def rt(x):
        return 1.0 + x[..., 0] - 2 * x[..., 1] + 0.5 * (x[..., 0] ** 2 - x[..., 1] ** 2)

    def p2(x):
        return 1.0 + 2 * x[..., 0] - x[..., 1] + 0.5 * x[..., 0] * x[..., 1] + x[..., 0] ** 2

    def q2(x):
        return p2(x) - 0.25 * x[..., 0] ** 2 * x[..., 1] ** 2

    n = PROJ_CELLS
    cases = [("P0FEM cube", fe.P0FEM(2), p0), ("P0FEM simplex", fe.P0FEM(2, "simplex"), p0),
             ("RannacherTurekFEM", fe.RannacherTurekFEM(2), rt),
             ("LegendreDGFEM(2)", fe.LegendreDGFEM(2, 2), q2),
             ("MonomialDGFEM(2)", fe.MonomialDGFEM(2, 2), p2),
             ("OPBFEM(2)", fe.OPBFEM(2, 2), p2),
             ("QkDGFEM(2, gl)", fe.QkDGFEM(2, 2, "gl"), q2),
             ("QkDGFEM(2, lobatto)", fe.QkDGFEM(2, 2, "lobatto"), q2)]
    for name, fem, f in cases:
        mesh = pt.StructuredMesh([0, 0], [1, 1], (n, n))
        if fem.geometry == "simplex":
            mesh = pt.SimplexMesh.from_structured(mesh)
        V = pt.FunctionSpace(mesh, fem)
        go = pt.GridOperator(V, CombinedOperator([L2(), L2VolumeFunctional(f)]),
                             quad_order=2 * fem.degree + 2)
        backend = pt.SEQ_CG_Jacobi()
        slp = pt.StationaryLinearProblemSolver(go, backend, reduction=1e-14, verbose=0)
        x, s = timed(torch, lambda: slp.apply(V.zero(torch.float64, dev)))
        err = float(l2_difference(V, x, f))
        log(f"[phase 13g] L2 projection on {name} {n}^2 (N = {V.ndofs}): "
            f"{slp.result.linear_solver_iterations} CG iterations, {s:.2f} s, L2 error "
            f"{err:.3e}; {backend.report(go).splitlines()[0]}")
        if not err <= PROJ_TOL:
            raise AssertionError(f"13g {name}: projection error {err}")


def checkpoints(torch, pt, dev, tmp):
    """Phase 13g: config11 run to t = 0.002, saved through
    CheckpointManager, restored on the card and continued to 0.004: the
    end state bit-equal to continuing from the state kept in memory; and
    an .npz written by numpy.savez in the reference's layout loaded onto
    the card."""
    import numpy as np
    from dune_pdelab_tpu_torch.utils import CheckpointManager, load_checkpoint

    def leg(x, t0, t1):
        _, _, osm, _, _ = twophase_setup(torch, pt, (TP_C11_CELLS, 2), dev)
        return osm.solve(t0, 1e-3, t1, x, max_step_retries=4)

    x0 = twophase_setup(torch, pt, (TP_C11_CELLS, 2), dev)[-1]
    t4, x4 = leg(x0, 0.0, 0.002)
    t_all, x_all = leg(x4.clone(), t4, 0.004)          # uninterrupted: x4 stays in memory
    mgr = CheckpointManager(str(tmp / "ckpt"), keep=2)
    mgr.save(4, {"x": x4}, {"t": t4})
    arrays, meta = mgr.restore(device=dev)
    t_res, x_res = leg(arrays["x"], meta["t"], 0.004)
    same = bool(torch.equal(x_res, x_all)) and t_res == t_all
    log(f"[phase 13g] config11 restart at t = {t4}: restored on {arrays['x'].device}, end "
        f"state bit-equal to the uninterrupted run: {same}")
    if not same:
        raise AssertionError("13g: the restarted config11 run differs")
    ref = {"x": np.linspace(0.0, 1.0, 17), "idx": np.arange(6, dtype=np.int32)}
    path = tmp / "numpy_written.npz"
    np.savez(path, **ref, __meta__=np.frombuffer(json.dumps({"t": 0.5}).encode(), np.uint8))
    arrays, meta = load_checkpoint(str(path), device=dev)
    ok = (meta == {"t": 0.5} and all(arrays[k].device.type == dev.type
                                     and np.array_equal(arrays[k].cpu().numpy(), v)
                                     for k, v in ref.items()))
    log(f"[phase 13g] numpy.savez checkpoint loaded onto {dev}: {ok}")
    if not ok:
        raise AssertionError("13g: the numpy-written checkpoint did not load")


def phase_slice13a(torch, pt, dev):
    """Phase 13: P0 and modal elements, CCFV, two-phase flow, elasticity,
    explicit DG waves and checkpoints (ROADMAP slice 13a), fp64. The CCFV
    solves launch the block stencil at nb = 1 (K6 in 2D, K5 in 3D), the
    modal SIPG solves at nb = 6 and 9 (K6) and 4 (K5), the projections at
    nb = 1, 4, 6 and 9; two-phase flow, elasticity and the waves run the
    general torch.func.jvp or the residual."""
    import tempfile
    aside = cpu_aside(twophase_small_cpu)   # 13b's CPU side, beside 13k-13b on the card
    p13_kernels(torch, pt, dev)
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        for name, run in (("13a", twophase_config11),
                          ("13b", lambda *a: twophase_at_size(*a, aside)),
                          ("13c", ccfv_solves), ("13d", modal_solves),
                          ("13e", elasticity_solves), ("13f", wave_runs),
                          ("13g", lambda *a: (projections(*a), checkpoints(*a, Path(tmp))))):
            t0 = time.perf_counter()
            run(torch, pt, dev)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            log(f"[phase {name}] {time.perf_counter() - t0:.2f} s")


# ---------------------------------------------------------------------------
# phase 14: slices 13b and 13c: H(div), H(curl) and mimetic elements, the
# mixed Darcy and curl-curl operators, adjoint-differentiable solves and
# rollouts. No hand kernel: K1-K6 decline these leaves (each declined tier
# is named in the backend's report), every apply is the general
# torch.func.jvp replayed from a CUDA graph inside a Krylov solve
# ---------------------------------------------------------------------------

def _xp(x):
    """torch for tensors, numpy else."""
    import numpy as np
    import torch
    return torch if isinstance(x, torch.Tensor) else np


def p14_problem(dim=2, harmonic=False):
    """-div grad p = f with p = prod sin(pi x_i), zero Dirichlet data
    (tests/test_mixed.py:43-55, tests/test_fe_zoo_r3.py:197-208), or the
    harmonic p = x^2 - y^2 with its Dirichlet data (tests/test_mapped.py:56).
    p_exact takes numpy points or tensors."""
    from dune_pdelab_tpu_torch.ops import ConvectionDiffusionProblem

    class P(ConvectionDiffusionProblem):
        def p_exact(self, q):
            if harmonic:
                return q[:, 0] ** 2 - q[:, 1] ** 2
            out = 1.0
            for d in range(dim):
                out = out * _xp(q).sin(math.pi * q[:, d])
            return out

        def f(self, x):
            if harmonic:
                return 0.0 * x[..., 0]
            out = dim * math.pi ** 2
            for d in range(dim):
                out = out * _xp(x).sin(math.pi * x[..., d])
            return out

        def g(self, x):
            return x[..., 0] ** 2 - x[..., 1] ** 2 if harmonic else 0.0 * x[..., 0]
    return P()


def p14_tier(backend, go):
    """The solve path of backend.report() and the names of the declined
    tiers, on one line."""
    lines = backend.report(go).splitlines()
    declined = [ln.split(":")[0].replace("declined", "").strip()
                for ln in lines[1:] if "declined" in ln]
    return f"{lines[0].replace('solve path: ', '')} (declined: {', '.join(declined) or '-'})"


def p14_mixed_space(pt, kind, n, dim=2):
    """(mesh, W, Vu, Vp) of a mixed Darcy case: velocity element x pressure
    element on the case's mesh."""
    from dune_pdelab_tpu_torch.fe import hdiv

    simplex = pt.SimplexMesh.from_structured
    unit = pt.StructuredMesh([0.0] * dim, [1.0] * dim, (n,) * dim)
    el, pel, mesh = {
        "RT0": (hdiv.RT0Cube(2), pt.P0FEM(2), unit),
        "BDM1": (hdiv.BDM1Cube(2), pt.P0FEM(2), unit),
        "RT1": (hdiv.RT1Cube2D(), pt.QkDGFEM(1, 2), unit),
        "RT2": (hdiv.RT2Cube2D(), pt.QkDGFEM(2, 2), unit),
        "RT0tri": (hdiv.RT0Simplex2D(), pt.P0FEM(2, geometry="simplex"), None),
        "BDM1tri": (hdiv.BDM1Simplex2D(), pt.P0FEM(2, geometry="simplex"), None),
        "RT1tri": (hdiv.RT1Simplex2D(), pt.PkDGFEM(1, 2), None),
        "RT0tet": (hdiv.RT0Simplex3D(), pt.P0FEM(3, geometry="simplex"), None),
        "RT1hex": (hdiv.RTkCube3D(1), pt.QkDGFEM(1, 3), unit),
        "annulus": (hdiv.RT0Cube(2), pt.P0FEM(2), None),
    }[kind]
    if kind == "annulus":
        mesh = annulus_mesh(pt, n)
    elif mesh is None:
        mesh = simplex(unit)
    Vu, Vp = pt.FunctionSpace(mesh, el, name="u"), pt.FunctionSpace(mesh, pel, name="p")
    return mesh, pt.CompositeSpace(Vu, Vp), Vu, Vp


def p14_mixed_solve(torch, pt, kind, n, problem, dev, tag, dim=2, reduction=P14_MIXED_RED):
    """Mixed Darcy with unpreconditioned MINRES (the reference tests'
    solver) on the card; logs iterations, time, tier, peak memory and
    max |r_p| (local conservation); returns (mesh, W, Vp, x, max |r_p|)."""
    from dune_pdelab_tpu_torch.ops import DiffusionMixed

    torch.cuda.reset_peak_memory_stats()
    mesh, W, Vu, Vp = p14_mixed_space(pt, kind, n, dim)
    go = pt.GridOperator(W, DiffusionMixed(problem))
    backend = pt.LinearSolverBackend(solver="minres", precond="none", maxiter=P14_MINRES_MAX)
    slp = pt.StationaryLinearProblemSolver(go, backend, reduction=reduction, verbose=0)
    x, s = timed(torch, lambda: slp.apply(W.zero(torch.float64, dev)))
    rp = float(W.restrict(go.residual(x), 1).abs().max())
    its = slp.result.linear_solver_iterations
    log(f"[phase {tag}] {kind} {n}^{dim}{' x 2' if kind.endswith('tri') else ''}"
        f"{' x 6' if kind == 'RT0tet' else ''} (N = {W.ndofs}): MINRES {its} iterations, "
        f"{s:.2f} s ({1e3 * s / max(its, 1):.2f} ms/iteration), max |r_p| {rp:.2e}, "
        f"peak {peak_gib(torch):.3f} GiB; {p14_tier(backend, go)}")
    if not slp.result.converged:
        raise AssertionError(f"phase {tag}: {kind} {n} did not converge")
    return mesh, W, Vp, x, rp


def p14_order(tag, what, errs, bound):
    order = math.log2(errs[0] / errs[1])
    log(f"[phase {tag}] {what}: errors {', '.join(f'{e:.6e}' for e in errs)}, "
        f"order {order:.3f} (bound > {bound})")
    if not order > bound:
        raise AssertionError(f"phase {tag}: {what} order {order} <= {bound}")


def p14_center_error(mesh, W, x, problem):
    import numpy as np
    xp = W.restrict(x, 1).cpu().numpy()
    return float(np.sqrt(np.mean((xp - problem.p_exact(mesh.element_centers())) ** 2)))


def p14_l2_error(Vp, W, x, problem):
    from dune_pdelab_tpu_torch.space.functions import l2_difference
    return float(l2_difference(Vp, W.restrict(x, 1), problem.p_exact))


def mixed_cubes(torch, pt, dev):
    """Phase 14a: DiffusionMixed on squares, MINRES to 1e-11. RT0/P0 at
    P14_RT0_CELLS: cell-centre order > 1.5 (tests/test_mixed.py:66) and
    max |r_p| < 1e-9; RT1/Q1DG at P14_RT1_CELLS, L2 order > 1.6
    (tests/test_fe_zoo.py:137); RT2/Q2DG at P14_RT2_CELLS, L2 order > 2.5
    (tests/test_rt_higher.py:101); BDM1/P0 at P14_BDM1_CELLS converges
    with max |r_p| < 1e-9."""
    p = p14_problem()
    errs = []
    for n in P14_RT0_CELLS:
        mesh, W, _, x, rp = p14_mixed_solve(torch, pt, "RT0", n, p, dev, "14a")
        if not rp < P14_CONSERVE:
            raise AssertionError(f"phase 14a: RT0 {n} max |r_p| {rp}")
        errs.append(p14_center_error(mesh, W, x, p))
    p14_order("14a", "RT0 cell-centre pressure", errs, 1.5)
    for kind, sizes, bound in (("RT1", P14_RT1_CELLS, 1.6), ("RT2", P14_RT2_CELLS, 2.5)):
        errs = []
        for n in sizes:
            _, W, Vp, x, _ = p14_mixed_solve(torch, pt, kind, n, p, dev, "14a",
                                             reduction=1e-12 if kind == "RT2" else P14_MIXED_RED)
            errs.append(p14_l2_error(Vp, W, x, p))
        p14_order("14a", f"{kind} L2 pressure", errs, bound)
    _, _, _, _, rp = p14_mixed_solve(torch, pt, "BDM1", P14_BDM1_CELLS, p, dev, "14a")
    if not rp < P14_CONSERVE:
        raise AssertionError(f"phase 14a: BDM1 max |r_p| {rp}")


def p14_symmetry(torch, go, n, dev, seed=14):
    """|u^T A v - v^T A u| / |u^T A v| for seeded random u, v."""
    import numpy as np
    rng = np.random.default_rng(seed)
    u, v = (torch.as_tensor(rng.standard_normal(n), device=dev) for _ in range(2))
    zero = torch.zeros(n, dtype=torch.float64, device=dev)
    uav = float(u @ go.jacobian_apply(zero, v))
    vau = float(v @ go.jacobian_apply(zero, u))
    return abs(uav - vau) / abs(uav)


def mixed_simplices(torch, pt, dev):
    """Phase 14b: RT0 triangles at P14_TRI_CELLS (cell-centre order > 0.9,
    tests/test_hdiv_simplex.py:98), BDM1 triangles at P14_BDM1_TRI, both
    with max |r_p| < 1e-9; RT1 triangles at P14_RT1_TRI (L2 order > 1.6,
    tests/test_rt_higher.py:122); RT0 tets at P14_TET_CELLS^3 x 6
    (tests/test_hdiv_simplex.py:136: symmetric, converged, max |r_p| <
    1e-8); RTkCube3D(1) at P14_HEX_CELLS (L2 order > 1.6,
    tests/test_fe_zoo_r3.py:195); RT0 on the quarter annulus at
    P14_ANNULUS_CELLS (cell-centre orders > 1.85, tests/test_mapped.py:176;
    the mapped Piola and the Nanson boundary term)."""
    p = p14_problem()
    errs = []
    for n in P14_TRI_CELLS:
        mesh, W, _, x, rp = p14_mixed_solve(torch, pt, "RT0tri", n, p, dev, "14b")
        if not rp < P14_CONSERVE:
            raise AssertionError(f"phase 14b: RT0 triangles {n} max |r_p| {rp}")
        errs.append(p14_center_error(mesh, W, x, p))
    p14_order("14b", "RT0 triangles cell-centre pressure", errs, 0.9)
    _, _, _, _, rp = p14_mixed_solve(torch, pt, "BDM1tri", P14_BDM1_TRI, p, dev, "14b")
    if not rp < P14_CONSERVE:
        raise AssertionError(f"phase 14b: BDM1 triangles max |r_p| {rp}")
    errs = []
    for n in P14_RT1_TRI:
        _, W, Vp, x, _ = p14_mixed_solve(torch, pt, "RT1tri", n, p, dev, "14b", reduction=1e-12)
        errs.append(p14_l2_error(Vp, W, x, p))
    p14_order("14b", "RT1 triangles L2 pressure", errs, 1.6)

    class Unit(type(p)):
        def f(self, x):
            return 1.0 + 0.0 * x[..., 0]

    _, W, _, x, rp = p14_mixed_solve(torch, pt, "RT0tet", P14_TET_CELLS, Unit(), dev, "14b",
                                     dim=3, reduction=1e-10)
    from dune_pdelab_tpu_torch.ops import DiffusionMixed
    asym = p14_symmetry(torch, pt.GridOperator(W, DiffusionMixed(Unit())), W.ndofs, dev)
    log(f"[phase 14b] RT0 tets: u^T A v against v^T A u {asym:.2e}")
    if not (rp < 1e-8 and asym < 1e-12):
        raise AssertionError(f"phase 14b: RT0 tets max |r_p| {rp}, asymmetry {asym}")
    p3 = p14_problem(3)
    errs = []
    for n in P14_HEX_CELLS:
        _, W, Vp, x, _ = p14_mixed_solve(torch, pt, "RT1hex", n, p3, dev, "14b", dim=3)
        errs.append(p14_l2_error(Vp, W, x, p3))
    p14_order("14b", "RT1 hexahedra L2 pressure", errs, 1.6)
    ph = p14_problem(harmonic=True)
    errs = []
    for n in P14_ANNULUS_CELLS:
        mesh, W, _, x, _ = p14_mixed_solve(torch, pt, "annulus", n, ph, dev, "14b")
        errs.append(p14_center_error(mesh, W, x, ph))
    p14_order("14b", "RT0 quarter annulus cell-centre pressure", errs, 1.85)


def p14_curl_exact(Ve, h):
    """Exact edge circulations of u = (sin(pi y), sin(pi x)) on the unit
    square's edge lattice: h sin(pi y0) on an x-edge at height y0, h sin(pi
    x0) on a y-edge at x0 (closed forms of tests/test_hcurl.py's quad)."""
    import numpy as np
    exact = np.zeros(Ve.ndofs)
    for a in range(2):
        ed, off = Ve._hcurl_edge_dims[a], Ve._hcurl_offsets[a]
        g = np.arange(int(np.prod(ed)), dtype=np.int64)
        tr = (g // ed[0]) if a == 0 else (g % ed[0])
        exact[off:off + len(g)] = h * np.sin(np.pi * tr * h)
    return exact


def p14_cg(torch, pt, go, V, dev, tol, maxiter=20000):
    """Jacobi-CG from zero, the reference tests' loop (J z = r(0), x = -z)
    as StationaryLinearProblemSolver runs it; returns (x, iterations,
    seconds, converged, tier)."""
    backend = pt.LinearSolverBackend(solver="cg", precond="jacobi", maxiter=maxiter)
    slp = pt.StationaryLinearProblemSolver(go, backend, reduction=tol, verbose=0)
    x, s = timed(torch, lambda: slp.apply(V.zero(torch.float64, dev)))
    return (x, slp.result.linear_solver_iterations, s, bool(slp.result.converged),
            p14_tier(backend, go))


def hcurl_runs(torch, pt, dev):
    """Phase 14c: the CurlCurl manufactured problem of tests/test_hcurl.py:67
    on N0Cube(2) at P14_CURL_CELLS (boundary edges constrained, Jacobi-CG to
    1e-11), errors against the exact circulations < 0.05 and falling; the
    discrete de Rham check (:35) on N0Cube(3) at P14_DERHAM_CELLS^3 to
    1e-12; Whitney tets (tests/test_fe_zoo_r3.py:131) at P14_WHITNEY_CELLS
    x 6, order > 0.9; the Maxwell cavity (tests/test_hcurl.py:183) at
    P14_CAVITY_CELLS^2: A and M assembled on the card by go.jacobian, the
    boundary edges removed, a dense generalised eigensolve on the host."""
    import numpy as np
    import scipy.linalg as sla
    from dune_pdelab_tpu_torch.fe.hcurl import N0Cube, N0Simplex
    from dune_pdelab_tpu_torch.ops import CurlCurl, CurlCurlParameters

    class Manufactured(CurlCurlParameters):
        def f(self, x):
            c = math.pi ** 2 + 1.0
            return torch.stack([c * torch.sin(math.pi * x[..., 1]),
                                c * torch.sin(math.pi * x[..., 0])], -1)

    errs = []
    for n in P14_CURL_CELLS:
        torch.cuda.reset_peak_memory_stats()
        Ve = pt.FunctionSpace(pt.StructuredMesh([0.0, 0.0], [1.0, 1.0], (n, n)), N0Cube(2))
        go = pt.GridOperator(Ve, CurlCurl(Manufactured()),
                             constraints=pt.DirichletConstraints(Ve.boundary_edge_mask(),
                                                                 device=dev))
        x, its, s, ok, how = p14_cg(torch, pt, go, Ve, dev, 1e-11)
        exact = p14_curl_exact(Ve, 1.0 / n)
        err = float(np.linalg.norm(x.cpu().numpy() - exact) / np.linalg.norm(exact))
        errs.append(err)
        log(f"[phase 14c] curl-curl N0Cube(2) {n}^2 (N = {Ve.ndofs}): Jacobi-CG {its} "
            f"iterations, {s:.2f} s, edge error {err:.6e}, peak {peak_gib(torch):.3f} GiB; {how}")
        if not (ok and err < 0.05):
            raise AssertionError(f"phase 14c: curl-curl {n}: converged {ok}, error {err}")
    log(f"[phase 14c] curl-curl errors {errs[0]:.6e} -> {errs[1]:.6e}, ratio {errs[0] / errs[1]:.3f}")
    if not errs[1] < errs[0]:
        raise AssertionError("phase 14c: the curl-curl error does not fall")

    # discrete de Rham: edge DOFs of a nodal gradient lie in the kernel
    n = P14_DERHAM_CELLS
    mesh = pt.StructuredMesh([0.0] * 3, [1.0] * 3, (n,) * 3)
    Ve = pt.FunctionSpace(mesh, N0Cube(3))
    dims_n = (n + 1,) * 3
    strides = np.cumprod((1,) + dims_n[:-1])
    pvals = np.random.default_rng(0).standard_normal(int(np.prod(dims_n)))
    gvec = np.zeros(Ve.ndofs)
    for a in range(3):
        ed, off = Ve._hcurl_edge_dims[a], Ve._hcurl_offsets[a]
        g = np.arange(int(np.prod(ed)), dtype=np.int64)
        mi = np.stack([g % ed[0], (g // ed[0]) % ed[1], g // (ed[0] * ed[1])], axis=1)
        gvec[off:off + len(g)] = pvals[(mi + np.eye(3, dtype=np.int64)[a]) @ strides] \
            - pvals[mi @ strides]
    go = pt.GridOperator(Ve, CurlCurl(CurlCurlParameters(nu=1.0, beta=0.0)))
    y, s = timed(torch, lambda: go.jacobian_apply(Ve.zero(torch.float64, dev),
                                                  torch.as_tensor(gvec, device=dev)))
    rel = float(torch.linalg.norm(y)) / max(1.0, float(np.linalg.norm(gvec)))
    log(f"[phase 14c] de Rham N0Cube(3) {n}^3 (N = {Ve.ndofs}): |curl curl grad p| / |grad p| "
        f"{rel:.2e} ({s:.2f} s)")
    if not rel < 1e-12:
        raise AssertionError(f"phase 14c: de Rham {rel}")

    class GradSin(CurlCurlParameters):
        def f(self, x):
            s_, c_, pi = torch.sin, torch.cos, math.pi
            X, Y, Z = x[..., 0], x[..., 1], x[..., 2]
            return pi * torch.stack([c_(pi * X) * s_(pi * Y) * s_(pi * Z),
                                     s_(pi * X) * c_(pi * Y) * s_(pi * Z),
                                     s_(pi * X) * s_(pi * Y) * c_(pi * Z)], -1)

    errs = []
    for n in P14_WHITNEY_CELLS:
        torch.cuda.reset_peak_memory_stats()
        sm = pt.SimplexMesh.from_structured(pt.StructuredMesh([0.0] * 3, [1.0] * 3, (n,) * 3))
        V = pt.FunctionSpace(sm, N0Simplex(3))
        uniq, _ = sm.edges()
        go = pt.GridOperator(V, CurlCurl(GradSin(nu=1.0, beta=1.0)),
                             constraints=pt.DirichletConstraints(V.boundary_edge_mask(), device=dev))
        x, its, s, ok, how = p14_cg(torch, pt, go, V, dev, 1e-12)
        pv = np.prod(np.sin(np.pi * sm.vertices), axis=1)
        exact = pv[uniq[:, 1]] - pv[uniq[:, 0]]
        errs.append(float(np.linalg.norm(x.cpu().numpy() - exact) / np.linalg.norm(exact)))
        log(f"[phase 14c] Whitney tets {n}^3 x 6 (N = {V.ndofs}): Jacobi-CG {its} iterations, "
            f"{s:.2f} s, peak {peak_gib(torch):.3f} GiB; {how}")
        if not ok:
            raise AssertionError(f"phase 14c: Whitney {n} did not converge")
    p14_order("14c", "Whitney tets edge DOFs", errs, 0.9)

    n = P14_CAVITY_CELLS
    V = pt.FunctionSpace(pt.StructuredMesh([0.0, 0.0], [1.0, 1.0], (n, n)), N0Cube(2))
    zero = V.zero(torch.float64, dev)
    t0 = time.perf_counter()
    A = pt.GridOperator(V, CurlCurl(CurlCurlParameters(nu=1.0, beta=0.0))).jacobian(zero)
    M = pt.GridOperator(V, CurlCurl(CurlCurlParameters(nu=0.0, beta=1.0))).jacobian(zero)
    free = ~V.boundary_edge_mask()
    A = A.to_dense().cpu().numpy()[np.ix_(free, free)]
    M = M.to_dense().cpu().numpy()[np.ix_(free, free)]
    t1 = time.perf_counter()
    lam = np.sort(sla.eigh(A, M, eigvals_only=True))
    nz = lam[lam > 1e-6] / np.pi ** 2
    nker = int(np.sum(lam <= 1e-6))
    log(f"[phase 14c] Maxwell cavity {n}^2 ({int(free.sum())} free edges): assembly on the card "
        f"{t1 - t0:.2f} s, dense eigh {time.perf_counter() - t1:.2f} s; first nonzero "
        f"lambda/pi^2 {np.round(nz[:5], 4).tolist()}, kernel dimension {nker}")
    if not (np.allclose(nz[:5], [1.0, 1.0, 2.0, 4.0, 4.0], rtol=0.02) and nker == (n - 1) ** 2):
        raise AssertionError(f"phase 14c: cavity eigenvalues {nz[:8]}, kernel {nker}")


def mimetic_runs(torch, pt, dev):
    """Phase 14d: DiffusionMFD on the convergence problem of
    tests/test_mimetic.py:67 at P14_MFD_CELLS (Jacobi-CG to 1e-13, L2 order
    > 1.8), the patch test (:53) at 7 x 5 (exact to 1e-10), the 3D operator
    at P14_MFD_3D^3: seeded u^T A v = v^T A u to 1e-12, Jacobi-CG
    converges."""
    import numpy as np
    from dune_pdelab_tpu_torch.fe.mimetic import DiffusionMFD, MimeticFEM
    from dune_pdelab_tpu_torch.ops import ConvectionDiffusionProblem
    from dune_pdelab_tpu_torch.space.functions import l2_difference

    class Sin(ConvectionDiffusionProblem):
        def exact(self, q):
            return torch.sin(math.pi * q[:, 0]) * torch.sin(math.pi * q[:, 1]) + q[:, 0]

        def f(self, x):
            return 2 * math.pi ** 2 * torch.sin(math.pi * x[..., 0]) * torch.sin(math.pi * x[..., 1])

        def g(self, x):
            return torch.sin(math.pi * x[..., 0]) * torch.sin(math.pi * x[..., 1]) + x[..., 0]

    class Linear(ConvectionDiffusionProblem):
        def f(self, x):
            return 0.0 * x[..., 0]

    def solve(V, p, x0, red):
        cgm = pt.constraints(True, V, device=dev)
        go = pt.GridOperator(V, DiffusionMFD(p), constraints=cgm)
        backend = pt.SEQ_CG_Jacobi(maxiter=40000)
        slp = pt.StationaryLinearProblemSolver(go, backend, reduction=red, verbose=0)
        x, s = timed(torch, lambda: slp.apply(x0(cgm)))
        return x, s, slp, backend, go

    errs = []
    p = Sin()
    for n in P14_MFD_CELLS:
        torch.cuda.reset_peak_memory_stats()
        V = pt.FunctionSpace(pt.StructuredMesh([0.0, 0.0], [1.0, 1.0], (n, n)), MimeticFEM(2))
        x, s, slp, backend, go = solve(
            V, p, lambda c: pt.interpolate_dirichlet(p.g, V, c, V.zero(torch.float64, dev)), 1e-13)
        errs.append(float(l2_difference(V, x, p.exact)))
        its = slp.result.linear_solver_iterations
        log(f"[phase 14d] DiffusionMFD {n}^2 (N = {V.ndofs}): Jacobi-CG {its} iterations, "
            f"{s:.2f} s ({1e3 * s / max(its, 1):.2f} ms/iteration), peak {peak_gib(torch):.3f} GiB; "
            f"{p14_tier(backend, go)}")
        if not slp.result.converged:
            raise AssertionError(f"phase 14d: {n} did not converge")
    p14_order("14d", "mimetic L2", errs, 1.8)

    V = pt.FunctionSpace(pt.StructuredMesh([0.0, 0.0], [1.0, 1.0], (7, 5)), MimeticFEM(2))

    def gfun(q):
        return 1.0 + 2.0 * q[..., 0] - q[..., 1]

    x, s, slp, _, _ = solve(V, Linear(), lambda c: pt.interpolate_dirichlet(
        gfun, V, c, V.zero(torch.float64, dev)), 1e-13)
    perr = float((x - V.interpolate(gfun, dtype=torch.float64, device=dev)).abs().max())
    log(f"[phase 14d] patch test 7 x 5: max error {perr:.2e}")
    if not perr < 1e-10:
        raise AssertionError(f"phase 14d: patch test {perr}")

    n = P14_MFD_3D
    torch.cuda.reset_peak_memory_stats()
    V = pt.FunctionSpace(pt.StructuredMesh([0.0] * 3, [1.0] * 3, (n,) * 3), MimeticFEM(3))

    class Source3(ConvectionDiffusionProblem):
        def f(self, x):
            return 1.0 + x[..., 0] * x[..., 1]

    asym = p14_symmetry(torch, pt.GridOperator(V, DiffusionMFD(Source3())), V.ndofs, dev)
    x, s, slp, backend, go = solve(V, Source3(), lambda c: V.zero(torch.float64, dev), 1e-10)
    its = slp.result.linear_solver_iterations
    log(f"[phase 14d] DiffusionMFD 3D {n}^3 (N = {V.ndofs}): u^T A v against v^T A u {asym:.2e}, "
        f"Jacobi-CG {its} iterations, {s:.2f} s, converged {slp.result.converged}, peak "
        f"{peak_gib(torch):.3f} GiB")
    if not (asym < 1e-12 and slp.result.converged):
        raise AssertionError(f"phase 14d: 3D asymmetry {asym}, converged {slp.result.converged}")


def p14_poisson_factory(torch, pt):
    """tests/test_differentiable.py:23-33: A = (t0 + t1 x + t2 y) I, f = 1."""
    from dune_pdelab_tpu_torch.ops import ConvectionDiffusionFEM, ConvectionDiffusionProblem

    def factory(theta):
        class P(ConvectionDiffusionProblem):
            def A(self, x):
                a = theta[0] + theta[1] * x[..., 0] + theta[2] * x[..., 1]
                return a[..., None, None] * torch.eye(2, dtype=x.dtype, device=x.device)

            def f(self, x):
                return 1.0 + 0.0 * x[..., 0]
        return ConvectionDiffusionFEM(P())
    return factory


def p14_adjoint_grad(torch, pt, n, dev, theta0):
    """The test_linear_adjoint_gradient_vs_fd problem at n^2 on `dev`:
    (f, loss, gradient, forward s, backward s)."""
    import numpy as np
    from dune_pdelab_tpu_torch.solvers import differentiable_stationary_solve

    V = pt.FunctionSpace(pt.StructuredMesh([0.0, 0.0], [1.0, 1.0], (n, n)), pt.QkFEM(1, 2))
    cons = pt.constraints(True, V, device=dev)
    f = differentiable_stationary_solve(V, p14_poisson_factory(torch, pt), constraints=cons,
                                        solver="cg", tol=1e-13)
    x_t = torch.as_tensor(np.random.default_rng(0).standard_normal(V.ndofs) * 0.01, device=dev)

    def loss(th):
        return torch.sum((f(th) - x_t) ** 2)

    th = torch.tensor(theta0, dtype=torch.float64, device=dev, requires_grad=True)
    val, s_fwd = timed(torch, lambda: loss(th))
    _, s_bwd = timed(torch, lambda: val.backward())
    return f, loss, th.grad.cpu().numpy(), s_fwd, s_bwd


def adjoint_runs(torch, pt, dev):
    """Phase 14e: test_linear_adjoint_gradient_vs_fd (tests/test_differentiable.py:46)
    at P14_ADJ_CELLS^2, directional FD within 1e-5; the same at
    P14_ADJ_SMALL^2 on the card and the CPU, gradients within 1e-10;
    differentiable_theta_rollout with Crank-Nicolson for P14_ROLL_STEPS
    steps at P14_ROLL_CELLS^2, parameter and initial-condition gradients
    against central FD within 1e-5 and checkpoint_steps=True within 1e-9;
    the Stokes viscosity gradient (:202, slow tier in the reference) at its
    5^2 against FD within 1e-5."""
    import numpy as np

    theta0, v, eps = [1.0, 0.4, -0.3], np.array([0.6, -0.3, 0.4]), 1e-6
    f, loss, g, s_fwd, s_bwd = p14_adjoint_grad(torch, pt, P14_ADJ_CELLS, dev, theta0)
    with torch.no_grad():
        lp = float(loss(torch.as_tensor(np.array(theta0) + eps * v, device=dev)))
        lm = float(loss(torch.as_tensor(np.array(theta0) - eps * v, device=dev)))
    fd, ad = (lp - lm) / (2 * eps), float(g @ v)
    rel = abs(fd - ad) / abs(fd)
    log(f"[phase 14e] adjoint gradient {P14_ADJ_CELLS}^2: forward {s_fwd:.2f} s "
        f"({f.info['forward'].iterations} CG iterations, {f.info['forward_apply']}), backward "
        f"{s_bwd:.2f} s ({f.info['adjoint'].iterations} adjoint CG iterations, "
        f"{f.info['adjoint_apply']}, converged {bool(f.info['adjoint'].converged)}), "
        f"directional FD {fd:.10e} against {ad:.10e}: {rel:.2e}")
    if not rel < 1e-5:
        raise AssertionError(f"phase 14e: adjoint gradient against FD {rel}")
    fc, _, gc, fc_s, bc_s = p14_adjoint_grad(torch, pt, P14_ADJ_SMALL, dev, theta0)
    _, _, gh, fh_s, bh_s = p14_adjoint_grad(torch, pt, P14_ADJ_SMALL, torch.device("cpu"), theta0)
    rel = float(np.abs(gc - gh).max() / np.abs(gh).max())
    log(f"[phase 14e] adjoint gradient {P14_ADJ_SMALL}^2: card against CPU {rel:.2e}; card "
        f"forward {fc_s:.2f} s, backward {bc_s:.2f} s ({fc.info['adjoint'].iterations} adjoint CG "
        f"iterations; CPU {fh_s:.2f} / {bh_s:.2f} s)")
    if not rel < 1e-10:
        raise AssertionError(f"phase 14e: card and CPU gradients differ by {rel}")
    rollout_gradients(torch, pt, dev)
    stokes_viscosity_gradient(torch, pt, dev)


def rollout_gradients(torch, pt, dev):
    """Phase 14e (2): tests/test_differentiable_time.py's heat problem at
    P14_ROLL_CELLS^2, Crank-Nicolson, P14_ROLL_STEPS steps of P14_ROLL_DT."""
    import numpy as np
    from dune_pdelab_tpu_torch.instationary import differentiable_theta_rollout
    from dune_pdelab_tpu_torch.ops import ConvectionDiffusionFEM, ConvectionDiffusionProblem

    def factory(params):
        class P(ConvectionDiffusionProblem):
            def A(self, x):
                return params[0]

            def f(self, x):
                return params[1] * torch.sin(math.pi * x[..., 0]) * torch.sin(math.pi * x[..., 1])
        return ConvectionDiffusionFEM(P())

    n = P14_ROLL_CELLS
    V = pt.FunctionSpace(pt.StructuredMesh([0.0, 0.0], [1.0, 1.0], (n, n)), pt.QkFEM(1, 2))
    cons = pt.constraints(True, V, device=dev)
    x0 = torch.where(cons.mask, 0.0, V.interpolate(
        lambda q: torch.sin(math.pi * q[..., 0]) * torch.sin(math.pi * q[..., 1]),
        dtype=torch.float64, device=dev))
    dt, steps = P14_ROLL_DT, P14_ROLL_STEPS
    grads = {}
    for cp in (False, True):
        roll = differentiable_theta_rollout(V, factory, cons, theta=0.5, tol=1e-13,
                                            checkpoint_steps=cp)
        p = torch.tensor([0.8, 3.0], dtype=torch.float64, device=dev, requires_grad=True)
        xx = x0.clone().requires_grad_(True)
        val, s_fwd = timed(torch, lambda: torch.sum(roll(xx, p, dt, steps) ** 2))
        _, s_bwd = timed(torch, lambda: val.backward())
        fwd = [st for kind, st, _ in roll.stats if kind == "step"]
        adj = [st for kind, st, _ in roll.stats if kind == "adjoint"]
        how = roll.stats[0][2]
        grads[cp] = (p.grad.cpu().numpy(), xx.grad.cpu().numpy())
        log(f"[phase 14e] rollout {n}^2 CN {steps} steps{' (checkpointed)' if cp else ''}: "
            f"forward {s_fwd:.2f} s ({sum(int(s.iterations) for s in fwd[:steps])} CG iterations "
            f"over {steps} step solves, {how}), backward {s_bwd:.2f} s "
            f"({sum(int(s.iterations) for s in adj)} adjoint CG iterations over {len(adj)} "
            f"solves{', ' + str(len(fwd) - steps) + ' recomputed steps' if cp else ''})")
        if cp:
            continue
        eps = 1e-6
        with torch.no_grad():
            def lossv(pp, xs):
                return float(torch.sum(roll(xs, pp, dt, steps) ** 2))

            fd = []
            for i in range(2):
                e = torch.zeros(2, dtype=torch.float64, device=dev)
                e[i] = eps
                fd.append((lossv(p.detach() + e, x0) - lossv(p.detach() - e, x0)) / (2 * eps))
            vdir = torch.where(cons.mask, 0.0, torch.as_tensor(
                np.random.default_rng(3).standard_normal(V.ndofs), device=dev))
            fdx = (lossv(p.detach(), x0 + eps * vdir) - lossv(p.detach(), x0 - eps * vdir)) / (2 * eps)
        gp, gx = grads[False]
        rel_p = float(np.max(np.abs(gp - np.array(fd)) / np.abs(np.array(fd))))
        adx = float(gx @ vdir.cpu().numpy())
        rel_x = abs(fdx - adx) / abs(fdx)
        log(f"[phase 14e] rollout gradients against central FD: params {rel_p:.2e}, x0 "
            f"direction {rel_x:.2e}")
        if not (rel_p < 1e-5 and rel_x < 1e-5):
            raise AssertionError(f"phase 14e: rollout gradients against FD {rel_p}, {rel_x}")
    rel_c = max(float(np.abs(a - b).max() / np.abs(b).max())
                for a, b in zip(grads[True], grads[False]))
    log(f"[phase 14e] checkpoint_steps=True against plain gradients {rel_c:.2e}")
    if not rel_c < 1e-9:
        raise AssertionError(f"phase 14e: checkpointed gradients differ by {rel_c}")


def stokes_viscosity_gradient(torch, pt, dev):
    """Phase 14e (3): tests/test_differentiable.py:202, a velocity
    functional of a Taylor-Hood Stokes solve (5^2, Q2/Q1, one pinned
    pressure DOF) differentiated in the viscosity mu(x) = t0 + t1 x:
    restarted GMRES(200) forward and GMRES(30) adjoint to 1e-12 within 5000
    iterations (the reference test's settings: its adjoint stops at maxiter
    short of 1e-12, in both packages, and the gradient holds all the same),
    against the directional FD within 1e-5. Both solves' convergence is
    printed."""
    import numpy as np
    from dune_pdelab_tpu_torch.linalg.krylov import restarted_gmres
    from dune_pdelab_tpu_torch.ops import NavierStokesParameters, TaylorHoodNavierStokes
    from dune_pdelab_tpu_torch.solvers import implicit_solve, parametric_residual
    from dune_pdelab_tpu_torch.solvers.differentiable import graphed
    from dune_pdelab_tpu_torch.solvers.stokes import stokes_constraints, taylor_hood_space

    W = taylor_hood_space(pt.StructuredMesh([0.0, 0.0], [1.0, 1.0], (5, 5)), degree=2)
    cons = stokes_constraints(W, bctype=True, pin_pressure=True, device=dev)

    class Cavity(NavierStokesParameters):
        def f(self, x):
            fx = torch.sin(math.pi * x[..., 0]) * torch.cos(math.pi * x[..., 1])
            return torch.stack([fx, -fx], -1)

    def factory(theta):
        return TaylorHoodNavierStokes(Cavity(mu=lambda x: theta[0] + theta[1] * x[..., 0],
                                             rho=0.0))

    R = parametric_residual(W, factory, constraints=cons)
    its = {}

    def forward(theta):
        go = pt.GridOperator(W, factory(theta), constraints=cons)
        x0 = W.zero(torch.float64, dev)
        z, st = restarted_gmres(graphed(lambda q: go.jacobian_apply(x0, q), x0),
                                go.residual(x0), tol=1e-12, restart=200, maxiter=5000)
        its["forward"] = st
        return x0 - z

    f = implicit_solve(R, forward, constraints=cons, adjoint_solver="gmres",
                       adjoint_tol=1e-12, adjoint_maxiter=5000)

    def loss(theta):
        return torch.sum(W.restrict(f(theta), 0) ** 2)

    th = torch.tensor([1.0, 0.5], dtype=torch.float64, device=dev, requires_grad=True)
    val, s_fwd = timed(torch, lambda: loss(th))
    _, s_bwd = timed(torch, lambda: val.backward())
    v, eps = np.array([0.7, -0.4]), 1e-6
    with torch.no_grad():
        fd = (float(loss(torch.as_tensor(np.array([1.0, 0.5]) + eps * v, device=dev)))
              - float(loss(torch.as_tensor(np.array([1.0, 0.5]) - eps * v, device=dev)))) / (2 * eps)
    ad = float(th.grad.cpu().numpy() @ v)
    rel = abs(fd - ad) / abs(fd)
    fw, adj = its["forward"], f.info["adjoint"]
    log(f"[phase 14e] Stokes viscosity gradient 5^2 (N = {W.ndofs}): forward {s_fwd:.2f} s "
        f"({fw.iterations} GMRES(200) iterations, converged {bool(fw.converged)}, reduction "
        f"{float(fw.reduction):.2e}), backward {s_bwd:.2f} s ({adj.iterations} adjoint GMRES(30) "
        f"iterations, {f.info['adjoint_apply']}, converged {bool(adj.converged)}, reduction "
        f"{float(adj.reduction):.2e}; the reference test's settings, tol 1e-12 and maxiter "
        f"5000), directional FD {fd:.10e} against {ad:.10e}: {rel:.2e}")
    if not rel < 1e-5:
        raise AssertionError(f"phase 14e: Stokes viscosity gradient against FD {rel}")


def p14_operator_case(pt, name, n, where):
    """(GridOperator, ndofs) of a phase-14f case with every constraint mask
    on `where` (the card or the CPU)."""
    import torch
    from dune_pdelab_tpu_torch.fe.hcurl import N0Cube, N0Simplex
    from dune_pdelab_tpu_torch.fe.mimetic import DiffusionMFD, MimeticFEM
    from dune_pdelab_tpu_torch.ops import ConvectionDiffusionProblem, CurlCurl, CurlCurlParameters
    from dune_pdelab_tpu_torch.ops import DiffusionMixed

    class Field(ConvectionDiffusionProblem):
        def A(self, x):
            return 1.0 + 0.5 * x[..., 0] + 0.25 * x[..., 1] ** 2

        def f(self, x):
            return torch.sin(3 * x[..., 0]) * torch.cos(2 * x[..., 1])

        def g(self, x):
            return x[..., 0] ** 2 - x[..., 1] + 0.5

    class Source(CurlCurlParameters):
        def f(self, x):
            return torch.sin(2.0 * x + 0.3)

    if name.startswith("mixed-"):
        kind = name[len("mixed-"):]
        dim = 3 if kind == "RT0tet" else 2
        _, W, _, _ = p14_mixed_space(pt, kind, n if dim == 2 else n // 2, dim)
        return pt.GridOperator(W, DiffusionMixed(Field())), W.ndofs
    if name.startswith("curl-"):
        dim = int(name[-1])
        unit = pt.StructuredMesh([0.0] * dim, [1.0] * dim, ((n if dim == 2 else n // 2),) * dim)
        V = (pt.FunctionSpace(unit, N0Cube(dim)) if "cube" in name else
             pt.FunctionSpace(pt.SimplexMesh.from_structured(unit), N0Simplex(dim)))
        cons = pt.DirichletConstraints(V.boundary_edge_mask(), device=where)
        return pt.GridOperator(V, CurlCurl(Source(nu=1.3, beta=0.7)), constraints=cons), V.ndofs
    V = pt.FunctionSpace(pt.StructuredMesh([0.0, 0.0], [1.0, 1.0], (n, n)), MimeticFEM(2))
    return pt.GridOperator(V, DiffusionMFD(Field()),
                           constraints=pt.constraints(True, V, device=where)), V.ndofs


def card_vs_cpu(torch, pt, dev):
    """Phase 14f: residual and J.v at a seeded x, z on the card and on the
    CPU, at P14_SMALL^2 (half that per axis in 3D), fp64, within 1e-12 of
    max|y|; the card's fp32 residual within 1e-5 of the fp64 one."""
    import numpy as np

    cpu = torch.device("cpu")
    worst = {}
    for name in P14_CASES:
        got = []
        for where in (dev, cpu):
            go, nd = p14_operator_case(pt, name, P14_SMALL, where)
            rng = np.random.default_rng(1)
            x = torch.as_tensor(rng.standard_normal(nd), device=where)
            z = torch.as_tensor(rng.standard_normal(nd), device=where)
            got.append((go.residual(x).cpu(), go.jacobian_apply(x, z).cpu(),
                        go.residual(x.float()).cpu()))
        (r, j, r32), (rc, jc, _) = got
        e_r = float((r - rc).abs().max() / rc.abs().max())
        e_j = float((j - jc).abs().max() / jc.abs().max())
        e_32 = float((r32.double() - r).abs().max() / r.abs().max())
        worst[name] = (e_r, e_j, e_32)
        if not (e_r <= 1e-12 and e_j <= 1e-12 and e_32 <= 1e-5):
            raise AssertionError(f"phase 14f: {name}: residual {e_r}, J.v {e_j}, fp32 {e_32}")
    log(f"[phase 14f] card against CPU (residual, J.v of max|y|; fp32 residual against fp64): "
        + "; ".join(f"{k} {a:.1e}/{b:.1e}/{c:.1e}" for k, (a, b, c) in worst.items()))


def phase_slice13bc(torch, pt, dev):
    """Phase 14: slices 13b and 13c, fp64 unless stated; no kernel launches
    (K1-K6 decline H(div), H(curl) and mimetic leaves)."""
    for name, run in (("14a", mixed_cubes), ("14b", mixed_simplices), ("14c", hcurl_runs),
                      ("14d", mimetic_runs), ("14e", adjoint_runs), ("14f", card_vs_cpu)):
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        run(torch, pt, dev)
        torch.cuda.synchronize()
        log(f"[phase {name}] {time.perf_counter() - t0:.2f} s, peak {peak_gib(torch):.3f} GiB")
        torch.cuda.empty_cache()


# ---- phase 15: parallel/ on torch.distributed ranks sharing the card -------
# The p15_* functions run in the rank processes (dune_pdelab_tpu_torch.
# parallel.launch starts them and imports this file there); each counts the
# stencil27 launches of its sharded path in its own process and returns them.
def _p15_sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _p15_comm():
    from dune_pdelab_tpu_torch.parallel import comm
    st = comm.stats()
    return {"seconds": sum(v["seconds"] for v in st.values()),
            "bytes": sum(v["bytes"] for v in st.values()),
            "calls": {k: v["calls"] for k, v in st.items()}}


def p15_lattice(group, cells, tol, gather_below):
    """15a on this rank: the DOF-sharded stencil apply (1D mesh, and (2, 2)
    on four ranks) against the sequential one, and ShardedLatticeGMG-CG;
    on one rank also the sequential LatticeGMG-CG iterations."""
    import torch
    import torch.distributed as dist
    import dune_pdelab_tpu_torch as pt
    from dune_pdelab_tpu_torch.assembly.stencil import compile_stencil
    from dune_pdelab_tpu_torch.kernels import stencil27 as sk
    from dune_pdelab_tpu_torch.linalg.gmg_lattice import LatticeGMG
    from dune_pdelab_tpu_torch.ops import ConvectionDiffusionFEM, ConvectionDiffusionProblem
    from dune_pdelab_tpu_torch.parallel import DofShardedStencil, comm
    from dune_pdelab_tpu_torch.parallel.gmg_sharded import ShardedLatticeGMG

    class Lap(ConvectionDiffusionProblem):
        def A(self, x):
            return 1.0

    dev = pt.default_device()         # the rank's card (launch.py sets it)
    n = dist.get_world_size(group)
    f32 = torch.float32
    t0 = time.perf_counter()
    mesh = pt.StructuredMesh([0.0] * 3, [1.0] * 3, (cells,) * 3)
    V = pt.FunctionSpace(mesh, pt.QkFEM(1, 3))
    lop = ConvectionDiffusionFEM(Lap())
    # pure Dirichlet: no boundary kernels, so compile_stencil probes a proxy
    # mesh (a full-size probe holds ~13 GiB a rank)
    go = pt.GridOperator(V, lop, constraints=pt.constraints(True, V, device=dev),
                         skip_boundary=True)
    st = compile_stencil(go, dtype=f32, device=dev)
    gmg = LatticeGMG(V, lop, fine_stencil=st, device=dev)
    gen = torch.Generator(dev).manual_seed(15)
    z = torch.randn(V.ndofs, dtype=f32, device=dev, generator=gen)
    b = torch.where(st.mask, 0.0, torch.randn(V.ndofs, dtype=f32, device=dev, generator=gen))
    y_seq = st(z)                                   # comparison: not counted
    out = {"setup_s": time.perf_counter() - t0, "ndofs": V.ndofs}
    if n == 1:
        _, info = gmg.solve_host(b, tol=tol, maxiter=50)
        out["seq_its"] = info["iterations"]
    _p15_sync(torch, dev)
    k0 = sk.launches
    comm.reset_stats()
    t0 = time.perf_counter()
    errs = {}
    for shape in [(n,)] + ([(2, 2)] if n == 4 else []):
        sh = DofShardedStencil(st, group=group, mesh_shape=shape, device=dev)
        yb = sh(sh.device_put(z))
        ref = sh.device_put(y_seq)
        errs[shape] = float((yb - ref).abs().max() / y_seq.abs().max())
    _p15_sync(torch, dev)
    out["apply_s"] = time.perf_counter() - t0
    sgmg = ShardedLatticeGMG(gmg, group=group, gather_below=gather_below, device=dev)
    comm.reset_stats()
    t0 = time.perf_counter()
    xg, info = sgmg.solve_host(b, tol=tol, maxiter=50)
    _p15_sync(torch, dev)
    m = sgmg.padded[0][0] // sgmg.mesh_shape[0]      # fine planes a rank holds
    c = sgmg.coords[0]
    out.update(solve_s=time.perf_counter() - t0, info=info, comm=_p15_comm(),
               apply_err={str(k): v for k, v in errs.items()}, n_sharded=sgmg.n_sharded,
               padded=sgmg.padded[0][0], real_planes=max(0, min(cells + 1, (c + 1) * m) - c * m),
               k2=sk.launches - k0)
    return out


def p15_dg(group, config8, cells):
    """15b on this rank: config8 through the port's ALL_CONFIGS (the
    window-sharded operator over the world group of the eight ranks); or,
    config8=False, the 256^2 degree-1 SIPG residual and J.v on `group`
    against the one-rank operator."""
    import numpy as np
    import torch
    import torch.distributed as dist
    import dune_pdelab_tpu_torch as pt
    from dune_pdelab_tpu_torch.ops import ConvectionDiffusionDG, DGMethod
    from dune_pdelab_tpu_torch.parallel import WindowShardedGridOperator, comm

    dev = pt.default_device()
    comm.reset_stats()
    if config8:
        from dune_pdelab_tpu_torch.models import ALL_CONFIGS
        t0 = time.perf_counter()
        got = ALL_CONFIGS["config8"](cells=cells, device=dev)
        _p15_sync(torch, dev)
        out = {"ndofs": got["ndofs"], "ranks": got["ndevices"],
               "config_s": time.perf_counter() - t0, "iterations": got["iterations"],
               "l2_error": got["l2_error"]}
    else:
        p = sine2d_problem()
        mesh = pt.StructuredMesh([0.0, 0.0], [1.0, 1.0], (cells, cells))
        V = pt.FunctionSpace(mesh, pt.QkDGFEM(1, 2))
        go = pt.GridOperator(V, ConvectionDiffusionDG(p, method=DGMethod.SIPG))
        w = WindowShardedGridOperator(go, group=group, device=dev)
        out = {"ndofs": V.ndofs, "ranks": dist.get_world_size(group)}
        rng = np.random.default_rng(15)
        x = torch.as_tensor(rng.standard_normal(V.ndofs), device=dev)
        zv = torch.as_tensor(rng.standard_normal(V.ndofs), device=dev)
        r1, j1 = go.residual(x), go.jacobian_apply(x, zv)      # the one-rank operator
        _p15_sync(torch, dev)
        t0 = time.perf_counter()
        r2, j2 = w.residual(x), w.jacobian_apply(x, zv)
        _p15_sync(torch, dev)
        out.update(apply_s=time.perf_counter() - t0,
                   r_err=float((r2 - r1).abs().max() / r1.abs().max()),
                   j_err=float((j2 - j1).abs().max() / j1.abs().max()))
    out["comm"] = _p15_comm()
    return out


def p15_amg(group, cells, setups):
    """15c on this rank: ShardedAMG-CG on phase 11b's simplex P1 problem,
    fp64 to 1e-10, once for each hierarchy setup in `setups`: "coupled"
    (setup_parts=1, the one-rank hierarchy on every rank count) and
    "default" (from_grid_operator's own: one aggregation partition per rank,
    the decoupled setup users get on several ranks)."""
    import torch
    import torch.distributed as dist
    import dune_pdelab_tpu_torch as pt
    from dune_pdelab_tpu_torch.parallel import ShardedAMG, comm

    dev = pt.default_device()
    p = sine2d_problem()
    t0 = time.perf_counter()
    V, go = simplex_poisson(pt, 2, cells, p, dev)
    x0 = pt.interpolate_dirichlet(p.g, V, go.cg, V.zero(torch.float64, dev))
    r = go.residual(x0)
    out = {"space_s": time.perf_counter() - t0, "ndofs": V.ndofs,
           "ranks": dist.get_world_size(group)}
    for name in setups:
        t0 = time.perf_counter()
        samg = ShardedAMG.from_grid_operator(go, x0, group=group, device=dev,
                                             setup_parts=1 if name == "coupled" else None)
        run = {"setup_s": time.perf_counter() - t0, "levels": samg.sizes}
        comm.reset_stats()
        t0 = time.perf_counter()
        zz, stats = samg.solve_cg(r, tol=1e-10)
        _p15_sync(torch, dev)
        run.update(solve_s=time.perf_counter() - t0, iterations=int(stats.iterations),
                   converged=bool(stats.converged),
                   true_rel=float(torch.linalg.norm(go.residual(x0 - zz))
                                  / torch.linalg.norm(r)), comm=_p15_comm())
        out[name] = run
    return out


def p15_warm(group):
    """The first torch.func call of a process imports its machinery (~7 s
    on the card's machine): every rank pays it at once here."""
    import torch
    import dune_pdelab_tpu_torch as pt
    x = torch.ones(3, device=pt.default_device())
    torch.func.jvp(torch.sin, (x,), (x,))
    return str(x.device)


def _p15_log(tag, res, wall, extra=""):
    """One line per sub-phase: wall seconds, rank 0's communication
    (seconds, bytes, calls) against its solve or apply, K2 launches."""
    c = res[0]["comm"]
    spent = res[0].get("solve_s", res[0].get("apply_s", res[0].get("config_s", 0.0)))
    k2 = sum(r.get("k2", 0) for r in res)
    log(f"[{tag}] {len(res)} rank(s): {wall:.2f} s wall; rank 0 communication "
        f"{c['seconds']:.3f} s of {spent:.3f} s ({100 * c['seconds'] / max(spent, 1e-9):.1f}%), "
        f"{c['bytes']} bytes, calls {c['calls']}; stencil27 launches {k2}{extra}; {CARD}")
    return k2


def phase_parallel(torch, pt, dev):
    """Phase 15: slice 12 (parallel/) with one process per rank. (a) the
    DOF-sharded stencil (stencil27 on each rank's halo-extended block) and
    ShardedLatticeGMG-CG at P15_CELLS^3 cells, fp32: one rank on NCCL, then
    P15_RANKS ranks sharing the card over gloo (host-staged halos), with a
    (2, 2) rank mesh for the apply; (b) config8 on 8 ranks and the
    P15_DG_CELLS^2 SIPG residual and J.v on P15_RANKS ranks; (c)
    ShardedAMG-CG on phase 11b's problem at P15_AMG_CELLS^2 on P15_RANKS
    ranks against one rank. The ranks' stencil27 launches are added to this
    process's count."""
    from dune_pdelab_tpu_torch.kernels import _build
    from dune_pdelab_tpu_torch.kernels import stencil27 as sk
    from dune_pdelab_tpu_torch.parallel.launch import RankPool

    _build.library()             # built once here, loaded by every rank
    gold = json.loads((ROOT / "tests" / "golden_parity.json").read_text())[
        "config8_windowed_sharded"]
    k2 = 0
    t0 = time.perf_counter()
    with RankPool(8, backend="gloo", timeout=600) as pool:
        warm = pool.submit(p15_warm)      # the eight ranks start beside the one-rank runs
        with RankPool(1, backend="nccl", timeout=600) as one:
            t = time.perf_counter()
            a1 = one.run(p15_lattice, P15_CELLS, P15_GMG_TOL, P15_GATHER_BELOW)
            k2 += _p15_log("phase 15a 1 rank, NCCL", a1, time.perf_counter() - t,
                           f"; setup {a1[0]['setup_s']:.2f} s, GMG-CG "
                           f"{a1[0]['info']['iterations']} iterations (sequential "
                           f"{a1[0]['seq_its']}) in {a1[0]['solve_s']:.3f} s, apply error "
                           f"{a1[0]['apply_err']}, fine planes {a1[0]['padded']} padded "
                           f"for {P15_CELLS + 1}")
            t = time.perf_counter()
            c1 = [r["coupled"] for r in one.run(p15_amg, P15_AMG_CELLS, ("coupled",))]
            _p15_log("phase 15c 1 rank, NCCL", c1, time.perf_counter() - t,
                     f"; {c1[0]['iterations']} AMG-CG iterations, setup {c1[0]['setup_s']:.2f} s")
        log(f"[phase 15] one-rank pool (NCCL) {time.perf_counter() - t0:.2f} s")
        devices = warm.result()
        log(f"[phase 15] 8 gloo ranks on {sorted(set(devices))} ready "
            f"{time.perf_counter() - t0:.2f} s after the phase began")
        t = time.perf_counter()
        a4 = pool.run(p15_lattice, P15_CELLS, P15_GMG_TOL, P15_GATHER_BELOW,
                      nranks=P15_RANKS)
        k2 += _p15_log(f"phase 15a {P15_RANKS} ranks, gloo", a4, time.perf_counter() - t,
                       f"; GMG-CG {a4[0]['info']['iterations']} iterations in "
                       f"{a4[0]['solve_s']:.3f} s, apply errors "
                       f"{[r['apply_err'] for r in a4]}, fine planes {a4[0]['padded']} "
                       f"padded for {P15_CELLS + 1}, real planes a rank "
                       f"{[r['real_planes'] for r in a4]}")
        t = time.perf_counter()
        b8 = pool.run(p15_dg, True, 16)
        _p15_log("phase 15b config8, 8 ranks", b8, time.perf_counter() - t,
                 f"; {b8[0]['iterations']} CG iterations (golden {gold['iterations']}), L2 "
                 f"{b8[0]['l2_error']!r} (golden {gold['l2_error']!r})")
        t = time.perf_counter()
        b4 = pool.run(p15_dg, False, P15_DG_CELLS, nranks=P15_RANKS)
        _p15_log(f"phase 15b SIPG {P15_DG_CELLS}^2, {P15_RANKS} ranks", b4,
                 time.perf_counter() - t,
                 f"; residual / J.v against one rank {[(r['r_err'], r['j_err']) for r in b4]}")
        t = time.perf_counter()
        c4all = pool.run(p15_amg, P15_AMG_CELLS, ("coupled", "default"), nranks=P15_RANKS)
        wall = time.perf_counter() - t
        c4, c4d = [r["coupled"] for r in c4all], [r["default"] for r in c4all]
        for what, res in (("coupled setup", c4), ("default setup", c4d)):
            _p15_log(f"phase 15c {P15_RANKS} ranks, gloo, {what}", res, wall,
                     f"; {res[0]['iterations']} AMG-CG iterations (one rank "
                     f"{c1[0]['iterations']}), true rel defect {res[0]['true_rel']:.3e}, "
                     f"setup {res[0]['setup_s']:.2f} s, levels {res[0]['levels']}")
    sk.launches += k2
    bad = []
    for tag, res in (("15a 1 rank", a1), (f"15a {P15_RANKS} ranks", a4)):
        for r in res:
            info = r["info"]
            if not (info["converged"] and info["true_defect"] <= P15_TRUE_REL * info["defect0"]):
                bad.append(f"{tag}: GMG-CG {info}")
            if max(r["apply_err"].values()) > P15_APPLY_REL:
                bad.append(f"{tag}: apply error {r['apply_err']}")
    if a1[0]["info"]["iterations"] != a1[0]["seq_its"]:
        bad.append(f"15a: one rank {a1[0]['info']['iterations']} iterations, sequential "
                   f"{a1[0]['seq_its']}")
    if abs(a4[0]["info"]["iterations"] - a1[0]["seq_its"]) > 1:
        bad.append(f"15a: {P15_RANKS} ranks {a4[0]['info']['iterations']} iterations")
    if not (b8[0]["iterations"] == gold["iterations"] and b8[0]["ndofs"] == gold["ndofs"]
            and b8[0]["ranks"] == gold["ndevices"]
            and abs(b8[0]["l2_error"] / gold["l2_error"] - 1) <= 1e-8):
        bad.append(f"15b config8: {b8[0]}")
    if max(max(r["r_err"], r["j_err"]) for r in b4) > P15_DG_REL:
        bad.append(f"15b SIPG: {[(r['r_err'], r['j_err']) for r in b4]}")
    for tag, res in (("15c 1 rank", c1), (f"15c {P15_RANKS} ranks", c4),
                     (f"15c {P15_RANKS} ranks, default setup", c4d)):
        if not (res[0]["converged"] and res[0]["true_rel"] <= 1e-9):
            bad.append(f"{tag}: {res[0]}")
    if abs(c4[0]["iterations"] - c1[0]["iterations"]) > 1:
        bad.append(f"15c: {c4[0]['iterations']} against {c1[0]['iterations']} iterations")
    if bad:
        raise AssertionError("phase 15: " + "; ".join(bad))


# ---- phase 16: slice 13d (io, models, selective assembly) ------------------
def p16_vtk(torch, pt, dev, tmp):
    """16a: models.solve_stationary on phase 4's problem, its binary .vtu,
    a 32^3 ASCII .vtu from the card against the CPU port's, and .pvtu
    pieces from parallel/'s load balancing."""
    import xml.etree.ElementTree as ET

    import numpy as np
    from dune_pdelab_tpu_torch.io import ParallelVTKWriter, VTKWriter
    from dune_pdelab_tpu_torch.io.vtk_binary import read_vtu_binary
    from dune_pdelab_tpu_torch.kernels import stencil27 as sk
    from dune_pdelab_tpu_torch.models import CGSpace, StructuredGrid, solve_stationary
    from dune_pdelab_tpu_torch.ops import ConvectionDiffusionFEM
    from dune_pdelab_tpu_torch.parallel.loadbalance import partition_weighted
    from dune_pdelab_tpu_torch.solvers import SEQ_CG_Jacobi

    prob = unit_source_problem()
    V = CGSpace(StructuredGrid(3, README_CELLS), 1)
    ls = SEQ_CG_Jacobi()
    before = sk.launches
    res, wall = timed(torch, lambda: solve_stationary(
        V, ConvectionDiffusionFEM(prob), bctype=prob.dirichlet_bctype(), linear_solver=ls,
        reduction=1e-6, device=dev, dtype=torch.float32))
    rep = ls.report(res.solver.go)
    log(f"[phase 16a] ({CARD}) models.solve_stationary {README_CELLS}^3 fp32 (N = "
        f"{V.ndofs}): {res.iterations} Jacobi-CG iterations (phase 4: {README_JACOBI_ITS}), "
        f"{wall:.2f} s, stencil27 launches {sk.launches - before}; {rep.splitlines()[0]}")
    if not ("stencil27 CUDA kernel" in rep and res.iterations == README_JACOBI_ITS
            and res.solver.result.converged and bool(torch.isfinite(res.x).all())):
        raise AssertionError(f"16a: solve_stationary left the stencil tier or phase 4's "
                             f"count: {res.iterations} iterations, {rep}")
    written, w_s = timed(torch, lambda: res.vtk(str(tmp / "readme")))
    size = Path(written).stat().st_size
    binary = b'format="appended"' in Path(written).read_bytes()[:4096]
    host = VTKWriter(V.mesh).add_field(V, res.x, "u").point_data["u"]
    dec = read_vtu_binary(written)
    Path(written).unlink()
    same = (np.array_equal(dec["PointData"]["u"], host)
            and np.array_equal(dec["Points"][:, :3], V.mesh.vertex_coords()))
    log(f"[phase 16a] ({CARD}) StationaryResultBundle.vtk: binary .vtu {binary} of "
        f"{V.mesh.nvertices} vertices, {size} bytes in {w_s:.3f} s ({size / 1e6 / w_s:.1f} "
        f"MB/s, the host copy and the native write); the decoded payload bit-equal to the "
        f"host copy: {same}")
    if not (binary and same):
        raise AssertionError("16a: the binary .vtu is missing or differs from the host copy")

    V32 = CGSpace(StructuredGrid(3, P16_ASCII_CELLS), 1)
    r32 = solve_stationary(V32, ConvectionDiffusionFEM(prob), bctype=prob.dirichlet_bctype(),
                           linear_solver=SEQ_CG_Jacobi(), reduction=1e-10, device=dev,
                           dtype=torch.float64)
    files = {}
    for where, x in (("card", r32.x), ("cpu", r32.x.cpu())):
        w = VTKWriter(V32.mesh).add_field(V32, x, "u").add_field(V32, x, "u_mean", mode="cell")
        means = w.cell_data.pop("u_mean")
        files[where] = (w.write(str(tmp / f"{where}32"), binary=False), means)
    text_equal = Path(files["card"][0]).read_bytes() == Path(files["cpu"][0]).read_bytes()
    mean_err = float(np.abs(files["card"][1] - files["cpu"][1]).max()
                     / np.abs(files["cpu"][1]).max())
    mesh = V32.mesh
    centers = mesh.element_centers()
    ranges = partition_weighted(1.0 + centers[:, 0], P16_PARTS)
    owner = np.concatenate([np.full(hi - lo, r) for r, (lo, hi) in enumerate(ranges)])
    pvtu = ParallelVTKWriter(mesh, torch.as_tensor(owner, device=dev)).add_field(
        V32, r32.x, "u").write(str(tmp / "par32"))
    cents, counts = [], []
    for pc in ET.parse(pvtu).findall(".//Piece"):
        piece = ET.parse(str(tmp / pc.get("Source")))
        pts = np.array(piece.find(".//Points/DataArray").text.split(), float).reshape(-1, 3)
        conn = np.array(piece.find(".//Cells/DataArray[@Name='connectivity']").text.split(),
                        np.int64).reshape(-1, 8)
        cents.append(pts[conn].mean(axis=1))
        counts.append(len(conn))
    cents = np.concatenate(cents)
    covered = (len(cents) == mesh.nelements and np.abs(
        cents[np.lexsort(cents.T[::-1])] - centers[np.lexsort(centers.T[::-1])]).max() < 1e-9)
    log(f"[phase 16a] ({CARD}) {P16_ASCII_CELLS}^3 ASCII .vtu written from the card equal "
        f"to the CPU port's: {text_equal}; cell means card vs CPU {mean_err:.2e} of max; "
        f".pvtu over {P16_PARTS} load-balanced parts of {counts} cells, every cell once: "
        f"{covered}")
    if not (text_equal and mean_err <= 1e-12 and covered
            and counts == [hi - lo for lo, hi in ranges]):
        raise AssertionError("16a: the ASCII or the partitioned VTK output is wrong")


def p16_write_msh(path, verts, tets):
    """A tetrahedral MSH 2.2 ASCII file (node ids from 1, physical tag 7)."""
    import numpy as np
    nv, nt = len(verts), len(tets)
    nodes = np.column_stack([np.arange(1, nv + 1), verts]).ravel().tolist()
    els = np.column_stack([np.arange(1, nt + 1), np.full(nt, 4), np.full(nt, 2),
                           np.full(nt, 7), np.ones(nt, np.int64), tets + 1]).ravel().tolist()
    with open(path, "w") as f:
        f.write(f"$MeshFormat\n2.2 0 8\n$EndMeshFormat\n$Nodes\n{nv}\n")
        f.write(("%d %r %r %r\n" * nv) % tuple(nodes))
        f.write(f"$EndNodes\n$Elements\n{nt}\n")
        f.write(("%d %d %d %d %d %d %d %d %d\n" * nt) % tuple(els))
        f.write("$EndElements\n")


def p16_msh(torch, pt, dev, tmp):
    """16b: the native MSH reader against the Python parser on a written
    tetrahedral file, and a P1 SEQ_CG_AMG solve on the mesh read."""
    import numpy as np
    from dune_pdelab_tpu_torch.io import msh_native
    from dune_pdelab_tpu_torch.models import solve_stationary
    from dune_pdelab_tpu_torch.ops import ConvectionDiffusionFEM
    from dune_pdelab_tpu_torch.space.functions import l2_difference

    n = P16_MSH_CELLS
    sm = pt.SimplexMesh.from_structured(pt.StructuredMesh([0] * 3, [1] * 3, (n,) * 3))
    path = str(tmp / "tets.msh")
    t0 = time.perf_counter()
    p16_write_msh(path, sm.vertices, sm.cells)
    w_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    nat = msh_native.parse_msh(path)
    n_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    py = pt.SimplexMesh._parse_msh_py(path)
    p_s = time.perf_counter() - t0
    equal = all(a.dtype == b.dtype and np.array_equal(a, b) for a, b in zip(nat, py))
    t0 = time.perf_counter()
    mesh = pt.SimplexMesh.from_gmsh(path)
    m_s = time.perf_counter() - t0
    log(f"[phase 16b] ({CARD}) MSH 2.2 file of {len(sm.cells)} tets, {sm.nvertices} nodes "
        f"({Path(path).stat().st_size} bytes, written in {w_s:.2f} s): native parse "
        f"{n_s:.3f} s, Python parse {p_s:.3f} s ({p_s / n_s:.1f}x), arrays and tags equal: "
        f"{equal}; from_gmsh took the {mesh.msh_reader} reader, {m_s:.2f} s with the mesh "
        f"setup")
    if not (equal and mesh.msh_reader == "native" and mesh.nelements == len(sm.cells)
            and np.array_equal(mesh.vertices, sm.vertices)
            and np.all(mesh.cell_tags == 7)):
        raise AssertionError("16b: the native and Python MSH parses differ")
    prob = sine3d_problem()
    V = pt.FunctionSpace(mesh, pt.PkFEM(1, 3))
    ls = pt.SEQ_CG_AMG()
    res, s = timed(torch, lambda: solve_stationary(
        V, ConvectionDiffusionFEM(prob), bctype=prob.dirichlet_bctype(), linear_solver=ls,
        reduction=1e-10, device=dev, dtype=torch.float64))
    l2 = float(l2_difference(V, res.x, prob.exact))
    bound = 3.0 / n**2             # P1's h^2 rate (4.2e-2 measured at n = 6)
    log(f"[phase 16b] ({CARD}) P1 SEQ_CG_AMG on the mesh read (N = {V.ndofs}): "
        f"{res.iterations} iterations, L2 error {l2:.6e} (bound {bound:.2e}), {s:.2f} s "
        f"with the AMG setup")
    if not (res.solver.result.converged and l2 < bound):
        raise AssertionError(f"16b: the P1 AMG solve failed: L2 {l2}")


def p16_dgf(torch, pt, dev, tmp):
    """16c: read_dgf on an Interval block; its Q1 solve equals the
    StructuredGrid one."""
    from dune_pdelab_tpu_torch.io import read_dgf
    from dune_pdelab_tpu_torch.models import CGSpace, StructuredGrid, solve_stationary
    from dune_pdelab_tpu_torch.ops import ConvectionDiffusionFEM
    from dune_pdelab_tpu_torch.solvers import SEQ_CG_Jacobi

    n = P16_DGF_CELLS
    path = tmp / "block.dgf"
    path.write_text(f"DGF\n% unit square\nInterval\n0 0\n1 1\n{n} {n}\n#\n"
                    "Boundarydomain\ndefault 1\n#\n")
    mesh = read_dgf(str(path))
    prob = sine2d_problem()
    out = {}
    for tag, m in (("dgf", mesh), ("grid", StructuredGrid(2, n))):
        res, s = timed(torch, lambda: solve_stationary(
            CGSpace(m, 1), ConvectionDiffusionFEM(prob), bctype=prob.dirichlet_bctype(),
            dirichlet=prob.g, linear_solver=SEQ_CG_Jacobi(), reduction=1e-8, device=dev,
            dtype=torch.float64))
        out[tag] = (res.x, res.iterations, s)
    equal = torch.equal(out["dgf"][0], out["grid"][0])
    log(f"[phase 16c] ({CARD}) read_dgf {n}^2 Interval block ({type(mesh).__name__}, "
        f"boundary domain {mesh.boundary_domain_default}): Q1 Jacobi-CG {out['dgf'][1]} "
        f"iterations in {out['dgf'][2]:.2f} s, the StructuredGrid solve {out['grid'][1]} in "
        f"{out['grid'][2]:.2f} s, solutions bit-equal: {equal}")
    if not (equal and out["dgf"][1] == out["grid"][1] and mesh.cells == (n, n)
            and mesh.boundary_domain_default == 1):
        raise AssertionError("16c: the DGF mesh's solve differs from the StructuredGrid one")


def p16_selective(torch, pt, dev, tmp):
    """16d: selective assembly in fp64 on the card."""
    import numpy as np
    from dune_pdelab_tpu_torch.assembly.structured_fused import make_fused_residual
    from dune_pdelab_tpu_torch.ops import (
        ConvectionDiffusionDG, ConvectionDiffusionFEM, ConvectionDiffusionProblem,
    )

    f64 = torch.float64

    class Prob(ConvectionDiffusionProblem):
        """tests/test_selective.py's problem: A = 1 + x, c = 0.5, Dirichlet
        on x = 0, Neumann j = 0.3 elsewhere."""

        def A(self, x):
            return 1.0 + x[..., 0]

        def c(self, x):
            return 0.5

        def f(self, x):
            return torch.sin(3 * x[..., 0]) + x[..., 1]

        def bctype(self, x):
            return 1 * (x[..., 0] < 1e-12)

        def g(self, x):
            return x[..., 1]

        def j(self, x):
            return 0.3

    def select(base, entity=None, intersection=None):
        attrs = {}
        if entity is not None:
            attrs["skip_entity"] = lambda self, c: entity(c)
        if intersection is not None:
            attrs["skip_intersection"] = lambda self, m: intersection(m)
        return type("Selective" + base.__name__, (base,), attrs)(Prob())

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    def rand(n, seed):
        return torch.as_tensor(np.random.default_rng(seed).standard_normal(n), dtype=f64,
                               device=dev)

    left, right = (lambda c: c[..., 0] >= 0.5), (lambda c: c[..., 0] < 0.5)
    V = pt.FunctionSpace(pt.StructuredMesh([0, 0], [1, 1], (P16_SEL_Q1,) * 2), pt.QkFEM(1, 2))
    cons = pt.constraints(Prob().dirichlet_bctype(), V, device=dev)
    x, z = rand(V.ndofs, 3), rand(V.ndofs, 4)
    gos = [pt.GridOperator(V, lop, constraints=cons) for lop in (
        ConvectionDiffusionFEM(Prob()), select(ConvectionDiffusionFEM, left),
        select(ConvectionDiffusionFEM, right))]
    (rf, rl, rr), t_r = timed(torch, lambda: [go.residual(x) for go in gos])
    # J.v is the identity on constrained rows: the halves hold z there twice
    free = ~cons.mask_on(dev)
    jf, jl, jr = (go.jacobian_apply(x, z)[free] for go in gos)
    e_cg = (rel(rl + rr, rf), rel(jl + jr, jf))

    V = pt.FunctionSpace(pt.StructuredMesh([0, 0], [1, 1], (P16_SEL_DG,) * 2),
                         pt.QkDGFEM(1, 2))
    x = rand(V.ndofs, 5)
    preds = (None, lambda m: m[..., 0] >= 0.5, lambda m: m[..., 0] < 0.5,
             lambda m: torch.ones(m.shape[:-1], dtype=torch.bool, device=m.device))
    r_full, r_a, r_b, r_none = (pt.GridOperator(V, ConvectionDiffusionDG(Prob()) if p is None
                                                else select(ConvectionDiffusionDG, None, p)
                                                ).residual(x) for p in preds)
    e_dg = rel(r_a + r_b, r_full + r_none)
    skel = rel(r_none, r_full)

    V = pt.FunctionSpace(pt.StructuredMesh([0, 0], [1, 1], (P16_SEL_CPU,) * 2),
                         pt.QkDGFEM(1, 2))
    go = pt.GridOperator(V, select(ConvectionDiffusionDG, lambda c: c[..., 1] > 0.7,
                                   lambda m: m[..., 0] < 0.3))
    x, z = rand(V.ndofs, 6), rand(V.ndofs, 7)
    e_dev = max(rel(go.residual(x).cpu(), go.residual(x.cpu())),
                rel(go.jacobian_apply(x, z).cpu(), go.jacobian_apply(x.cpu(), z.cpu())))

    V = pt.FunctionSpace(pt.StructuredMesh([0] * 3, [1] * 3, (P16_SEL_K3,) * 3),
                         pt.QkFEM(1, 3))
    cons = pt.constraints(True, V, device=dev)
    k3 = [make_fused_residual(pt.GridOperator(V, lop, constraints=cons, skip_boundary=True))
          for lop in (ConvectionDiffusionFEM(Prob()), select(ConvectionDiffusionFEM, left))]
    log(f"[phase 16d] ({CARD}) selective assembly fp64: {P16_SEL_Q1}^2 Q1 complementary "
        f"skip_entity, residual {e_cg[0]:.2e} and J.v {e_cg[1]:.2e} of the full operator's "
        f"(three residuals {t_r:.3f} s); {P16_SEL_DG}^2 SIPG skip_intersection partition "
        f"{e_dg:.2e} (the skeleton's share {skel:.2e}); card vs CPU at {P16_SEL_CPU}^2 "
        f"{e_dev:.2e}; K3 at {P16_SEL_K3}^3: plain {'taken' if k3[0] else 'declined'}, "
        f"selective {'taken' if k3[1] else 'declined'}")
    if not (max(e_cg) <= P16_SEL_REL and e_dg <= P16_SEL_REL and skel > 1e-6
            and e_dev <= P16_SEL_REL and k3[0] is not None and k3[1] is None):
        raise AssertionError("16d: selective assembly identities or K3's decline failed")


def p16_instationary(torch, pt, dev, tmp):
    """16e: solve_instationary from tests/test_boilerplate_config.py's INI
    with its .pvd and checkpoints written from the card."""
    import xml.etree.ElementTree as ET

    from dune_pdelab_tpu_torch.models import CGSpace, StructuredGrid, solve_instationary
    from dune_pdelab_tpu_torch.ops import ConvectionDiffusionFEM
    from dune_pdelab_tpu_torch.space.functions import l2_difference
    from dune_pdelab_tpu_torch.utils import CheckpointManager, ParameterTree

    prob = heat_problem(2)
    V = CGSpace(StructuredGrid(2, P16_HEAT_CELLS), 1)
    x0 = V.interpolate(prob.u_exact(0.0), dtype=torch.float64, device=dev)
    (t, x, osm), s = timed(torch, lambda: solve_instationary(
        V, ConvectionDiffusionFEM(prob), bctype=prob.dirichlet_bctype(), x0=x0,
        ptree=ParameterTree.from_ini(P16_INI), vtk_basename=str(tmp / "heat"),
        checkpoint_dir=str(tmp / "ck")))
    l2 = float(l2_difference(V, x, prob.u_exact(t)))
    step = CheckpointManager(str(tmp / "ck")).latest_step()
    sets = len(ET.parse(str(tmp / "heat.pvd")).findall(".//DataSet"))
    log(f"[phase 16e] ({CARD}) solve_instationary from the INI at {P16_HEAT_CELLS}^2 (N = "
        f"{V.ndofs}): t = {t!r}, {osm.result.steps} steps, latest checkpoint step {step}, "
        f".pvd with {sets} data sets, L2 error {l2:.6e} (bound {P16_HEAT_L2_MAX}), {s:.2f} s")
    if not (abs(t - 0.2) < 1e-12 and step == 8 and sets == 9 and l2 < P16_HEAT_L2_MAX):
        raise AssertionError("16e: the INI instationary run failed")


def phase_slice13d(torch, pt, dev):
    """Phase 16: slice 13d (io, models, selective assembly)."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="chip_smoke_p16_") as d:
        for tag, fn in (("16a", p16_vtk), ("16b", p16_msh), ("16c", p16_dgf),
                        ("16d", p16_selective), ("16e", p16_instationary)):
            t0 = time.perf_counter()
            fn(torch, pt, dev, Path(d))
            torch.cuda.empty_cache()
            log(f"[phase {tag}] {time.perf_counter() - t0:.2f} s")


# ---- phase 17: the examples/ scripts (dune_pdelab_tpu_torch.examples) -------
P17_MAIN = ("ex02_convectiondiffusion_dg", "ex15_north_star_scaling", "ex01_poisson",
            "ex03_nonlinear_newton", "ex04_instationary_heat", "ex06_adaptive_lshape",
            "ex12_goal_oriented_adaptivity", "ex10_acoustics_explicit_rk")
P17_RANKED = ("ex14_unstructured_amg", "ex07_parallel_poisson",
              "ex08_windowed_stokes_parallel")
# the examples that helper processes run beside this process's (host-bound
# loops each, the card mostly idle): one process per group, a group of
# multi-rank examples with its own pool
P17_GROUPS = (("ex05_stokes_taylor_hood", "ex11_pde_constrained_optimization"),
              ("ex09_darcy_porous_media", "ex13_twophase_flow"),
              ("ex14_unstructured_amg", "ex07_parallel_poisson"),
              ("ex08_windowed_stokes_parallel",))


def p17_checks(name, r):
    """The reference scripts' checks that run() does not make itself (it
    raises on the others: 07, 08, 09, 10, 11's misfit, 12, 13, 14)."""
    import numpy as np
    bad = []
    if name == "ex02_convectiondiffusion_dg":
        if not P17_ORDER[0] <= r["order"] <= P17_ORDER[1]:
            bad.append(f"order {r['order']}")
        if "element-major" not in r["solve_path"]:
            bad.append(f"solve path {r['solve_path']}")
    elif name == "ex11_pde_constrained_optimization":
        if not r["theta_error"] <= P17_THETA_ERR:
            bad.append(f"theta {r['theta']}")
    elif name == "ex15_north_star_scaling":
        if not (r["converged"] and r["refine_rel"] <= 1e-8):
            bad.append(f"{r}")
    elif name in ("ex07_parallel_poisson", "ex14_unstructured_amg"):
        s = r if name == "ex07_parallel_poisson" else r["sharded"]
        diff = s["max_diff"] if name == "ex07_parallel_poisson" else s["diff"]
        if not (s["iterations"] == s["iterations_seq"] and diff <= P17_PARITY
                and s["ranks"] == P17_RANKS):
            bad.append(f"{s}")
    finite = [v for v in r.values() if isinstance(v, float)]
    if not all(np.isfinite(finite)):
        bad.append("non-finite result")
    return bad


def p17_summary(r):
    """The numbers of a run's dict worth a log line (no arrays or paths)."""
    import numpy as np
    keep = {}
    for k, v in r.items():
        if isinstance(v, dict):
            keep[k] = p17_summary(v)
        elif isinstance(v, str) and k not in ("vtu", "pvtu"):
            keep[k] = " | ".join(line.strip() for line in v.splitlines())
        elif isinstance(v, (int, float, bool)):
            keep[k] = v
        elif isinstance(v, list) and len(v) <= 12 and all(
                isinstance(e, (int, float, str)) for e in v):
            keep[k] = v
        elif isinstance(v, np.ndarray) and v.size <= 8:
            keep[k] = v.tolist()
    return keep


def p17_one(torch, name, dev, out, pool=None):
    """One example's run() at the reference's size, timed, with its kernel
    launches and the checks' failures."""
    import importlib

    from dune_pdelab_tpu_torch.examples import _kernels

    mod = importlib.import_module(f"dune_pdelab_tpu_torch.examples.{name}")
    kw = {"refine": True} if name == "ex15_north_star_scaling" else {}
    if pool is not None:
        kw["pool"] = pool
    before = _kernels.snapshot()
    t0 = time.perf_counter()
    r = mod.run(device=dev, out_dir=str(Path(out) / name), **kw)
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    # this process's launches and, for a multi-rank example, its ranks'
    launches = _kernels.summed([_kernels.since(before), r.get("rank_launches", {})])
    return {"name": name, "seconds": time.perf_counter() - t0,
            "launches": launches, "why": p17_checks(name, r),
            "summary": p17_summary(r)}


def p17_worker(names, out, card, device):
    """A helper process of phase 17: runs `names` (on one pool of P17_RANKS
    gloo ranks when they are multi-rank examples) and prints one "P17
    {json}" line per example. Started by phase_examples."""
    import torch

    global CARD
    CARD = card
    torch.set_num_threads(P17_HELPER_THREADS)
    dev = torch.device(device)
    if set(names) & set(P17_RANKED):
        from dune_pdelab_tpu_torch.parallel.launch import RankPool
        with RankPool(P17_RANKS, backend="gloo", timeout=900,
                      device="cpu" if dev.type == "cpu" else None) as pool:
            for name in names:
                print("P17 " + json.dumps(p17_one(torch, name, dev, out, pool), default=str),
                      flush=True)
    else:
        for name in names:
            print("P17 " + json.dumps(p17_one(torch, name, dev, out), default=str), flush=True)


def p17_log(res):
    log(f"[phase 17] {res['name']}: {res['seconds']:.2f} s, launches {res['launches']}, "
        f"{'checks held' if not res['why'] else 'FAILED ' + '; '.join(res['why'])}; "
        f"{json.dumps(res['summary'], default=str)}; {CARD}")
    return [f"{res['name']}: {w}" for w in res["why"]]


def phase_examples(torch, pt, dev):
    """Phase 17: the fifteen example scripts' run() on the card at the
    reference scripts' sizes (ex15 with its fp64 refinement), each held to
    the reference's checks. P17_MAIN run in this process; each group of
    P17_GROUPS in a helper process started first, beside them (a group of
    multi-rank examples on a pool of P17_RANKS gloo ranks), whose kernel
    launches are added to this process's counts; and ex01 as a user runs
    it, `python -m dune_pdelab_tpu_torch.examples.ex01_poisson`, in a
    subprocess beside them. Logs each example's seconds and launches."""
    import tempfile

    from dune_pdelab_tpu_torch.examples import _kernels

    bad = []
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_p17_") as d:
        out = Path(d)
        helpers = []
        for i, names in enumerate(P17_GROUPS):
            code = (f"import sys; sys.path.insert(0, {str(ROOT)!r}); import chip_smoke as c; "
                    f"c.p17_worker({list(names)!r}, {d!r}, {CARD!r}, {str(dev)!r})")
            helpers.append((names, start_group(code, out / f"group{i}.log", P17_HELPER_THREADS)))
        cli_out = out / "cli"
        cmd = [sys.executable, "-m", "dune_pdelab_tpu_torch.examples.ex01_poisson",
               "--out", str(cli_out)]
        t_cli = time.perf_counter()
        with open(out / "cli.log", "w") as f:
            cli = subprocess.Popen(cmd, cwd=str(ROOT), stdout=f, stderr=subprocess.STDOUT,
                                   start_new_session=True)
        try:
            for name in P17_MAIN:
                bad += p17_log(p17_one(torch, name, dev, d))
            log(f"[phase 17] this process's examples done {time.perf_counter() - t_phase:.2f} s "
                f"after the phase began")

            rc = cli.wait(timeout=900)
            lines = (out / "cli.log").read_text().strip().splitlines()
            log(f"[phase 17] {' '.join(cmd[1:])}: exit {rc}, "
                f"{time.perf_counter() - t_cli:.2f} s after its start (beside the examples), "
                f"last lines {lines[-3:]}")
            if not (rc == 0 and lines and lines[-1] == "OK"
                    and (cli_out / "poisson.vtu").is_file()):
                bad.append(f"ex01 command: exit {rc}, {lines[-20:]}")

            for i, (names, proc) in enumerate(helpers):
                rc = proc.wait(timeout=1200)
                text = (out / f"group{i}.log").read_text()
                got = [json.loads(line[4:]) for line in text.splitlines()
                       if line.startswith("P17 ")]
                for res in got:
                    bad += p17_log(res)
                    for k, n in res["launches"].items():
                        mod, attr = _kernels.COUNTERS[k]
                        setattr(mod, attr, getattr(mod, attr) + n)
                missing = [n for n in names if n not in {r["name"] for r in got}]
                log(f"[phase 17] helper {i} ({', '.join(names)}): exit {rc}, done "
                    f"{time.perf_counter() - t_phase:.2f} s after the phase began")
                if rc != 0 or missing:
                    bad.append(f"helper {i}: exit {rc}, missing {missing}: {text[-3000:]}")
        finally:
            for proc in [cli] + [proc for _, proc in helpers]:
                stop_group(proc)
    if bad:
        raise AssertionError("phase 17: " + "; ".join(bad))


# ---- lanes: phases 10-14 and 16 in processes beside phases 8, 9 and 15 -----
# Each of these phases is a host-bound loop that leaves the card mostly idle
# and needs nothing of an earlier phase but the built kernel library. After
# phase 7 (the last phase that times a kernel for the kernels line) the
# lanes start, one process each, which runs its phases in turn; phases 8, 9
# and 15 run in this process meanwhile, and phase 17 starts when every lane
# is done. Each phase still sets the launch counts to 0, drives its path
# and reads them (drive_path); this process adds them to its totals.
LANE_PHASES = {       # number: (title, function, kernels the path must launch)
    "10": ("phase 10 (composite spaces, Stokes)", "phase_stokes", ()),
    "11": ("phase 11 (algebraic solvers)", "phase_algebraic", ("stencil27", "blockstencil_mm")),
    "12": ("phase 12 (adaptivity, mesh breadth)", "phase_adaptivity", ()),
    "13": ("phase 13 (slice 13a: P0, modal DG, CCFV, two-phase, waves)", "phase_slice13a",
           ("blockstencil_em", "blockstencil_mm")),
    "14": ("phase 14 (slices 13b/13c: H(div), H(curl), mimetic, adjoints)",
           "phase_slice13bc", ()),
    "16": ("phase 16 (slice 13d: io, models, selective assembly)", "phase_slice13d",
           ("stencil27",)),
}
LANES = (("13", "16"), ("10", "14"), ("12", "11"))   # ~200 s each alone (PERF.md section 5)
LANE_THREADS = 2      # CPU threads of a lane (three lanes, this process and asides share 8 cores)
LANE_WAIT = 900       # seconds a lane may take after the lanes start


def drive_path(torch, name, run):
    """Set every launch count to 0, drive one path, read the counts after it;
    logs and returns the path's seconds and counts."""
    from dune_pdelab_tpu_torch.examples import _kernels

    for mod, attr in _kernels.COUNTERS.values():
        setattr(mod, attr, 0)
    t0 = time.perf_counter()
    run()
    torch.cuda.empty_cache()    # other processes start ranks on the card
    res = {"name": name, "seconds": time.perf_counter() - t0,
           "counts": {k: getattr(mod, attr) for k, (mod, attr) in _kernels.COUNTERS.items()},
           "reserved_gib": torch.cuda.memory_reserved() / 2**30}
    log(f"{name}: {res['seconds']:.2f} s, launch counts {res['counts']}, "
        f"{res['reserved_gib']:.2f} GiB reserved after it")
    return res


def lane_worker(keys, card):
    """A lane process: drives LANE_PHASES[k] for k in keys, in turn, and
    prints one "LANE {json}" line (drive_path's result) after each."""
    import torch

    global CARD
    CARD = card
    torch.set_num_threads(LANE_THREADS)
    import dune_pdelab_tpu_torch as pt
    from dune_pdelab_tpu_torch.kernels import _build

    _build.library()            # built by the main process: loaded here
    dev = torch.device("cuda")
    for k in keys:
        title, fn, _ = LANE_PHASES[k]
        res = drive_path(torch, title, lambda: globals()[fn](torch, pt, dev))
        print("LANE " + json.dumps(res), flush=True)


def start_group(code, log_path, threads):
    """`python -c code` from the checkout, its output to log_path, in a
    session of its own, so that stop_group ends it and every process it
    started."""
    env = dict(os.environ, **{v: str(threads) for v in
                              ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS")})
    with open(log_path, "w") as f:
        return subprocess.Popen([sys.executable, "-c", code], cwd=str(ROOT), stdout=f,
                                stderr=subprocess.STDOUT, env=env, start_new_session=True)


def stop_group(proc):
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except ProcessLookupError:
        pass                    # it and every process it started have ended
    proc.wait()


def start_lanes(d):
    """Start one process per group of LANES; returns (keys, process, log)."""
    lanes = []
    for keys in LANES:
        code = (f"import sys; sys.path.insert(0, {str(ROOT)!r}); import chip_smoke as c; "
                f"c.lane_worker({list(keys)!r}, {CARD!r})")
        path = Path(d) / f"lane_{'_'.join(keys)}.log"
        lanes.append((keys, start_group(code, path, LANE_THREADS), path))
    log(f"[lanes] phases {', '.join('+'.join(k) for k in LANES)} started, one process each, "
        f"beside phases 8, 9 and 15")
    return lanes


def lane_failed(keys, rc, path):
    text = path.read_text()
    return AssertionError(f"the lane of phases {', '.join(keys)} exited {rc}:\n{text[-4000:]}")


def check_lanes(lanes):
    """Fail now if a lane has already failed."""
    for keys, proc, path in lanes:
        rc = proc.poll()
        if rc not in (None, 0):
            raise lane_failed(keys, rc, path)


def finish_lanes(lanes, t_start):
    """Wait for every lane, print its log, and return each phase's result
    with the kernels it must have launched."""
    out = []
    for keys, proc, path in lanes:
        try:
            rc = proc.wait(timeout=max(LANE_WAIT - (time.perf_counter() - t_start), 1))
        except subprocess.TimeoutExpired:
            raise lane_failed(keys, "nothing (still running)", path) from None
        text = path.read_text()
        got = [json.loads(line[5:]) for line in text.splitlines() if line.startswith("LANE ")]
        print("".join(line + "\n" for line in text.splitlines() if not line.startswith("LANE ")),
              end="", flush=True)
        log(f"[lanes] phases {', '.join(keys)}: exit {rc}, done "
            f"{time.perf_counter() - t_start:.2f} s after the lanes started")
        if rc != 0 or len(got) != len(keys):
            raise lane_failed(keys, rc, path)
        out += [(res, LANE_PHASES[k][2]) for k, res in zip(keys, got)]
    return out


def main():
    if not (ROOT / "dune_pdelab_tpu_torch" / "csrc").is_dir():
        raise SystemExit("chip_smoke: run it from a checkout of the repository "
                         "(dune_pdelab_tpu_torch/ not found beside it)")
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (this script has no CPU path)")
    if torch.cuda.get_device_capability(0) != (9, 0):
        raise SystemExit(f"chip_smoke: needs a Hopper card (sm_90), found "
                         f"{torch.cuda.get_device_name(0)}")
    sys.path.insert(0, str(ROOT))
    import dune_pdelab_tpu_torch as pt
    from dune_pdelab_tpu_torch.examples import _kernels
    from dune_pdelab_tpu_torch.kernels import _build

    dev = torch.device("cuda")
    global CARD
    card = CARD = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    _build.library()
    log(f"[phase 1] kernels built in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {_build.build_seconds} s) -> {_build.library_path().name}")
    for name, regs, spill in ptxas_report(_build.build_log):
        log(f"[phase 1] {name}: {regs}; {spill}")

    n1 = MAIN_CELLS + 1
    main_dims = (n1, n1, n1)
    dims_list = [((128, 128, 128), torch.float32), ((128, 128, 128), torch.float64),
                 ((67, 45, 33), torch.float32), ((67, 45, 33), torch.float64),
                 (main_dims, torch.float32)]
    record = phase_kernels(torch, dims_list, main_dims, dev)
    phase_stencil_levels(torch, dev)
    record.update(phase_fused_kernel(torch, pt, dev))

    counters = _kernels.COUNTERS
    first = [
        ("phase 3 (fused CG)", lambda: phase_main(torch, pt, MAIN_CELLS, MAIN_ITERS, dev),
         ("stencil27", "fused_cg_k1", "fused_cg_k2")),
        ("phase 4 (README)", lambda: phase_readme(torch, pt, README_CELLS, dev),
         ("stencil27",)),
        ("phase 5 (multigrid)", lambda: phase_multigrid(torch, pt, dev),
         ("stencil27", "structured_fused")),
        ("phase 6 (assembled)", lambda: phase_assembled(torch, pt, dev, record),
         ("structured_fused", "ell27")),
        ("phase 7 (DG)", lambda: phase_dg(torch, pt, dev, record),
         ("blockstencil_mm", "blockstencil_em", "stencil27")),
    ]
    beside = [      # beside the lanes (LANE_PHASES)
        ("phase 8 (geometric multigrid)", lambda: phase_gmg(torch, pt, dev),
         ("blockstencil_em",)),
        ("phase 9 (Newton, time stepping)", lambda: phase_newton(torch, pt, dev),
         ("ell27",)),
        ("phase 15 (slice 12: parallel/ on ranks sharing the card)",
         lambda: phase_parallel(torch, pt, dev), ("stencil27",)),
    ]
    last = [
        ("phase 17 (examples)", lambda: phase_examples(torch, pt, dev),
         ("stencil27", "blockstencil_em")),
    ]
    totals = dict.fromkeys(counters, 0)

    def account(res, needed):
        missing = [k for k in needed if res["counts"][k] == 0]
        if missing:
            raise AssertionError(f"{res['name']} never launched {missing}: {res['counts']}")
        for k in totals:
            totals[k] += res["counts"][k]

    import tempfile
    lanes = []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_lanes_") as d:
        try:
            for name, run, needed in first:
                account(drive_path(torch, name, run), needed)
            lanes = start_lanes(d)
            t_lanes = time.perf_counter()
            for name, run, needed in beside:
                account(drive_path(torch, name, run), needed)
                check_lanes(lanes)
            for res, needed in finish_lanes(lanes, t_lanes):
                account(res, needed)
            for name, run, needed in last:
                account(drive_path(torch, name, run), needed)
        finally:
            for _, proc, _ in lanes:
                stop_group(proc)
    log(f"launch counts over phases 3-17: {totals}")

    meta = {
        "stencil27": ("dune_pdelab_tpu_torch/csrc/stencil27.cu",
                      "dune_pdelab_tpu/assembly/stencil_pallas_tile.py:65"),
        "fused_cg_k1": ("dune_pdelab_tpu_torch/csrc/fused_cg.cu",
                        "dune_pdelab_tpu/assembly/fused_cg_pallas.py:162"),
        "fused_cg_k2": ("dune_pdelab_tpu_torch/csrc/fused_cg.cu",
                        "dune_pdelab_tpu/assembly/fused_cg_pallas.py:222"),
        "structured_fused": ("dune_pdelab_tpu_torch/csrc/structured_fused.cu",
                             "dune_pdelab_tpu/assembly/structured_fused.py:256"),
        "ell27": ("dune_pdelab_tpu_torch/csrc/ell27.cu",
                  "dune_pdelab_tpu/assembly/ell_pallas.py:98"),
        "blockstencil_mm": ("dune_pdelab_tpu_torch/csrc/blockstencil.cu",
                            "dune_pdelab_tpu/assembly/blockstencil_mm.py:329"),
        "blockstencil_em": ("dune_pdelab_tpu_torch/csrc/blockstencil.cu",
                            "dune_pdelab_tpu/assembly/blockstencil_pallas.py:112"),
    }
    kernels = [dict(name=k, route="cuda", source=src, replaces=rep,
                    launches=totals[k], **record[k])
               for k, (src, rep) in meta.items()]
    log(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
