"""dune_pdelab_tpu_torch: the PyTorch + CUDA port of dune_pdelab_tpu.

The JAX package `dune_pdelab_tpu` is the reference; this package mirrors its
subpackage tree module for module (each ported file names its reference
file) and runs on one NVIDIA H100. It imports torch and numpy, never jax.
Hand-written Hopper kernels live in `kernels/` (Python wrappers, launch
counters, plain PyTorch versions) with their CUDA sources in `csrc/`.

Ported so far: the 3D Poisson Q1 main path (structured mesh, QkFEM space,
Dirichlet constraints, volume assembly, slabbed residual, stencil
compilation, CG, fused CG, the CG + Jacobi backend and the stationary
solver), its multigrid solve routes (LatticeGMG, VarCoeffGMG on the
fused structured Q1 operator, fp64 defect-correction refinement) and the
assembled lattice-ELL path (ELL assembly and SpMV, lattice ILU(0)/ILU(n),
the Krylov solvers and their backends), the DG path (QkDGFEM, boundary
and skeleton face groups, SIPG/NIPG/IIPG, the block stencil in mode-major
and element-major layouts, block preconditioners, DGTwoLevel), geometric
multigrid on re-discretised levels (GeometricMultigrid, multicolor SSOR),
Newton (NewtonMethod) and one-step time stepping (instationary/),
composite spaces (CompositeSpace, PowerSpace, PermutedSpace,
entity_blocked) with multi-leaf assembly, Taylor-Hood and DG
(Navier-)Stokes (ops/stokes.py, ops/dgnavierstokes.py) with their block
preconditioners (solvers/stokes.py), and the algebraic solvers: simplex
meshes with PkFEM volume assembly, smoothed-aggregation AMG
(linalg/amg.py, SEQ_CG_AMG, DGTwoLevel(coarse="amg")), the sparse direct
backends (solvers/direct.py), LOBPCG (linalg/eigen.py) and GenEO
(linalg/geneo.py), and mesh breadth with adaptivity: periodic and mapped
structured meshes, the hanging-node AdaptiveMesh with affine constraints,
simplex and mapped face integrals, PkDGFEM, newest-vertex bisection
(SimplexMesh.refine_bisection), gmsh input and the estimators, marking and
transfers of adaptivity/; and the elements and operators of slice 13a:
P0, Rannacher-Turek and the modal DG bases, variable-order constraints,
cell-centered finite volumes (ops/ccfv.py) with Darcy post-processing,
two-phase flow (ops/twophase.py), linear elasticity, the acoustics and
Maxwell DG operators, and checkpoints and logging in utils/; and slices
13b and 13c: the H(div), H(curl) and mimetic elements (fe/hdiv.py,
fe/hcurl.py, fe/mimetic.py) with their face and edge DOF maps and Piola
maps, the mixed Darcy and curl-curl operators, and adjoint-differentiable
solves and rollouts (solvers/differentiable.py,
instationary/differentiable.py); and slice 12, distributed assembly and
solvers on torch.distributed with one process per rank (parallel/: the
halo exchange and reproducible global dots, the DOF-sharded stencil, the
window-sharded GridOperator, sharded geometric, lattice and algebraic
multigrid, load balancing and a rank launcher); and slice 13d: io/ (the
VTK writers with .pvd and .pvtu output, the native binary .vtu writer and
MSH parser built from csrc/ with g++, the DGF reader), models/ (the
boilerplate entry points and ALL_CONFIGS) and selective assembly
(skip_entity/skip_intersection) in the GridOperator. Every module of the
JAX package has its counterpart here.

Entry points put their tensors on `default_device()`, the card, unless the
caller names a device or calls `set_default_device` (the CPU tests do).
"""

__version__ = "0.1.0"

from dune_pdelab_tpu_torch.mesh import AdaptiveMesh, SimplexMesh, StructuredMesh
from dune_pdelab_tpu_torch.fe import (
    P0FEM, PkDGFEM, PkFEM, QkDGFEM, QkFEM, gauss_legendre, quadrature_rule,
)
from dune_pdelab_tpu_torch.space import (
    CompositeSpace, FunctionSpace, PermutedSpace, PowerSpace, entity_blocked,
)
from dune_pdelab_tpu_torch.constraints import (
    DirichletConstraints, constraints, interpolate_dirichlet,
    set_constrained_dofs, set_nonconstrained_dofs, copy_constrained_dofs,
)
from dune_pdelab_tpu_torch.assembly import GridOperator
from dune_pdelab_tpu_torch.linalg.krylov import (
    cg, bicgstab, minres, restarted_gmres, richardson_loop, SolverStats, SOLVERS,
)
from dune_pdelab_tpu_torch.solvers.linear import (
    LinearSolverBackend, SEQ_CG_Jacobi, SEQ_BCGS_Jacobi, SEQ_GMRES_Jacobi,
    MatrixFree_CG_Richardson, SEQ_CG_ILU0, SEQ_BCGS_ILU0, SEQ_CG_ILUn,
    SEQ_BCGS_ILUn, SEQ_CG_BlockJacobi, SEQ_CG_SSOR, SEQ_BCGS_SSOR,
    SEQ_CG_AMG, SEQ_BCGS_AMG,
)
from dune_pdelab_tpu_torch.linalg.dgmultigrid import DGTwoLevel
from dune_pdelab_tpu_torch.utils.common import default_device, set_default_device
from dune_pdelab_tpu_torch.solvers import NewtonMethod, StationaryLinearProblemSolver
