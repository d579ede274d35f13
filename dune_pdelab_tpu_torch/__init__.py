"""dune_pdelab_tpu_torch: the PyTorch + CUDA port of dune_pdelab_tpu.

The JAX package `dune_pdelab_tpu` is the reference; this package mirrors its
subpackage tree module for module (each ported file names its reference
file) and runs on one NVIDIA H100. It imports torch and numpy, never jax.
Hand-written Hopper kernels live in `kernels/` (Python wrappers, launch
counters, plain PyTorch versions) with their CUDA sources in `csrc/`.

Ported so far: the 3D Poisson Q1 main path (structured mesh, QkFEM space,
Dirichlet constraints, volume assembly, slabbed residual, stencil
compilation, CG, fused CG, the CG + Jacobi backend and the stationary
driver) and its multigrid solve routes (LatticeGMG, VarCoeffGMG on the
fused structured Q1 operator, fp64 defect-correction refinement). See
ROADMAP.md for what remains.
"""

__version__ = "0.1.0"

from dune_pdelab_tpu_torch.mesh import StructuredMesh
from dune_pdelab_tpu_torch.fe import QkFEM, gauss_legendre, quadrature_rule
from dune_pdelab_tpu_torch.space import FunctionSpace
from dune_pdelab_tpu_torch.constraints import (
    DirichletConstraints, constraints, interpolate_dirichlet,
    set_constrained_dofs, set_nonconstrained_dofs, copy_constrained_dofs,
)
from dune_pdelab_tpu_torch.assembly import GridOperator
from dune_pdelab_tpu_torch.solvers import StationaryLinearProblemSolver
