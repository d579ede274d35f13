from dune_pdelab_tpu_torch.solvers.linear import (  # noqa: F401
    LinearSolverBackend, SEQ_CG_Jacobi,
)
from dune_pdelab_tpu_torch.solvers.stationary import (  # noqa: F401
    StationaryLinearProblemSolver, StationaryResult,
)
