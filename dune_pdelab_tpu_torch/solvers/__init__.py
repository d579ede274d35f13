from dune_pdelab_tpu_torch.solvers.linear import (  # noqa: F401
    LinearSolverBackend, SEQ_CG_Jacobi, SEQ_BCGS_Jacobi, SEQ_GMRES_Jacobi,
    SEQ_CG_ILU0, SEQ_BCGS_ILU0, SEQ_CG_ILUn, SEQ_BCGS_ILUn,
    MatrixFree_CG_Richardson, SEQ_CG_BlockJacobi, SEQ_CG_SSOR, SEQ_BCGS_SSOR,
    SEQ_CG_AMG, SEQ_BCGS_AMG,
)
from dune_pdelab_tpu_torch.solvers.stationary import (  # noqa: F401
    StationaryLinearProblemSolver, StationaryResult,
)
from dune_pdelab_tpu_torch.solvers.newton import (  # noqa: F401
    NewtonError, NewtonMethod, NewtonResult,
)
from dune_pdelab_tpu_torch.solvers.utilities import (  # noqa: F401
    GridOperatorPreconditioner, SolverStatistics, check_lop_interface, dense_jacobian,
)
from dune_pdelab_tpu_torch.solvers.direct import (  # noqa: F401
    DirectSolverBackend, SEQ_SuperLU, SEQ_UMFPack, SparseLU,
)
from dune_pdelab_tpu_torch.solvers.differentiable import (  # noqa: F401
    differentiable_stationary_solve, implicit_solve, opaque_forward, parametric_residual,
)
