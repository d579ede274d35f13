from dune_pdelab_tpu_torch.linalg.krylov import (  # noqa: F401
    SOLVERS, SolverStats, bicgstab, cg, minres, restarted_gmres, richardson_loop,
)
from dune_pdelab_tpu_torch.linalg import preconditioners  # noqa: F401,E402
from dune_pdelab_tpu_torch.linalg.multigrid import (  # noqa: F401,E402
    GeometricMultigrid, build_prolongation,
)
from dune_pdelab_tpu_torch.linalg.dgmultigrid import DGTwoLevel  # noqa: F401,E402
from dune_pdelab_tpu_torch.linalg.amg import AlgebraicMultigrid  # noqa: F401,E402
from dune_pdelab_tpu_torch.linalg.eigen import EigenResult, lobpcg  # noqa: F401,E402
from dune_pdelab_tpu_torch.linalg.geneo import (  # noqa: F401,E402
    GenEOLatticePreconditioner, GenEOPreconditioner, geneo_preconditioner_for,
)
