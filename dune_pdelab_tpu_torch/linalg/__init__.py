from dune_pdelab_tpu_torch.linalg.krylov import (  # noqa: F401
    SOLVERS, SolverStats, bicgstab, cg, minres, restarted_gmres, richardson_loop,
)
from dune_pdelab_tpu_torch.linalg.dgmultigrid import DGTwoLevel  # noqa: F401,E402
