from dune_pdelab_tpu_torch.linalg.krylov import SolverStats, cg  # noqa: F401
