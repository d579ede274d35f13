from dune_pdelab_tpu_torch.assembly.gridoperator import GridOperator  # noqa: F401
