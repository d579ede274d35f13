from dune_pdelab_tpu_torch.space.space import FunctionSpace  # noqa: F401
