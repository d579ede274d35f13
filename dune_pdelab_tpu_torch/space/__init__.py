from dune_pdelab_tpu_torch.space.space import (  # noqa: F401
    CompositeSpace, FunctionSpace, PermutedSpace, PowerSpace, VectorSpace,
    entity_blocked,
)
