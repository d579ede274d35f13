from dune_pdelab_tpu_torch.ops.base import (  # noqa: F401
    LeafTab, LocalOperator, VolumeContext,
)
from dune_pdelab_tpu_torch.ops.convectiondiffusion import (  # noqa: F401
    BCType, ConvectionDiffusionFEM, ConvectionDiffusionProblem, apply_tensor,
)
