from dune_pdelab_tpu_torch.ops.base import (  # noqa: F401
    FaceContext, LeafTab, LocalOperator, SkeletonContext, VolumeContext,
)
from dune_pdelab_tpu_torch.ops.convectiondiffusion import (  # noqa: F401
    BCType, ConvectionDiffusionFEM, ConvectionDiffusionProblem, apply_tensor,
)
from dune_pdelab_tpu_torch.ops.convectiondiffusiondg import (  # noqa: F401
    ConvectionDiffusionDG, DGMethod,
)
