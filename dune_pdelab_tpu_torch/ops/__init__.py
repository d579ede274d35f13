from dune_pdelab_tpu_torch.ops.base import (  # noqa: F401
    FaceContext, LeafTab, LocalOperator, SkeletonContext, VolumeContext,
)
from dune_pdelab_tpu_torch.ops.convectiondiffusion import (  # noqa: F401
    BCType, ConvectionDiffusionFEM, ConvectionDiffusionProblem, apply_tensor,
)
from dune_pdelab_tpu_torch.ops.convectiondiffusiondg import (  # noqa: F401
    ConvectionDiffusionDG, DGMethod,
)
from dune_pdelab_tpu_torch.ops.l2 import L2, L2VolumeFunctional  # noqa: F401
from dune_pdelab_tpu_torch.ops.nonlinearconvectiondiffusion import (  # noqa: F401
    NonlinearConvectionDiffusionFEM, NonlinearConvectionDiffusionProblem,
)
