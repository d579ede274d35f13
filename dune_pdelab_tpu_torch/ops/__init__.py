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
from dune_pdelab_tpu_torch.ops.stokes import (  # noqa: F401
    NavierStokesMass, NavierStokesParameters, StokesBC, TaylorHoodNavierStokes,
)
from dune_pdelab_tpu_torch.ops.dgnavierstokes import DGNavierStokes  # noqa: F401
from dune_pdelab_tpu_torch.ops.base import CombinedOperator, ScaledOperator  # noqa: F401
from dune_pdelab_tpu_torch.ops.elasticity import (  # noqa: F401
    LinearElasticity, LinearElasticityParameters,
)
from dune_pdelab_tpu_torch.ops.acoustics import LinearAcousticsDG  # noqa: F401
from dune_pdelab_tpu_torch.ops.maxwell import MaxwellDG  # noqa: F401
from dune_pdelab_tpu_torch.ops.ccfv import ConvectionDiffusionCCFV  # noqa: F401
from dune_pdelab_tpu_torch.ops.twophase import (  # noqa: F401
    BrooksCoreyParameters, TwoPhaseCCFV, TwoPhaseParameters, TwoPhaseStorage,
    TwoPhaseVelocity, VanGenuchtenParameters,
)
from dune_pdelab_tpu_torch.ops.darcy import (  # noqa: F401
    DarcyVelocityFromHeadCCFV, DarcyVelocityFromHeadFEM, darcy_velocity_at_quadrature,
    diagonal_permeability_field, permeability_field,
)
from dune_pdelab_tpu_torch.ops.diffusionmixed import DiffusionMixed  # noqa: F401
from dune_pdelab_tpu_torch.ops.electrodynamic import (  # noqa: F401
    CurlCurl, CurlCurlParameters,
)
