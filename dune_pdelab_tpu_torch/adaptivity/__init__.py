from dune_pdelab_tpu_torch.adaptivity.adaptivity import (  # noqa: F401
    adapt_uniform, element_fraction, error_fraction, mark_elements,
    residual_estimator_convectiondiffusion,
)
from dune_pdelab_tpu_torch.adaptivity.dgindicator import (  # noqa: F401
    MinmodSlopeLimiter, dg_jump_indicator,
)
from dune_pdelab_tpu_torch.adaptivity.dwr import dwr_indicators, space_transfer  # noqa: F401
from dune_pdelab_tpu_torch.adaptivity.local import (  # noqa: F401
    adapt_local, adapt_local_simplex, evaluate_fe, p1_edge_jump_indicator,
    volume_residual_indicator,
)
