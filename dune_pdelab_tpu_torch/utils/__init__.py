from dune_pdelab_tpu_torch.utils.common import (  # noqa: F401
    Timer, cdiv, default_float, round_up,
)
