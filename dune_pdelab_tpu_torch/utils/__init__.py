from dune_pdelab_tpu_torch.utils.common import (  # noqa: F401
    Timer, cdiv, default_device, default_float, round_up, set_default_device,
)
