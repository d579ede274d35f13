from dune_pdelab_tpu_torch.utils.common import (  # noqa: F401
    INDEX_DTYPE, Timer, TimingReport, cdiv, default_device, default_float, round_up,
    set_default_device,
)
from dune_pdelab_tpu_torch.utils.config import ParameterTree  # noqa: F401
from dune_pdelab_tpu_torch.utils.checkpoint import (  # noqa: F401
    CheckpointManager, load_checkpoint, save_checkpoint,
)
from dune_pdelab_tpu_torch.utils.logging import Logger  # noqa: F401
