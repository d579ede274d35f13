from dune_pdelab_tpu_torch.instationary.tableaux import (  # noqa: F401
    SCHEMES, TimeSteppingScheme, alexander2, alexander3, crank_nicolson,
    explicit_euler, fractional_step_theta, heun, implicit_euler, one_step_theta,
    rk4, shu3,
)
from dune_pdelab_tpu_torch.instationary.onestep import (  # noqa: F401
    CFLTimeController, ExplicitOneStepMethod, OneStepGridOperator, OneStepMethod,
    OneStepResult, StageContext, TimeControllerInterface,
)
from dune_pdelab_tpu_torch.instationary.differentiable import (  # noqa: F401
    differentiable_theta_rollout,
)
