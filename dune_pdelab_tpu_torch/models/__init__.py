"""Ready-made problem setups (PyTorch port of dune_pdelab_tpu/models/): the
boilerplate layer and the target configurations (`ALL_CONFIGS`)."""
from dune_pdelab_tpu_torch.models.boilerplate import (
    CGSpace, DGSpace, GalerkinGlobalAssembler, P0Space, StationaryResultBundle,
    StructuredGrid, adaptive_solve, linear_solver_from_config, solve_instationary,
    solve_stationary,
)
from dune_pdelab_tpu_torch.models.configs import (
    ALL_CONFIGS, config1_poisson_2d_mf, config2_poisson_3d_gmg, config3_convdiff_sipg,
    config4_heat_theta_newton, config5_stokes_taylor_hood,
)
