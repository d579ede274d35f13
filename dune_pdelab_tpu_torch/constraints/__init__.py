from dune_pdelab_tpu_torch.constraints.dirichlet import (  # noqa: F401
    DirichletConstraints, constraints, copy_constrained_dofs,
    copy_nonconstrained_dofs, interpolate_dirichlet, no_constraints,
    set_constrained_dofs, set_nonconstrained_dofs,
)
