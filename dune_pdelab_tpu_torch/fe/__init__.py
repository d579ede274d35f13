from dune_pdelab_tpu_torch.fe.basis import (  # noqa: F401
    FiniteElement, PkDGFEM, PkFEM, QkDGFEM, QkFEM,
)
from dune_pdelab_tpu_torch.fe.quadrature import (  # noqa: F401
    cube_rule, gauss_jacobi_alpha, gauss_legendre, quadrature_rule, simplex_rule,
)
