from dune_pdelab_tpu_torch.fe.basis import FiniteElement, QkDGFEM, QkFEM  # noqa: F401
from dune_pdelab_tpu_torch.fe.quadrature import (  # noqa: F401
    cube_rule, gauss_legendre, quadrature_rule,
)
