from dune_pdelab_tpu_torch.fe.basis import (  # noqa: F401
    FiniteElement, LegendreDGFEM, MonomialDGFEM, OPBFEM, P0FEM, PkDGFEM, PkFEM,
    QkDGFEM, QkFEM, RannacherTurekFEM,
)
from dune_pdelab_tpu_torch.fe.quadrature import (  # noqa: F401
    cube_rule, gauss_jacobi_alpha, gauss_legendre, gauss_lobatto, quadrature_rule,
    simplex_rule,
)
