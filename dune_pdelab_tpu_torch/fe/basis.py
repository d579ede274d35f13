"""Finite element bases tabulated as dense numpy arrays.

PyTorch port of dune_pdelab_tpu/fe/basis.py, limited to the tensor
Lagrange elements: continuous QkFEM and discontinuous QkDGFEM (the other
families wait for later ROADMAP slices). A basis is its tabulation: `tabulate(points)` returns dense
(nqp, nb) / (nqp, nb, dim) float64 arrays that the assembler turns into
tensors. All polynomial manipulation happens in float64 numpy at setup.
"""
from __future__ import annotations

import functools
import itertools

import numpy as np


def _lagrange_coeffs(nodes: np.ndarray) -> np.ndarray:
    """Monomial coefficients C with basis_i(x) = sum_j C[j, i] x^j."""
    n = len(nodes)
    V = np.vander(nodes, n, increasing=True)  # V[i, j] = x_i^j
    return np.linalg.inv(V)


def _poly_eval(C: np.ndarray, x: np.ndarray):
    """Evaluate polynomials (and derivative) given monomial coeff matrix C (deg+1, nb)."""
    n = C.shape[0]
    powers = np.vander(x, n, increasing=True)        # (npts, n)
    dpowers = np.zeros_like(powers)
    if n > 1:
        dpowers[:, 1:] = powers[:, :-1] * np.arange(1, n)
    return powers @ C, dpowers @ C                   # (npts, nb) each


def lagrange_nodes_1d(k: int) -> np.ndarray:
    """Equidistant 1D Lagrange nodes on [0,1]."""
    if k == 0:
        return np.array([0.5])
    return np.linspace(0.0, 1.0, k + 1)


class FiniteElement:
    """A scalar finite element on a reference domain.

    Attributes:
      geometry:   'cube'
      dim:        reference dimension
      degree:     polynomial degree (quadrature-order heuristic input)
      nbasis:     number of basis functions
      continuity: 'C0' (conforming nodal) or 'DG' (element-local)
      nodes:      (nbasis, dim) nodal points
    """

    geometry: str
    dim: int
    degree: int
    nbasis: int
    continuity: str
    nodes: np.ndarray | None

    def tabulate(self, points: np.ndarray):
        """Return (values (npts, nb), gradients (npts, nb, dim))."""
        raise NotImplementedError

    @property
    def interpolation_points(self) -> np.ndarray:
        if self.nodes is None:
            raise NotImplementedError
        return self.nodes

    @property
    def interpolation_matrix(self) -> np.ndarray:
        return np.eye(self.nbasis)

    def __repr__(self):
        return (f"{self.__class__.__name__}(degree={self.degree}, dim={self.dim}, "
                f"nbasis={self.nbasis}, {self.continuity})")


class _TensorLagrange(FiniteElement):
    """Tensor-product Lagrange element Qk on the cube, dim-0-fastest ordering."""

    geometry = "cube"

    def __init__(self, k: int, dim: int, continuity: str):
        self.dim = dim
        self.degree = k
        self.k = k
        self.continuity = continuity
        self.variant = "equidistant"
        self.nodes_1d = lagrange_nodes_1d(k)
        self._C = _lagrange_coeffs(self.nodes_1d)
        n1 = len(self.nodes_1d)
        self.nbasis = n1**dim
        # multi-index per basis function, dim 0 fastest
        self._mi = np.array(
            [tuple(reversed(t)) for t in itertools.product(range(n1), repeat=dim)]
        )
        self.nodes = self.nodes_1d[self._mi]  # (nb, dim)

    def tabulate(self, points: np.ndarray):
        points = np.atleast_2d(points)
        vals1 = []
        ders1 = []
        for d in range(self.dim):
            v, dv = _poly_eval(self._C, points[:, d])
            vals1.append(v)    # (npts, k+1)
            ders1.append(dv)
        mi = self._mi
        npts = points.shape[0]
        vals = np.ones((npts, self.nbasis))
        for d in range(self.dim):
            vals *= vals1[d][:, mi[:, d]]
        grads = np.empty((npts, self.nbasis, self.dim))
        for g in range(self.dim):
            gg = np.ones((npts, self.nbasis))
            for d in range(self.dim):
                f = ders1[d] if d == g else vals1[d]
                gg *= f[:, mi[:, d]]
            grads[:, :, g] = gg
        return vals, grads


class QkFEM(_TensorLagrange):
    """Continuous Lagrange Qk (reference: dune/pdelab/finiteelementmap/qkfem.hh)."""

    def __init__(self, k: int, dim: int):
        if k < 1:
            raise ValueError("QkFEM needs k >= 1 (use P0FEM)")
        super().__init__(k, dim, "C0")


class QkDGFEM(_TensorLagrange):
    """Discontinuous Lagrange Qk with equidistant nodes (reference:
    dune/pdelab/finiteelementmap/qkdg.hh). The Gauss-Legendre and
    Gauss-Lobatto node variants, and the Legendre, monomial and OPB bases,
    wait for ROADMAP slice 13; PkDGFEM on simplices for slice 11."""

    def __init__(self, k: int, dim: int, variant: str = "equidistant"):
        if variant != "equidistant":
            raise NotImplementedError(
                f"QkDGFEM variant {variant!r} is not ported yet (ROADMAP "
                "slice 13)")
        super().__init__(k, dim, "DG")


@functools.lru_cache(maxsize=None)
def q1_geometry(dim: int) -> QkFEM:
    """The Q1 element that maps reference points into cube elements."""
    return QkFEM(1, dim)
