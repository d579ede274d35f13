"""Finite element bases tabulated as dense numpy arrays.

PyTorch port of dune_pdelab_tpu/fe/basis.py, limited to the Lagrange
elements: continuous QkFEM and discontinuous QkDGFEM on the cube and
continuous PkFEM and discontinuous PkDGFEM on the simplex (the other
families wait for ROADMAP slice 13). A basis is its tabulation: `tabulate(points)` returns dense
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


def _poly_eval2(C: np.ndarray, x: np.ndarray):
    """Second derivatives of the polynomials given monomial coeffs C."""
    n = C.shape[0]
    powers = np.vander(x, n, increasing=True)
    d2 = np.zeros_like(powers)
    if n > 2:
        d2[:, 2:] = powers[:, :-2] * (np.arange(2, n) * np.arange(1, n - 1))
    return d2 @ C


def lagrange_nodes_1d(k: int) -> np.ndarray:
    """Equidistant 1D Lagrange nodes on [0,1]."""
    if k == 0:
        return np.array([0.5])
    return np.linspace(0.0, 1.0, k + 1)


class FiniteElement:
    """A scalar finite element on a reference domain.

    Attributes:
      geometry:   'cube' or 'simplex'
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


    def tabulate_hessian(self, points: np.ndarray):
        """(npts, nb, dim, dim) second derivatives (for error estimators)."""
        points = np.atleast_2d(points)
        vals1, ders1, ders2 = [], [], []
        for d in range(self.dim):
            v, dv = _poly_eval(self._C, points[:, d])
            vals1.append(v)
            ders1.append(dv)
            ders2.append(_poly_eval2(self._C, points[:, d]))
        mi = self._mi
        npts = points.shape[0]
        H = np.empty((npts, self.nbasis, self.dim, self.dim))
        for a in range(self.dim):
            for b in range(self.dim):
                gg = np.ones((npts, self.nbasis))
                for d in range(self.dim):
                    if d == a == b:
                        f = ders2[d]
                    elif d in (a, b):
                        f = ders1[d]
                    else:
                        f = vals1[d]
                    gg *= f[:, mi[:, d]]
                H[:, :, a, b] = gg
        return H


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
    wait for ROADMAP slice 13."""

    def __init__(self, k: int, dim: int, variant: str = "equidistant"):
        if variant != "equidistant":
            raise NotImplementedError(
                f"QkDGFEM variant {variant!r} is not ported yet (ROADMAP "
                "slice 13)")
        super().__init__(k, dim, "DG")


class PkFEM(FiniteElement):
    """Continuous Lagrange Pk on the simplex (reference:
    dune/pdelab/finiteelementmap/pkfem.hh): lattice-point nodal basis via a
    monomial Vandermonde, any k, any dimension."""

    geometry = "simplex"

    def __init__(self, k: int, dim: int, continuity: str = "C0"):
        if k < 1 and continuity == "C0":
            raise ValueError("PkFEM needs k >= 1 (use PkDGFEM(0, dim) for P0)")
        self.dim = dim
        self.degree = k
        self.k = k
        self.continuity = continuity
        if k == 0:
            self.nodes = np.full((1, dim), 1.0 / (dim + 1))
            self._exps = np.zeros((1, dim), dtype=int)
        else:
            pts, exps = [], []
            for mi in itertools.product(range(k + 1), repeat=dim):
                if sum(mi) <= k:
                    pts.append([m / k for m in mi])
                    exps.append(mi)
            self.nodes = np.array(pts)
            self._exps = np.array(exps, dtype=int)
        self.nbasis = len(self.nodes)
        V = self._monomials(self.nodes)[0]
        self._C = np.linalg.inv(V)  # vals = M(x) @ C

    def _monomials(self, points: np.ndarray):
        points = np.atleast_2d(points)
        npts = points.shape[0]
        nb = len(self._exps)
        vals = np.ones((npts, nb))
        for d in range(self.dim):
            vals *= points[:, d:d + 1] ** self._exps[:, d]
        grads = np.empty((npts, nb, self.dim))
        for g in range(self.dim):
            gg = np.ones((npts, nb))
            for d in range(self.dim):
                e = self._exps[:, d]
                if d == g:
                    with np.errstate(divide="ignore", invalid="ignore"):
                        gg *= np.where(
                            e == 0, 0.0,
                            e * points[:, d:d + 1] ** np.maximum(e - 1, 0))
                else:
                    gg *= points[:, d:d + 1] ** e
            grads[:, :, g] = gg
        return vals, grads

    def tabulate(self, points: np.ndarray):
        V, dV = self._monomials(points)
        return V @ self._C, np.einsum("pmd,mb->pbd", dV, self._C)


class PkDGFEM(PkFEM):
    """Discontinuous Pk on the simplex (reference:
    dune/pdelab/finiteelementmap/{monomfem.hh,opbfem.hh} analogs): the
    PkFEM lattice basis, numbered element-major like every DG space."""

    def __init__(self, k: int, dim: int):
        super().__init__(k, dim, continuity="DG")


@functools.lru_cache(maxsize=None)
def q1_geometry(dim: int) -> QkFEM:
    """The Q1 element that maps reference points into cube elements."""
    return QkFEM(1, dim)


@functools.lru_cache(maxsize=None)
def p1_geometry(dim: int) -> PkFEM:
    """The P1 element that maps reference points into simplex elements."""
    return PkFEM(1, dim)


def geometry_element(geometry: str, dim: int) -> FiniteElement:
    """The first-order element of a mesh's corner map: Q1 on cubes, P1 on
    simplices."""
    return q1_geometry(dim) if geometry == "cube" else p1_geometry(dim)
