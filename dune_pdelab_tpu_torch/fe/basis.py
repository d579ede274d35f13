"""Finite element bases tabulated as dense numpy arrays.

PyTorch port of dune_pdelab_tpu/fe/basis.py, the scalar elements:
continuous QkFEM and discontinuous QkDGFEM (equidistant, Gauss-Legendre or
Gauss-Lobatto nodes) on the cube, continuous PkFEM and discontinuous
PkDGFEM on the simplex, piecewise constants P0FEM (cube and simplex), the
nonconforming RannacherTurekFEM and the modal DG bases LegendreDGFEM,
MonomialDGFEM and OPBFEM (reference: dune/pdelab/finiteelementmap/
{qkfem,qkdg,pkfem,p0fem,rannacherturekfem,monomfem,opbfem}.hh). A basis
is its tabulation: `tabulate(points)` returns dense (nqp, nb) /
(nqp, nb, dim) float64 arrays that the assembler turns into tensors; a
modal basis interpolates by discrete L2 projection (`interpolation_points`,
`interpolation_matrix`). All polynomial manipulation happens in float64
numpy at setup.
"""
from __future__ import annotations

import functools
import itertools

import numpy as np

from dune_pdelab_tpu_torch.fe.quadrature import (
    gauss_legendre, lobatto_points_weights, quadrature_rule,
)


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


def lagrange_nodes_1d(k: int, variant: str = "equidistant") -> np.ndarray:
    """1D Lagrange nodes on [0,1]: equidistant, Gauss-Legendre (`gl`, k+1
    interior points) or Gauss-Lobatto-Legendre (`lobatto`, ends included)."""
    if k == 0:
        return np.array([0.5])
    if variant == "equidistant":
        return np.linspace(0.0, 1.0, k + 1)
    if variant == "gl":
        return gauss_legendre(2 * k + 1)[0]
    if variant == "lobatto":
        return lobatto_points_weights(k + 1)[0]
    raise ValueError(f"unknown 1d node variant {variant!r}")


class FiniteElement:
    """A scalar finite element on a reference domain.

    Attributes:
      geometry:   'cube' or 'simplex'
      dim:        reference dimension
      degree:     polynomial degree (quadrature-order heuristic input)
      nbasis:     number of basis functions
      continuity: 'C0' (conforming nodal) or 'DG' (element-local)
      nodes:      (nbasis, dim) nodal points, or None for modal bases
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

    # coeffs = interpolation_matrix @ f(interpolation_points): identity at
    # the nodes for nodal bases, discrete L2 projection for modal ones
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

    def __init__(self, k: int, dim: int, continuity: str, variant: str = "equidistant"):
        self.dim = dim
        self.degree = k
        self.k = k
        self.continuity = continuity
        self.variant = variant
        self.nodes_1d = lagrange_nodes_1d(k, variant)
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
    """Discontinuous Qk with equidistant, Gauss-Legendre (`gl`) or
    Gauss-Lobatto (`lobatto`) nodes (reference:
    dune/pdelab/finiteelementmap/qkdg.hh variants)."""

    def __init__(self, k: int, dim: int, variant: str = "equidistant"):
        super().__init__(k, dim, "DG", variant)


def _tensor_indices(n1: int, dim: int) -> np.ndarray:
    """(n1**dim, dim) multi-indices, dim 0 fastest."""
    return np.array([tuple(reversed(t)) for t in itertools.product(range(n1), repeat=dim)])


class LegendreDGFEM(FiniteElement):
    """Modal tensor L2-orthonormal Legendre basis on the cube (reference:
    dune/pdelab/finiteelement/qkdglegendre.hh). Interpolation is the
    weighted inner product with the basis (it is orthonormal)."""

    geometry = "cube"
    continuity = "DG"
    nodes = None

    def __init__(self, k: int, dim: int):
        self.dim = dim
        self.degree = k
        self.k = k
        self.nbasis = (k + 1)**dim
        self._mi = _tensor_indices(k + 1, dim)
        self._ip, self._iw = quadrature_rule("cube", dim, 2 * k + 1)

    @staticmethod
    def _leg1d(i: int, x: np.ndarray):
        """Orthonormal shifted Legendre: sqrt(2i+1) P_i(2x-1) and derivative."""
        c = np.zeros(i + 1)
        c[i] = 1.0
        P = np.polynomial.legendre.Legendre(c, domain=[0.0, 1.0])
        s = np.sqrt(2 * i + 1)
        return s * P(x), s * P.deriv()(x)

    def tabulate(self, points: np.ndarray):
        points = np.atleast_2d(points)
        npts = points.shape[0]
        v1 = np.empty((self.dim, npts, self.k + 1))
        d1 = np.empty_like(v1)
        for d in range(self.dim):
            for i in range(self.k + 1):
                v1[d, :, i], d1[d, :, i] = self._leg1d(i, points[:, d])
        mi = self._mi
        vals = np.ones((npts, self.nbasis))
        for d in range(self.dim):
            vals *= v1[d][:, mi[:, d]]
        grads = np.empty((npts, self.nbasis, self.dim))
        for g in range(self.dim):
            gg = np.ones((npts, self.nbasis))
            for d in range(self.dim):
                f = d1[d] if d == g else v1[d]
                gg *= f[:, mi[:, d]]
            grads[:, :, g] = gg
        return vals, grads

    @property
    def interpolation_points(self):
        return self._ip

    @property
    def interpolation_matrix(self):
        vals, _ = self.tabulate(self._ip)        # (nqp, nb)
        return (vals * self._iw[:, None]).T


def _monomial_tabulation(exps: np.ndarray, points: np.ndarray):
    """Values (npts, nm) and gradients (npts, nm, dim) of the monomials
    x^e for the exponent rows of `exps` (nm, dim)."""
    points = np.atleast_2d(points)
    npts, dim = points.shape[0], exps.shape[1]
    vals = np.ones((npts, len(exps)))
    for d in range(dim):
        vals *= points[:, d:d + 1] ** exps[:, d]
    grads = np.empty((npts, len(exps), dim))
    for g in range(dim):
        gg = np.ones((npts, len(exps)))
        for d in range(dim):
            e = exps[:, d]
            if d == g:
                with np.errstate(divide="ignore", invalid="ignore"):
                    gg *= np.where(e == 0, 0.0,
                                   e * points[:, d:d + 1] ** np.maximum(e - 1, 0))
            else:
                gg *= points[:, d:d + 1] ** e
        grads[:, :, g] = gg
    return vals, grads


class MonomialDGFEM(FiniteElement):
    """Total-degree monomial DG basis x^alpha, |alpha| <= k, on cube or
    simplex reference elements (reference:
    dune/pdelab/finiteelementmap/monomfem.hh). Interpolation is discrete L2
    projection (a mass-matrix solve: the basis is not orthogonal)."""

    continuity = "DG"
    nodes = None

    def __init__(self, k: int, dim: int, geometry: str = "cube"):
        self.dim = dim
        self.degree = k
        self.k = k
        self.geometry = geometry
        self._exps = np.array(
            [mi for mi in itertools.product(range(k + 1), repeat=dim)
             if sum(mi) <= k], dtype=int)
        self.nbasis = len(self._exps)
        self._ip, self._iw = quadrature_rule(geometry, dim, 2 * k + 1)

    def _monomials(self, points: np.ndarray):
        return _monomial_tabulation(self._exps, points)

    def tabulate(self, points: np.ndarray):
        return self._monomials(points)

    @property
    def interpolation_points(self):
        return self._ip

    @property
    def interpolation_matrix(self):
        V, _ = self._monomials(self._ip)             # (nqp, nb)
        M = V.T @ (V * self._iw[:, None])            # Gram (mass) matrix
        return np.linalg.solve(M, (V * self._iw[:, None]).T)


class OPBFEM(MonomialDGFEM):
    """L2-orthonormal polynomial basis of total degree k on cube or simplex
    (reference: dune/pdelab/finiteelementmap/opbfem.hh,
    dune/pdelab/finiteelement/l2orthonormal.hh): the monomials
    orthonormalized by a Cholesky factor of their reference-element Gram
    matrix, so mass matrices are identity and interpolation is a weighted
    inner product."""

    def __init__(self, k: int, dim: int, geometry: str = "cube"):
        super().__init__(k, dim, geometry)
        V, _ = self._monomials(self._ip)
        G = V.T @ (V * self._iw[:, None])            # monomial Gram matrix
        L = np.linalg.cholesky(G)
        self._C = np.linalg.inv(L).T                 # basis = monomials @ C

    def tabulate(self, points: np.ndarray):
        V, dV = self._monomials(points)
        return V @ self._C, np.einsum("pmd,mb->pbd", dV, self._C)

    @property
    def interpolation_matrix(self):
        vals, _ = self.tabulate(self._ip)            # orthonormal
        return (vals * self._iw[:, None]).T


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
        return _monomial_tabulation(self._exps, points)

    def tabulate(self, points: np.ndarray):
        V, dV = self._monomials(points)
        return V @ self._C, np.einsum("pmd,mb->pbd", dV, self._C)


class PkDGFEM(PkFEM):
    """Discontinuous Pk on the simplex (reference:
    dune/pdelab/finiteelementmap/{monomfem.hh,opbfem.hh} analogs): the
    PkFEM lattice basis, numbered element-major like every DG space."""

    def __init__(self, k: int, dim: int):
        super().__init__(k, dim, continuity="DG")


class P0FEM(FiniteElement):
    """Piecewise constants on cube or simplex elements (reference:
    dune/pdelab/finiteelementmap/p0fem.hh); one DOF per element at its
    reference center."""

    continuity = "DG"

    def __init__(self, dim: int, geometry: str = "cube"):
        self.dim = dim
        self.degree = 0
        self.nbasis = 1
        self.geometry = geometry
        center = 0.5 if geometry == "cube" else 1.0 / (dim + 1)
        self.nodes = np.full((1, dim), center)

    def tabulate(self, points: np.ndarray):
        points = np.atleast_2d(points)
        n = points.shape[0]
        return np.ones((n, 1)), np.zeros((n, 1, self.dim))


class RannacherTurekFEM(FiniteElement):
    """Nonconforming rotated-bilinear element on the cube (reference:
    dune/pdelab/finiteelementmap/rannacherturekfem.hh): the face-midpoint
    nodal basis of span{1, x_i, x_i^2 - x_{i+1}^2}. Its DOFs are numbered
    as a DG space's (element-major): face continuity is not enforced, as
    in the reference."""

    geometry = "cube"
    continuity = "DG"

    def __init__(self, dim: int):
        self.dim = dim
        self.degree = 2
        self.nbasis = 2 * dim
        # nodes = face midpoints, ordered (axis, side): (-x, +x, -y, +y, ...)
        nodes = np.full((2 * dim, dim), 0.5)
        for a in range(dim):
            nodes[2 * a, a] = 0.0
            nodes[2 * a + 1, a] = 1.0
        self.nodes = nodes
        self._C = np.linalg.inv(self._monomials(nodes)[0])

    def _monomials(self, points: np.ndarray):
        """[1, x_0 .. x_{d-1}, x_0^2 - x_1^2, .., x_{d-2}^2 - x_{d-1}^2]."""
        points = np.atleast_2d(points)
        npts = points.shape[0]
        d = self.dim
        vals = np.ones((npts, 2 * d))
        grads = np.zeros((npts, 2 * d, d))
        col = 1
        for a in range(d):
            vals[:, col] = points[:, a]
            grads[:, col, a] = 1.0
            col += 1
        for a in range(d - 1):
            vals[:, col] = points[:, a] ** 2 - points[:, a + 1] ** 2
            grads[:, col, a] = 2 * points[:, a]
            grads[:, col, a + 1] = -2 * points[:, a + 1]
            col += 1
        return vals, grads

    def tabulate(self, points: np.ndarray):
        V, dV = self._monomials(points)
        return V @ self._C, np.einsum("pmd,mb->pbd", dV, self._C)


@functools.lru_cache(maxsize=None)
def _cached_fem(cls_name: str, *args):
    """One element per (class name, arguments), built once."""
    cls = {
        "QkFEM": QkFEM, "QkDGFEM": QkDGFEM, "PkFEM": PkFEM, "PkDGFEM": PkDGFEM,
        "P0FEM": P0FEM, "LegendreDGFEM": LegendreDGFEM,
        "RannacherTurekFEM": RannacherTurekFEM,
        "MonomialDGFEM": MonomialDGFEM, "OPBFEM": OPBFEM,
    }[cls_name]
    return cls(*args)


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
