"""Quadrature rules on reference cubes and simplices.

PyTorch port of dune_pdelab_tpu/fe/quadrature.py: tensor Gauss rules on
the cube, collapsed (Duffy) Gauss-Jacobi rules on the simplex and the
Gauss-Lobatto rule (the nodes of the `lobatto` Lagrange variant). Rules are
float64 numpy arrays computed once at setup, exactly as in the reference.
Reference domains: cube = [0,1]^d, simplex = {x : x_i >= 0, sum x_i <= 1}.
"""
from __future__ import annotations

import functools
import itertools

import numpy as np


@functools.lru_cache(maxsize=None)
def gauss_legendre(order: int):
    """Gauss-Legendre rule on [0,1] exact for polynomials of degree `order`.

    Returns (points (n,), weights (n,)) as float64 numpy arrays.
    """
    n = order // 2 + 1
    x, w = np.polynomial.legendre.leggauss(n)  # on [-1,1]
    return (x + 1.0) / 2.0, w / 2.0


@functools.lru_cache(maxsize=None)
def gauss_jacobi_alpha(order: int, alpha: int):
    """Gauss-Jacobi rule on [0,1] with weight (1-x)^alpha, degree-`order` exact."""
    from scipy.special import roots_jacobi

    n = order // 2 + 1
    x, w = roots_jacobi(n, alpha, 0.0)  # weight (1-x)^a on [-1,1]
    # map to [0,1]: x' = (x+1)/2, weight (1-x)^a dx = (2(1-x'))^a 2 dx'
    return (x + 1.0) / 2.0, w / 2.0 ** (alpha + 1)


@functools.lru_cache(maxsize=None)
def gauss_lobatto(order: int):
    """Gauss-Lobatto rule on [0,1] (includes endpoints), exact to `order`."""
    # n-point Lobatto is exact to degree 2n-3  =>  n = ceil((order+3)/2)
    n = max(2, -(-(order + 3) // 2))
    return lobatto_points_weights(n)


@functools.lru_cache(maxsize=None)
def lobatto_points_weights(n: int):
    """n-point Gauss-Lobatto-Legendre nodes/weights on [0,1]: the interior
    nodes are the roots of P'_{n-1}."""
    if n == 2:
        x = np.array([-1.0, 1.0])
    else:
        c = np.zeros(n)
        c[-1] = 1.0
        dP = np.polynomial.legendre.Legendre(c).deriv()
        x = np.concatenate([[-1.0], np.sort(dP.roots().real), [1.0]])
    Pn1 = np.polynomial.legendre.Legendre.basis(n - 1)(x)
    w = 2.0 / (n * (n - 1) * Pn1**2)
    return (x + 1.0) / 2.0, w / 2.0


def cube_rule(dim: int, order: int):
    """Tensor-product Gauss rule on [0,1]^dim. Returns (points (nqp,dim), weights (nqp,))."""
    if dim == 0:
        return np.zeros((1, 0)), np.ones((1,))
    x, w = gauss_legendre(order)
    pts = np.array(list(itertools.product(x, repeat=dim)))[:, ::-1]  # dim 0 fastest
    wts = np.array([np.prod(c) for c in itertools.product(w, repeat=dim)])
    return np.ascontiguousarray(pts), wts


def simplex_rule(dim: int, order: int):
    """Collapsed (Duffy) Gauss rule on the reference simplex.

    Gauss-Jacobi weights in the collapsed directions integrate the Jacobian
    powers of the Duffy map exactly; total degree `order`.
    """
    if dim == 1:
        x, w = gauss_legendre(order)
        return x[:, None], w
    if dim == 2:
        xa, wa = gauss_legendre(order)
        xb, wb = gauss_jacobi_alpha(order + 1, 1)
        pts, wts = [], []
        for b, vb in zip(xb, wb):
            for a, va in zip(xa, wa):
                # Duffy: (a,b) in [0,1]^2 -> (x,y) = (a(1-b), b); |J| = (1-b)
                pts.append((a * (1.0 - b), b))
                wts.append(va * vb)  # (1-b) absorbed by the Jacobi weight
        return np.array(pts), np.array(wts)
    if dim == 3:
        xa, wa = gauss_legendre(order)
        xb, wb = gauss_jacobi_alpha(order + 1, 1)
        xc, wc = gauss_jacobi_alpha(order + 2, 2)
        pts, wts = [], []
        for c, vc in zip(xc, wc):
            for b, vb in zip(xb, wb):
                for a, va in zip(xa, wa):
                    # x = a(1-b)(1-c), y = b(1-c), z = c; |J| = (1-b)(1-c)^2
                    pts.append((a * (1 - b) * (1 - c), b * (1 - c), c))
                    wts.append(va * vb * vc)
        return np.array(pts), np.array(wts)
    raise NotImplementedError(f"simplex quadrature for dim={dim}")


def quadrature_rule(geometry: str, dim: int, order: int):
    """Rule on a reference domain; analog of `quadratureRule(geo, order)`
    (dune/pdelab/common/quadraturerules.hh:111)."""
    if geometry == "cube":
        return cube_rule(dim, order)
    if geometry == "simplex":
        return simplex_rule(dim, order)
    raise ValueError(f"unknown reference geometry {geometry!r}")
