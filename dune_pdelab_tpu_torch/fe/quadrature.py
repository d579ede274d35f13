"""Quadrature rules on reference cubes.

PyTorch port of dune_pdelab_tpu/fe/quadrature.py (cube rules only; the
simplex rules wait for ROADMAP slice 11). Rules are float64 numpy arrays
computed once at setup, exactly as in the reference.
Reference domain: cube = [0,1]^d.
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


def cube_rule(dim: int, order: int):
    """Tensor-product Gauss rule on [0,1]^dim. Returns (points (nqp,dim), weights (nqp,))."""
    if dim == 0:
        return np.zeros((1, 0)), np.ones((1,))
    x, w = gauss_legendre(order)
    pts = np.array(list(itertools.product(x, repeat=dim)))[:, ::-1]  # dim 0 fastest
    wts = np.array([np.prod(c) for c in itertools.product(w, repeat=dim)])
    return np.ascontiguousarray(pts), wts


def quadrature_rule(geometry: str, dim: int, order: int):
    """Rule on a reference domain; analog of `quadratureRule(geo, order)`
    (dune/pdelab/common/quadraturerules.hh:111)."""
    if geometry == "cube":
        return cube_rule(dim, order)
    if geometry == "simplex":
        raise NotImplementedError(
            "simplex quadrature is not ported yet (ROADMAP slice 11)")
    raise ValueError(f"unknown reference geometry {geometry!r}")
