"""LOBPCG for (generalized) symmetric eigenproblems, on the device.

PyTorch port of dune_pdelab_tpu/linalg/eigen.py (the reference reaches
eigenproblems through ARPACK, dune/pdelab/backend/istl/geneo/
arpackpp_geneo.hh, a host shift-invert workflow). LOBPCG is matrix-free (A
and B are operator callables: jvp operators, compiled stencils), block
structured (tall-skinny (n, m) products) and preconditioned (any of the
port's preconditioners serves as M).

Solves A x = lambda B x for the `k` smallest eigenpairs, A and B symmetric
(B positive definite; B=None means the standard problem). The [X, W, P]
trial block is B-orthonormalised softly through an eigendecomposition with
a rank cutoff (the textbook Cholesky variant breaks down near convergence).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch
from torch.func import vmap

from dune_pdelab_tpu_torch.utils.common import default_float, resolve_device


class EigenResult(NamedTuple):
    eigenvalues: torch.Tensor     # (k,)
    eigenvectors: torch.Tensor    # (n, k), B-orthonormal
    iterations: int
    residual_norms: torch.Tensor  # (k,)


def _block_apply(op, X):
    """Apply an (n,) -> (n,) operator to every column of (n, m): one
    torch.func.vmap call (the reference's jax.vmap)."""
    return vmap(op, in_dims=1, out_dims=1)(X)


def lobpcg(A: Callable, k: int, n: int = None, X0=None, B: Callable = None,
           M: Callable = None, tol: float = 1e-8, maxiter: int = 200,
           seed: int = 0, dtype=None, device=None, generator=None):
    """Locally optimal block preconditioned conjugate gradient.

    A, B, M: callables on (n,) vectors (vmapped over blocks). Returns the k
    smallest eigenpairs of A x = lambda B x. The start block is X0 (n, k)
    (e.g. the reference's jax.random draw, as numpy or a tensor), else a
    standard normal (n, k) draw from `generator` (default: a
    torch.Generator seeded with `seed`) in `dtype` (default float) on
    `device` (default device).
    """
    if X0 is None:
        if n is None:
            raise ValueError("pass X0 or n")
        if generator is None:
            generator = torch.Generator().manual_seed(seed)
        X0 = torch.randn((n, k), generator=generator, dtype=torch.float64)
        X = X0.to(dtype=dtype or default_float(), device=resolve_device(device))
    elif isinstance(X0, torch.Tensor):
        X = X0.to(dtype=dtype or X0.dtype, device=device or X0.device)
    else:
        X = torch.as_tensor(np.array(X0), dtype=dtype, device=resolve_device(device))
    n, k = X.shape
    eps = torch.finfo(X.dtype).eps
    Bop = (lambda v: v) if B is None else B

    def rayleigh_ritz(S):
        """B-orthonormalise S softly, then Ritz-project A; the k lowest Ritz
        pairs (values, primal coefficients)."""
        G = S.T @ _block_apply(Bop, S)
        G = 0.5 * (G + G.T)
        d, Q = torch.linalg.eigh(G)
        keep = d > torch.max(d) * eps * G.shape[0] * 10
        # soft inverse square root (columns below the cutoff are zeroed)
        inv = torch.where(keep, 1.0 / torch.sqrt(torch.where(keep, d, 1.0)), 0.0)
        T = Q * inv[None, :]
        H = T.T @ (S.T @ _block_apply(A, S)) @ T
        H = 0.5 * (H + H.T)
        w, V = torch.linalg.eigh(H)
        # zeroed (rank-deficient) directions get Ritz value ~0 from H's null
        # block; push them past the spectrum so the k smallest are genuine
        bad = ~(torch.abs(T).sum(dim=0) > 0)
        w = torch.where(bad, torch.inf, w)
        order = torch.argsort(w)[:k]
        return w[order], T @ V[:, order]

    theta, Y = rayleigh_ritz(X)
    X = X @ Y
    P = torch.zeros_like(X)
    res = None
    it_done = 0
    for it in range(maxiter):
        R = _block_apply(A, X) - _block_apply(Bop, X) * theta[None, :]
        res = torch.linalg.norm(R, dim=0) / torch.clamp_min(torch.abs(theta), 1.0)
        it_done = it
        if bool(torch.all(res < tol)):
            break
        W = _block_apply(M, R) if M is not None else R
        S = torch.cat([X, W, P], dim=1) if it > 0 else torch.cat([X, W], dim=1)
        theta, Y = rayleigh_ritz(S)
        # P = the W/P contribution of the new block (classic LOBPCG)
        Yp = Y.clone()
        Yp[:k, :] = 0.0
        P = S @ Yp
        X = S @ Y
    return EigenResult(theta, X, it_done + 1, res)
