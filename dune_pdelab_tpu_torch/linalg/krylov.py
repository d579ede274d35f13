"""Krylov solvers as host-driven PyTorch loops.

PyTorch port of dune_pdelab_tpu/linalg/krylov.py (reference:
dune/pdelab/backend/istl/seqistlsolverbackend.hh:112-1060 — Loop/CG/
BiCGStab/MINRES/GMRES/Richardson). A solver is a function

    solve(A, b, x0, M, ...) -> (x, SolverStats)

where A and M are closures (z -> A z, r -> M r). The reference runs each
loop inside one lax.while_loop; here Python drives it and reads the defect
once per iteration for the stop test (one host sync per iteration).

Convergence follows ISTL semantics: 2-norm of the defect, relative
reduction `tol` against the initial defect with absolute floor `atol`.
The stopping rules, guards and iteration counting are the reference's.
Complex systems work as in the reference: the dot product conjugates its
first argument (`torch.vdot`, as `jnp.vdot`), norms are sqrt(real(dot)),
and the floors the reference takes with `jnp.maximum` compare complex
values as JAX does (real part first, then imaginary). The dot product is
injectable (`dot=`), so a distributed layer can pass a global one.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import numpy as np
import torch


class SolverStats(NamedTuple):
    """Result bookkeeping (PDELab LinearSolverResult analog, reference:
    dune/pdelab/backend/solver.hh)."""
    iterations: int
    converged: Any      # 0-d bool tensor
    defect0: Any        # 0-d tensor
    defect: Any         # 0-d tensor

    @property
    def reduction(self):
        return self.defect / torch.clamp_min(torch.as_tensor(self.defect0), 1e-300)

    def conv_rate(self):
        return self.reduction ** (1.0 / max(int(self.iterations), 1))


def _default_dot(a, b):
    return torch.vdot(a, b)


def _norm(dot, a):
    return torch.sqrt(torch.real(dot(a, a)))


def _maximum(a, floor):
    """jnp.maximum(a, floor) of a 0-d tensor and a real floor: a complex a
    compares as in JAX, real part first, then imaginary part."""
    if not a.is_complex():
        return torch.clamp_min(a, floor)
    keep = (a.real > floor) | ((a.real == floor) & (a.imag > 0))
    return torch.where(keep, a, torch.full_like(a, floor))


def _identity(r):
    return r


def _start(A, b, x0, tol, atol, dot):
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - A(x)
    defect0 = _norm(dot, r)
    return x, r, defect0, torch.clamp_min(tol * defect0, atol)


def cg(A: Callable, b, x0=None, M: Callable = _identity, tol=1e-10, atol=0.0,
       maxiter=5000, dot=_default_dot):
    """Preconditioned conjugate gradients (ISTL CGSolver semantics)."""
    x, r, defect0, target = _start(A, b, x0, tol, atol, dot)
    z = M(r)
    rho = dot(r, z)
    p, it, defect = z, 0, defect0
    while it < maxiter and bool(defect > target):
        q = A(p)
        alpha = rho / dot(p, q)
        x = x + alpha * p
        r = r - alpha * q
        z = M(r)
        rho_new = dot(r, z)
        p = z + (rho_new / rho) * p
        rho = rho_new
        it += 1
        defect = _norm(dot, r)
    return x, SolverStats(it, defect <= target, defect0, defect)


def bicgstab(A: Callable, b, x0=None, M: Callable = _identity, tol=1e-10,
             atol=0.0, maxiter=5000, dot=_default_dot):
    """Preconditioned BiCGStab (ISTL BiCGSTABSolver semantics; one
    "iteration" = one full BiCGStab step = 2 operator applications)."""
    x, r, defect0, target = _start(A, b, x0, tol, atol, dot)
    rhat = r
    eps = torch.finfo(b.dtype).tiny * 1e4

    def guard(v):
        return torch.where(v.abs() < eps, eps, v)

    one = torch.ones((), dtype=b.dtype, device=b.device)
    p, v = torch.zeros_like(b), torch.zeros_like(b)
    rho = alpha = omega = one
    it, defect = 0, defect0
    while it < maxiter and bool(defect > target):
        rho_new = dot(rhat, r)
        beta = (rho_new / guard(rho)) * (alpha / guard(omega))
        p = r + beta * (p - omega * v)
        phat = M(p)
        v = A(phat)
        alpha = rho_new / dot(rhat, v)
        s = r - alpha * v
        shat = M(s)
        t = A(shat)
        omega = dot(t, s) / _maximum(dot(t, t), eps)
        x = x + alpha * phat + omega * shat
        r = s - omega * t
        rho = rho_new
        it += 1
        defect = _norm(dot, r)
    return x, SolverStats(it, defect <= target, defect0, defect)


def minres(A: Callable, b, x0=None, M: Callable = _identity, tol=1e-10,
           atol=0.0, maxiter=5000, dot=_default_dot):
    """Preconditioned MINRES for symmetric (indefinite) systems
    (ISTL MINRESSolver analog; M must be SPD). Convergence is monitored on
    the M-norm residual estimate |eta| (standard pMINRES recurrence)."""
    x, r1, defect0, target = _start(A, b, x0, tol, atol, dot)
    z1 = M(r1)
    gamma1 = torch.sqrt(_maximum(dot(r1, z1), 1e-300))
    one = torch.ones((), dtype=b.dtype, device=b.device)
    zero = torch.zeros((), dtype=b.dtype, device=b.device)
    r0, w0, w1 = torch.zeros_like(b), torch.zeros_like(b), torch.zeros_like(b)
    gamma0, eta = one, gamma1
    c0, c1, s0, s1 = one, one, zero, zero
    it, defect = 0, defect0
    while it < maxiter and bool(defect > target):
        z = z1 / gamma1
        Az = A(z)
        delta = dot(Az, z)
        r2 = Az - (delta / gamma1) * r1 - (gamma1 / gamma0) * r0
        z2 = M(r2)
        gamma2 = torch.sqrt(_maximum(dot(r2, z2), 1e-300))
        a0 = c1 * delta - c0 * s1 * gamma1
        a1 = torch.sqrt(a0**2 + gamma2**2)
        a2 = s1 * delta + c0 * c1 * gamma1
        a3 = s0 * gamma1
        c0, s0 = c1, s1
        c1 = a0 / a1
        s1 = gamma2 / a1
        w2 = (z - a3 * w0 - a2 * w1) / a1
        x = x + c1 * eta * w2
        eta = -s1 * eta
        r0, r1, z1, gamma0, gamma1 = r1, r2, z2, gamma1, gamma2
        w0, w1 = w1, w2
        it += 1
        defect = eta.abs()
    return x, SolverStats(it, defect <= target, defect0, defect)


def _host_maximum(a, floor):
    """_maximum of a numpy scalar and a floor of its type."""
    if np.iscomplexobj(a):
        keep = (a.real > floor.real) or (a.real == floor.real and a.imag > 0)
    else:
        keep = a > floor
    return a if keep else floor


def restarted_gmres(A: Callable, b, x0=None, M: Callable = _identity,
                    tol=1e-10, atol=0.0, maxiter=5000, restart=30,
                    dot=_default_dot):
    """Left-preconditioned restarted GMRES(m) with modified Gram-Schmidt
    (ISTL RestartedGMResSolver analog; note ISTL uses right preconditioning —
    convergence is measured here on the preconditioned residual).

    The Gram-Schmidt coefficients come to the host once per iteration (the
    stop test's sync), and the Givens rotations of the small Hessenberg
    system run there in numpy scalars of b's dtype, operation for operation
    as the reference's, instead of as O(j) tiny kernels per iteration. For
    real dtypes every operation is IEEE-rounded, as on the card. The
    upper-triangular solve runs on b's device."""
    x = torch.zeros_like(b) if x0 is None else x0
    m = restart
    defect0 = _norm(dot, M(b - A(x)))
    target = float(torch.clamp_min(tol * defect0, atol))
    tiny = 1e-300 if b.dtype == torch.float64 else 1e-30
    np_dtype = torch.empty((), dtype=b.dtype).numpy().dtype
    tiny_h = np_dtype.type(tiny)

    def arnoldi_cycle(x):
        r = M(b - A(x))
        beta = _norm(dot, r)
        V = [r / torch.clamp_min(beta, tiny)]
        H = np.zeros((m + 1, m), np_dtype)
        g = np.zeros(m + 1, np_dtype)
        g[0] = beta.item()
        cs = np.zeros(m, np_dtype)
        sn = np.zeros(m, np_dtype)
        j = 0
        while j < m and abs(g[j]) > target:
            w = M(A(V[j]))
            hs = []
            for i in range(j + 1):                    # modified Gram-Schmidt
                hi = dot(V[i], w)
                w = w - hi * V[i]
                hs.append(hi)
            hnext = _norm(dot, w)
            hs.append(hnext.to(b.dtype))
            V.append(w / torch.clamp_min(hnext, tiny))
            h = np.zeros(m + 1, np_dtype)
            h[:j + 2] = torch.stack(hs).cpu().numpy()
            for i in range(j):                        # earlier Givens rotations
                hi = cs[i] * h[i] + sn[i] * h[i + 1]
                h[i + 1] = -sn[i] * h[i] + cs[i] * h[i + 1]
                h[i] = hi
            denom = np.sqrt(h[j] * h[j] + h[j + 1] * h[j + 1])
            c = h[j] / _host_maximum(denom, tiny_h)
            s = h[j + 1] / _host_maximum(denom, tiny_h)
            h[j], h[j + 1] = denom, 0.0
            g[j + 1] = -s * g[j]
            g[j] = c * g[j]
            H[:, j] = h
            cs[j], sn[j] = c, s
            j += 1
        # only the j used columns enter the upper-triangular solve
        Hd = torch.from_numpy(H).to(b.device)
        gd = torch.from_numpy(g).to(b.device)
        y = torch.linalg.solve_triangular(Hd[:j, :j], gd[:j, None], upper=True)[:, 0]
        for i in range(j):
            x = x + y[i] * V[i]
        return x, abs(g[j]), j

    it, defect = 0, float(defect0)
    while it < maxiter and defect > target:
        x, defect, jstop = arnoldi_cycle(x)
        it += jstop
    defect = _norm(dot, M(b - A(x)))
    return x, SolverStats(it, defect <= target, defect0, defect)


def richardson_loop(A: Callable, b, x0=None, M: Callable = _identity,
                    tol=1e-10, atol=0.0, maxiter=5000, omega=1.0,
                    dot=_default_dot):
    """Preconditioned Richardson iteration (ISTL LoopSolver analog)."""
    x, r, defect0, target = _start(A, b, x0, tol, atol, dot)
    it, defect = 0, defect0
    while it < maxiter and bool(defect > target):
        x = x + omega * M(r)
        r = b - A(x)
        it += 1
        defect = _norm(dot, r)
    return x, SolverStats(it, defect <= target, defect0, defect)


SOLVERS = {
    "cg": cg,
    "bicgstab": bicgstab,
    "minres": minres,
    "gmres": restarted_gmres,
    "loop": richardson_loop,
}
