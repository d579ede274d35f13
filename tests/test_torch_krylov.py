"""Parity of the port's Krylov solvers with dune_pdelab_tpu/linalg/krylov.py.

Every solver of SOLVERS (cg, bicgstab, minres, gmres, loop) on the same
dense operators, made from numpy seeds, with the same preconditioner: the
same iteration count, convergence flag and defects, and solutions equal to
1e-10 relative (fp64). GMRES runs with a restart shorter than its iteration
count, so the restart path is covered.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from dune_pdelab_tpu.linalg import krylov as jk
from dune_pdelab_tpu_torch.linalg import krylov as tk
from dune_pdelab_tpu_torch.utils.common import set_default_device

pytestmark = pytest.mark.fast
torch.set_num_threads(1)
set_default_device("cpu")
N = 200


def _matrix(kind, rng):
    Q, _ = np.linalg.qr(rng.standard_normal((N, N)))
    if kind == "spd":
        return Q @ np.diag(np.linspace(1.0, 20.0, N)) @ Q.T
    if kind == "indefinite":
        eig = np.concatenate([-np.linspace(1.0, 4.0, N // 3),
                              np.linspace(1.0, 20.0, N - N // 3)])
        return Q @ np.diag(eig) @ Q.T
    if kind == "nonsymmetric":
        S = rng.standard_normal((N, N))
        return Q @ np.diag(np.linspace(1.0, 20.0, N)) @ Q.T + 0.2 * (S - S.T)
    # diagonally dominant: Jacobi-Richardson converges
    B = rng.uniform(-1.0, 1.0, (N, N))
    return B + np.diag(np.abs(B).sum(axis=1) * 1.5 + 1.0)


CASES = [("cg", "spd", {}), ("bicgstab", "nonsymmetric", {}),
         ("minres", "indefinite", {}), ("minres", "spd", {}),
         ("gmres", "nonsymmetric", {"restart": 10}), ("gmres", "spd", {}),
         ("loop", "dominant", {}), ("loop", "dominant", {"omega": 0.8})]


@pytest.mark.parametrize("name,kind,kw", CASES)
@pytest.mark.parametrize("precond", ["none", "jacobi"])
def test_solver_matches_jax(name, kind, kw, precond):
    rng = np.random.default_rng(11)
    A = _matrix(kind, rng)
    b = rng.standard_normal(N)
    x0 = 0.1 * rng.standard_normal(N)
    dinv = 1.0 / np.abs(np.diag(A)) if precond == "jacobi" else np.ones(N)
    if name == "loop" and precond == "none":
        dinv = np.full(N, 1.0 / np.abs(np.diag(A)).max())   # damped Richardson
    A_j, d_j = jnp.asarray(A), jnp.asarray(dinv)
    A_t, d_t = torch.as_tensor(A), torch.as_tensor(dinv)
    x_j, s_j = jk.SOLVERS[name](lambda z: A_j @ z, jnp.asarray(b), x0=jnp.asarray(x0),
                                M=lambda r: d_j * r, tol=1e-10, maxiter=400, **kw)
    x_t, s_t = tk.SOLVERS[name](lambda z: A_t @ z, torch.as_tensor(b),
                                x0=torch.as_tensor(x0), M=lambda r: d_t * r, tol=1e-10,
                                maxiter=400, **kw)
    assert s_t.iterations == int(s_j.iterations) > 3
    assert bool(s_t.converged) == bool(s_j.converged) is True
    assert float(s_t.defect0) == pytest.approx(float(s_j.defect0), rel=1e-12)
    # the last defect is ~1e-10 of the first: roundoff of the recurrences
    # shows in its leading digits, so it is held only to 2%
    assert float(s_t.defect) == pytest.approx(float(s_j.defect), rel=2e-2)
    x_j = np.asarray(x_j)
    assert np.linalg.norm(x_t.numpy() - x_j) <= 1e-10 * np.linalg.norm(x_j)


def test_maxiter_and_atol():
    rng = np.random.default_rng(3)
    A = torch.as_tensor(_matrix("spd", rng))
    b = torch.as_tensor(rng.standard_normal(N))
    for name, fn in tk.SOLVERS.items():
        if name == "loop":
            continue
        _, s = fn(lambda z: A @ z, b, tol=1e-14, maxiter=3)
        assert s.iterations >= 3 and not bool(s.converged)
        _, s = fn(lambda z: A @ z, b, tol=0.0, atol=1e30)
        assert s.iterations == 0 and bool(s.converged)


@pytest.mark.parametrize("name", ["cg", "bicgstab", "minres", "gmres"])
def test_solver_stats_reduction_and_conv_rate(name):
    """SolverStats.reduction and conv_rate() (reference linalg/krylov.py
    SolverStats), as tests/test_krylov.py test_solver_stats_fields holds
    them, and equal to the JAX package's on the same solve."""
    rng = np.random.default_rng(1)
    A = _matrix("spd", rng)
    b = np.ones(N)
    x_j, s_j = jk.SOLVERS[name](lambda z: jnp.asarray(A) @ z, jnp.asarray(b), tol=1e-10)
    At = torch.as_tensor(A)
    _, s_t = tk.SOLVERS[name](lambda z: At @ z, torch.as_tensor(b), tol=1e-10)
    assert float(s_t.reduction) <= 1e-10
    assert 0 < float(s_t.conv_rate()) < 1
    assert s_t.iterations == int(s_j.iterations)
    assert float(s_t.reduction) == pytest.approx(float(s_j.reduction), rel=2e-2)
    assert float(s_t.conv_rate()) == pytest.approx(float(s_j.conv_rate()), rel=1e-3)
