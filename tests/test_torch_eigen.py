"""Parity of the port's LOBPCG with the JAX package (fp64).

The generalized problem of tests/test_eigen.py: the 2D Q1 Dirichlet
Laplacian (stiffness A, constrained rows scaled by 1e6) against the mass
matrix B, Jacobi preconditioned, on 10^2 cells. Handed the JAX package's
start block (its jax.random draw), the port's lobpcg takes the JAX
iteration count and finds the JAX eigenvalues to 1e-8 relative, with
B-orthonormal eigenvectors (1e-7) that span the same eigenspaces; with its
own torch.Generator start block it finds the dense scipy eigenvalues. The
tolerance is 1e-6: the 1e6-scaled constrained rows hold both packages'
residuals near 1e-7.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import scipy.linalg
import torch

import dune_pdelab_tpu as jpt
import dune_pdelab_tpu_torch as tpt
from dune_pdelab_tpu.linalg.eigen import lobpcg as j_lobpcg
from dune_pdelab_tpu.ops import ConvectionDiffusionFEM as JFEM
from dune_pdelab_tpu.ops import ConvectionDiffusionProblem as JProblem
from dune_pdelab_tpu.ops.l2 import L2 as JL2
from dune_pdelab_tpu_torch.linalg.eigen import EigenResult, lobpcg
from dune_pdelab_tpu_torch.ops import ConvectionDiffusionFEM as TFEM
from dune_pdelab_tpu_torch.ops import ConvectionDiffusionProblem as TProblem
from dune_pdelab_tpu_torch.ops.l2 import L2 as TL2
from dune_pdelab_tpu_torch.utils.common import set_default_device

pytestmark = pytest.mark.fast
torch.set_num_threads(1)
set_default_device("cpu")
F64 = torch.float64
BIG = 1e6
TOL = 1e-6


def _jax_ops(n):
    V = jpt.FunctionSpace(jpt.StructuredMesh([0, 0], [1, 1], (n, n)), jpt.QkFEM(1, 2))
    cons = jpt.constraints(True, V)
    goA = jpt.GridOperator(V, JFEM(JProblem()), constraints=cons)
    goB = jpt.GridOperator(V, JL2(), constraints=cons)
    z, m = V.zero(), cons.mask

    def A(v):
        return jnp.where(m, BIG * v, goA.jacobian_apply(z, v))

    def B(v):
        return jnp.where(m, v, goB.jacobian_apply(z, v))

    d = jnp.where(m, BIG, goA.jacobian_diagonal(z))
    return V, A, B, (lambda r: r / d)


def _port_ops(n):
    V = tpt.FunctionSpace(tpt.StructuredMesh([0, 0], [1, 1], (n, n)), tpt.QkFEM(1, 2))
    cons = tpt.constraints(True, V)
    goA = tpt.GridOperator(V, TFEM(TProblem()), constraints=cons)
    goB = tpt.GridOperator(V, TL2(), constraints=cons)
    z, m = V.zero(F64), cons.mask

    def A(v):
        return torch.where(m, BIG * v, goA.jacobian_apply(z, v))

    def B(v):
        return torch.where(m, v, goB.jacobian_apply(z, v))

    d = torch.where(m, BIG, goA.jacobian_diagonal(z))
    return V, A, B, (lambda r: r / d)


@pytest.fixture(scope="module")
def problem():
    n = 10
    jV, jA, jB, jM = _jax_ops(n)
    X0 = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (jV.ndofs, 4), jnp.float64))
    jres = j_lobpcg(jA, k=4, X0=jnp.asarray(X0), B=jB, M=jM, tol=TOL, maxiter=400)
    return X0, jres, _port_ops(n)


def test_lobpcg_with_jax_start_block(problem):
    X0, jres, (V, A, B, M) = problem
    res = lobpcg(A, k=4, X0=X0, B=B, M=M, tol=TOL, maxiter=400)
    assert isinstance(res, EigenResult) and res.iterations == jres.iterations < 400
    jw = np.asarray(jres.eigenvalues)
    assert np.all(np.abs(res.eigenvalues.numpy() - jw) / jw <= 1e-8)
    assert np.all(res.residual_norms.numpy() < TOL)
    X = res.eigenvectors
    G = X.T @ torch.func.vmap(B, in_dims=1, out_dims=1)(X)
    assert float((G - torch.eye(4, dtype=F64)).abs().max()) < 1e-7
    # the same eigenspaces (vectors up to sign and the degenerate pair's
    # rotation): the B-projection of the JAX vectors onto the port's is
    # orthogonal
    Xj = torch.from_numpy(np.asarray(jres.eigenvectors))
    C = (X.T @ torch.func.vmap(B, in_dims=1, out_dims=1)(Xj)).numpy()
    assert np.abs(C.T @ C - np.eye(4)).max() < 1e-6


def test_lobpcg_own_start_block(problem):
    _, jres, (V, A, B, M) = problem
    n = V.ndofs
    I = torch.eye(n, dtype=F64)
    Ad = torch.stack([A(I[:, j]) for j in range(n)], dim=1).numpy()
    Bd = torch.stack([B(I[:, j]) for j in range(n)], dim=1).numpy()
    w = scipy.linalg.eigh(Ad, Bd, eigvals_only=True)
    res = lobpcg(A, k=4, n=n, B=B, M=M, tol=TOL, maxiter=400, dtype=F64,
                 generator=torch.Generator().manual_seed(5))
    assert res.iterations < 400
    assert np.all(np.abs(res.eigenvalues.numpy() - w[:4]) / w[:4] <= 1e-8)
    again = lobpcg(A, k=4, n=n, B=B, M=M, tol=TOL, maxiter=400, dtype=F64, seed=5)
    assert torch.equal(again.eigenvalues, res.eigenvalues)
    # the continuous spectrum pi^2 {2, 5, 5, 8} within the O(h^2) error of 10^2
    lam = res.eigenvalues.numpy() / np.pi**2
    assert np.all(np.abs(lam - [2.0, 5.0, 5.0, 8.0]) / [2.0, 5.0, 5.0, 8.0] < 0.1)
