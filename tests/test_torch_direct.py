"""Parity of the port's sparse direct backends with the JAX package (fp64).

  * SparseLU on the assembled 2D Q1 12^2 Poisson operator, and SEQ_SuperLU /
    SEQ_UMFPack through StationaryLinearProblemSolver, match the JAX
    solution to 1e-10 (and report a machine-precision defect);
  * SparseLU takes a torch sparse COO matrix, a dense tensor, a scipy
    matrix or a numpy array, and a batched right-hand side;
  * DirectSolverBackend inside Newton (tests/test_direct.py:66-97): the
    same Newton count as the JAX package, with a fresh factorisation per
    step and with one kept factorisation (reuse).
"""
import numpy as np
import pytest
import jax.numpy as jnp
import scipy.sparse as sp
import torch

import dune_pdelab_tpu as jpt
import dune_pdelab_tpu_torch as tpt
from dune_pdelab_tpu.ops import ConvectionDiffusionFEM as JFEM
from dune_pdelab_tpu.ops import ConvectionDiffusionProblem as JProblem
from dune_pdelab_tpu.ops.base import LocalOperator as JLocal
from dune_pdelab_tpu.solvers import SEQ_SuperLU as J_SuperLU
from dune_pdelab_tpu_torch.ops import ConvectionDiffusionFEM as TFEM
from dune_pdelab_tpu_torch.ops import ConvectionDiffusionProblem as TProblem
from dune_pdelab_tpu_torch.ops.base import LocalOperator as TLocal
from dune_pdelab_tpu_torch.solvers import (
    DirectSolverBackend, NewtonMethod, SEQ_SuperLU, SEQ_UMFPack, SparseLU,
    StationaryLinearProblemSolver,
)
from dune_pdelab_tpu_torch.utils.common import set_default_device

pytestmark = pytest.mark.fast
torch.set_num_threads(1)
set_default_device("cpu")
F64 = torch.float64


class JPoisson(JProblem):
    def f(self, x):
        return 1.0 + x[..., 0] * jnp.sin(3 * x[..., 1])


class TPoisson(TProblem):
    def f(self, x):
        return 1.0 + x[..., 0] * torch.sin(3 * x[..., 1])


def _poisson(n=12, k=1):
    jV = jpt.FunctionSpace(jpt.StructuredMesh([0, 0], [1, 1], (n, n)), jpt.QkFEM(k, 2))
    tV = tpt.FunctionSpace(tpt.StructuredMesh([0, 0], [1, 1], (n, n)), tpt.QkFEM(k, 2))
    jgo = jpt.GridOperator(jV, JFEM(JPoisson()), constraints=jpt.constraints(True, jV))
    tgo = tpt.GridOperator(tV, TFEM(TPoisson()), constraints=tpt.constraints(True, tV))
    return jgo, tgo


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("make", [SEQ_SuperLU, SEQ_UMFPack])
def test_direct_backend_matches_jax(make):
    jgo, tgo = _poisson()
    jx = jpt.StationaryLinearProblemSolver(jgo, J_SuperLU(), reduction=1e-12).apply(
        jgo.space.zero())
    backend = make()
    tx = StationaryLinearProblemSolver(tgo, backend, reduction=1e-12).apply(
        tgo.space.zero(F64))
    assert tx.dtype == F64 and _rel(tx.numpy(), np.asarray(jx)) <= 1e-10
    st = backend.stats_history[-1]
    assert bool(st.converged) and st.iterations == 1
    assert float(st.defect) < 1e-10 * max(float(st.defect0), 1.0)
    assert isinstance(backend, DirectSolverBackend)


def test_sparse_lu_inputs():
    jgo, tgo = _poisson()
    x0 = torch.zeros(tgo.space.ndofs, dtype=F64)
    b = tgo.residual(x0)
    jb = jgo.residual(jnp.zeros(jgo.space.ndofs))
    J = jgo.jacobian(jnp.zeros(jgo.space.ndofs))
    ind = np.asarray(J.indices)
    want = sp.linalg.spsolve(sp.csc_matrix((np.asarray(J.data), (ind[:, 0], ind[:, 1])),
                                           shape=J.shape), np.asarray(jb))
    coo = tgo.jacobian(x0)
    for mat in (coo, coo.to_dense(), tgo.jacobian_csr(x0), coo.to_dense().numpy()):
        lu = SparseLU(mat)
        z = lu(b)
        assert isinstance(z, torch.Tensor) and z.dtype == F64
        assert _rel(z.numpy(), want) <= 1e-10
        assert lu.residual_norm(z, b) <= 1e-12 * float(torch.linalg.norm(b))
    B = torch.stack([b, 2 * b], dim=1)
    Z = SparseLU(coo).solve(B)
    assert Z.shape == B.shape and _rel(Z[:, 1].numpy(), 2 * want) <= 1e-10
    z32 = SparseLU(coo).solve(b.float())
    assert z32.dtype == torch.float32 and _rel(z32.double().numpy(), want) <= 1e-6


class JNonlin(JLocal):
    def alpha_volume(self, ctx, u):
        tab = ctx.tab
        gu = self.gradient_at_qp(tab, u)
        uq = self.value_at_qp(tab, u)
        return (self.accumulate_gradient(tab, ctx.factor, gu)
                + self.accumulate_value(tab, ctx.factor, uq ** 3 - 1.0))


class TNonlin(TLocal):
    def alpha_volume(self, ctx, u):
        tab = ctx.tab
        gu = self.gradient_at_qp(tab, u)
        uq = self.value_at_qp(tab, u)
        return (self.accumulate_gradient(tab, ctx.factor, gu)
                + self.accumulate_value(tab, ctx.factor, uq ** 3 - 1.0))


@pytest.mark.parametrize("threshold", [0.0, 1.0])
def test_direct_newton_reuse_matches_jax(threshold):
    """Newton with the direct backend, reassembled at every step (0.0) or
    with one kept factorisation (1.0, the chord method)."""
    kw = dict(reduction=1e-10, reassemble_threshold=threshold)
    if threshold:
        kw.update(max_iterations=60, line_search="none")
    jV = jpt.FunctionSpace(jpt.StructuredMesh([0, 0], [1, 1], (10, 10)), jpt.QkFEM(1, 2))
    tV = tpt.FunctionSpace(tpt.StructuredMesh([0, 0], [1, 1], (10, 10)), tpt.QkFEM(1, 2))
    jgo = jpt.GridOperator(jV, JNonlin(), constraints=jpt.constraints(True, jV))
    tgo = tpt.GridOperator(tV, TNonlin(), constraints=tpt.constraints(True, tV))
    jn = jpt.NewtonMethod(jgo, J_SuperLU(), **kw)
    jx = jn.apply(jV.zero())
    backend = SEQ_SuperLU()
    tn = NewtonMethod(tgo, backend, **kw)
    tx = tn.apply(tV.zero(F64))
    assert tn.result.converged
    assert tn.result.iterations == jn.result.iterations
    assert _rel(tx.numpy(), np.asarray(jx)) <= 1e-10
    assert len(backend._cache) == 1
    r = tgo.residual(tx)
    assert float(torch.where(tgo.cg.mask, 0.0, r).abs().max()) < 1e-9
