"""Linear elasticity of the port against the JAX package (fp64).

  * LinearElasticity with a body force and traction faces: residual and
    J.v at a random x on VectorSpace(Q2) 2D and VectorSpace(Q1) 3D,
    against the JAX package's (1e-12 relative);
  * the three tests of tests/test_elasticity.py on the port at their
    sizes: the patch test, Q2 manufactured convergence (order > 2.7; the
    port's errors within 1e-8 relative of the JAX package's live run) and
    the traction boundary condition.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

import dune_pdelab_tpu as jpt
import dune_pdelab_tpu_torch as tpt
from dune_pdelab_tpu.fe import QkFEM as JQk
from dune_pdelab_tpu.ops.elasticity import LinearElasticity as JLE
from dune_pdelab_tpu.ops.elasticity import LinearElasticityParameters as JLEP
from dune_pdelab_tpu.solvers import SEQ_CG_Jacobi as JCG
from dune_pdelab_tpu.space.functions import l2_difference as j_l2
from dune_pdelab_tpu.space.space import VectorSpace as JVectorSpace
from dune_pdelab_tpu_torch.fe import QkFEM
from dune_pdelab_tpu_torch.ops import LinearElasticity, LinearElasticityParameters
from dune_pdelab_tpu_torch.solvers import SEQ_CG_Jacobi, StationaryLinearProblemSolver
from dune_pdelab_tpu_torch.space.functions import l2_difference
from dune_pdelab_tpu_torch.space.space import VectorSpace
from dune_pdelab_tpu_torch.utils.common import set_default_device

pytestmark = pytest.mark.fast
torch.set_num_threads(1)
set_default_device("cpu")
F64 = torch.float64
REL = 1e-12


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _xp(x):
    return torch if isinstance(x, torch.Tensor) else jnp


class _Loads:
    """Body force and traction on x > 1/2 (numpy, jax and torch alike)."""

    def f(self, x):
        xp = _xp(x)
        return xp.stack([xp.sin(2 * x[..., c]) + 0.1 * c for c in range(x.shape[-1])], -1)

    def is_neumann(self, x):
        return x[..., 0] > 0.5

    def traction(self, x):
        xp = _xp(x)
        return xp.stack([0.2 + x[..., 1]] + [0.1 * x[..., 0]] * (x.shape[-1] - 1), -1)


class JLoads(_Loads, JLEP):
    pass


class TLoads(_Loads, LinearElasticityParameters):
    pass


@pytest.mark.parametrize("dim,k,cells", [(2, 2, (4, 3)), (3, 1, (3, 2, 4))])
def test_residual_and_jv_match_jax(dim, k, cells):
    lo, hi = [0.0] * dim, [1.0] * dim
    jW = JVectorSpace(jpt.StructuredMesh(lo, hi, cells), JQk(k, dim))
    tW = VectorSpace(tpt.StructuredMesh(lo, hi, cells), QkFEM(k, dim))
    jprm, tprm = JLoads(lam=1.3, mu=0.7), TLoads(lam=1.3, mu=0.7)
    jcg = jpt.constraints((jprm.dirichlet_bctype(),) * dim, jW)
    tcg = tpt.constraints((tprm.dirichlet_bctype(),) * dim, tW)
    assert np.array_equal(tcg.mask_np, np.asarray(jcg.mask_np))
    jgo = jpt.GridOperator(jW, JLE(jprm), constraints=jcg)
    tgo = tpt.GridOperator(tW, LinearElasticity(tprm), constraints=tcg)
    rng = np.random.default_rng(3)
    x, z = rng.standard_normal((2, tW.ndofs))
    xt, zt = torch.as_tensor(x), torch.as_tensor(z)
    assert _rel(tgo.residual(xt), jgo.residual(jnp.asarray(x))) <= REL
    assert _rel(tgo.jacobian_apply(xt, zt),
                jgo.jacobian_apply(jnp.asarray(x), jnp.asarray(z))) <= REL


def test_patch_linear_displacement():
    """A linear displacement (constant strain) solves the equations with
    f = 0 and lies in the Q1 space: reproduced exactly."""
    mesh = tpt.StructuredMesh([0, 0], [1, 1], (4, 4))
    W = VectorSpace(mesh, QkFEM(1, 2))
    A = np.array([[0.02, 0.01], [0.00, -0.03]])

    class P(LinearElasticityParameters):
        def g(self, x):
            return torch.einsum("cd,...d->...c", torch.as_tensor(A, dtype=x.dtype), x)

    cg_ = tpt.constraints((True, True), W)
    go = tpt.GridOperator(W, LinearElasticity(P(lam=2.0, mu=1.0)), constraints=cg_)
    x0 = W.interpolate((lambda p: p.numpy() @ A.T[:, 0], lambda p: p.numpy() @ A.T[:, 1]),
                       dtype=F64)
    x = StationaryLinearProblemSolver(go, SEQ_CG_Jacobi(), reduction=1e-12).apply(x0)
    for c in range(2):
        err = float(l2_difference(W.children[c], W.restrict(x, c),
                                  lambda p, c=c: p @ torch.as_tensor(A.T[:, c])))
        assert err < 1e-10, (c, err)


def _u1(p):
    p = np.asarray(p)
    return np.sin(np.pi * p[:, 0]) * np.sin(np.pi * p[:, 1])


LAM, MU = 1.0, 1.0


class _Manufactured:
    """u = (sin(pi x) sin(pi y), 0)."""

    def g(self, x):
        xp = _xp(x)
        return xp.stack([xp.sin(np.pi * x[..., 0]) * xp.sin(np.pi * x[..., 1]),
                         xp.zeros_like(x[..., 0])], -1)

    def f(self, x):
        xp = _xp(x)
        px, py = np.pi * x[..., 0], np.pi * x[..., 1]
        f1 = np.pi**2 * ((LAM + 2 * MU) + MU) * xp.sin(px) * xp.sin(py)
        f2 = -(np.pi**2) * (LAM + MU) * xp.cos(px) * xp.cos(py)
        return xp.stack([f1, f2], -1)


class JManufactured(_Manufactured, JLEP):
    pass


class TManufactured(_Manufactured, LinearElasticityParameters):
    pass


def test_manufactured_convergence():
    errs, jerrs = [], []
    for n in (4, 8, 16):
        mesh = tpt.StructuredMesh([0, 0], [1, 1], (n, n))
        W = VectorSpace(mesh, QkFEM(2, 2))
        cg_ = tpt.constraints((True, True), W)
        go = tpt.GridOperator(W, LinearElasticity(TManufactured(lam=LAM, mu=MU)),
                              constraints=cg_)
        x0 = tpt.interpolate_dirichlet(
            lambda p: np.stack([_u1(p), np.zeros(len(p))], -1), W, cg_, W.zero(dtype=F64))
        x = StationaryLinearProblemSolver(go, SEQ_CG_Jacobi(), reduction=1e-12).apply(x0)
        errs.append(float(l2_difference(W.children[0], W.restrict(x, 0),
                                        lambda p: torch.as_tensor(_u1(p)))))
        jmesh = jpt.StructuredMesh([0, 0], [1, 1], (n, n))
        jW = JVectorSpace(jmesh, JQk(2, 2))
        jcg = jpt.constraints((True, True), jW)
        jgo = jpt.GridOperator(jW, JLE(JManufactured(lam=LAM, mu=MU)), constraints=jcg)
        jx0 = jpt.interpolate_dirichlet(
            lambda p: np.stack([_u1(p), np.zeros(len(p))], -1), jW, jcg, jW.zero())
        jx = jpt.StationaryLinearProblemSolver(jgo, JCG(), reduction=1e-12,
                                               verbose=0).apply(jx0)
        jerrs.append(float(j_l2(jW.children[0], jW.restrict(jx, 0), _u1)))
    orders = [np.log2(errs[i] / errs[i + 1]) for i in range(len(errs) - 1)]
    assert orders[-1] > 2.7, (errs, orders)
    assert np.allclose(errs, jerrs, rtol=1e-8), (errs, jerrs)


def test_traction_bc():
    """Uniaxial tension: traction (T, 0) at x = 1, x = 0 fixed; E = 1,
    nu = 0 gives u = (T x, 0) exactly."""
    T = 0.1
    mesh = tpt.StructuredMesh([0, 0], [1, 1], (8, 8))
    W = VectorSpace(mesh, QkFEM(1, 2))

    class P(LinearElasticityParameters):
        def is_neumann(self, x):
            return x[..., 0] > 1e-12   # all but the x = 0 face

        def traction(self, x):
            tx = torch.where(x[..., 0] > 1 - 1e-12, T, 0.0)
            return torch.stack([tx, torch.zeros_like(tx)], -1)

    prm = P(lam=0.0, mu=0.5)
    bct = prm.dirichlet_bctype()
    cg_ = tpt.constraints((bct, bct), W)
    go = tpt.GridOperator(W, LinearElasticity(prm), constraints=cg_)
    x = StationaryLinearProblemSolver(go, SEQ_CG_Jacobi(), reduction=1e-12).apply(
        W.zero(dtype=F64))
    err = float(l2_difference(W.children[0], W.restrict(x, 0), lambda p: T * p[:, 0]))
    assert err < 1e-9, err
