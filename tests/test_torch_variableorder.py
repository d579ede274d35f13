"""Variable-order (p-adaptive) DG via modal truncation constraints on the
port (constraints/variableorder.py), fp64.

The four tests of tests/test_variableorder.py run on the port at their
sizes: the mask's shape and the refusal of nodal bases, uniform truncation
against the plain lower-order space (1e-7, the reference's bound), mixed
orders (truncated modes exactly zero; the error between the uniform-order
errors) and the total-degree truncation of OPB and monomial bases. The
masks equal the JAX package's, and the mixed-order L2 error is within
1e-8 relative of the JAX package's live run.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

import dune_pdelab_tpu as jpt
import dune_pdelab_tpu_torch as tpt
from dune_pdelab_tpu.constraints import variableorder as jvo
from dune_pdelab_tpu.fe import LegendreDGFEM as JLegendre
from dune_pdelab_tpu.ops import ConvectionDiffusionProblem as JProblem
from dune_pdelab_tpu.ops.convectiondiffusiondg import ConvectionDiffusionDG as JDG
from dune_pdelab_tpu.ops.convectiondiffusiondg import DGMethod
from dune_pdelab_tpu.solvers import SEQ_BCGS_Jacobi as JBCGS
from dune_pdelab_tpu.space.functions import l2_difference as j_l2
from dune_pdelab_tpu_torch.constraints.variableorder import (
    p_adaptive_constraints, variable_order_mask,
)
from dune_pdelab_tpu_torch.fe import LegendreDGFEM, MonomialDGFEM, OPBFEM, QkDGFEM
from dune_pdelab_tpu_torch.ops import ConvectionDiffusionDG, ConvectionDiffusionProblem
from dune_pdelab_tpu_torch.solvers import SEQ_BCGS_Jacobi
from dune_pdelab_tpu_torch.space.functions import l2_difference
from dune_pdelab_tpu_torch.utils.common import set_default_device

pytestmark = pytest.mark.fast
torch.set_num_threads(1)
set_default_device("cpu")
F64 = torch.float64


def _exact(p):
    p = np.asarray(p)
    return np.sin(np.pi * p[:, 0]) * np.cos(2 * np.pi * p[:, 1]) + p[:, 0]


class SinCos(ConvectionDiffusionProblem):
    def f(self, x):
        return 5 * np.pi**2 * torch.sin(np.pi * x[..., 0]) * torch.cos(2 * np.pi * x[..., 1])

    def g(self, x):
        return torch.sin(np.pi * x[..., 0]) * torch.cos(2 * np.pi * x[..., 1]) + x[..., 0]


class JSinCos(JProblem):
    def f(self, x):
        return 5 * np.pi**2 * jnp.sin(np.pi * x[..., 0]) * jnp.cos(2 * np.pi * x[..., 1])

    def g(self, x):
        return jnp.sin(np.pi * x[..., 0]) * jnp.cos(2 * np.pi * x[..., 1]) + x[..., 0]


def _solve(V, p, cg_=None, penalty=2.0, quad_order=None):
    go = tpt.GridOperator(V, ConvectionDiffusionDG(p, method=DGMethod.SIPG,
                                                   penalty=penalty),
                          constraints=cg_, quad_order=quad_order)
    slp = tpt.StationaryLinearProblemSolver(
        go, SEQ_BCGS_Jacobi(maxiter=40000), reduction=1e-11)
    x = slp.apply(V.zero(dtype=F64))
    assert slp.result.converged
    return x


def _l2(V, x):
    return float(l2_difference(V, x, lambda p: torch.as_tensor(_exact(p.numpy()))))


def test_mask_shape_and_rejects_nodal():
    mesh = tpt.StructuredMesh([0, 0], [1, 1], (4, 4))
    V = tpt.FunctionSpace(mesh, LegendreDGFEM(2, 2))
    deg = np.full(mesh.nelements, 1)
    mask = variable_order_mask(V, deg)
    # order-1 truncation of a 3x3 tensor basis keeps 4 of 9 modes
    assert mask.sum() == mesh.nelements * 5
    jV = jpt.FunctionSpace(jpt.StructuredMesh([0, 0], [1, 1], (4, 4)), JLegendre(2, 2))
    assert np.array_equal(mask, jvo.variable_order_mask(jV, deg))
    Vn = tpt.FunctionSpace(mesh, QkDGFEM(2, 2))
    with pytest.raises(ValueError):
        variable_order_mask(Vn, deg)


def test_uniform_truncation_matches_lower_order_space():
    """degrees == 1 everywhere in a kmax=2 space: the Galerkin solution of
    the plain order-1 Legendre space (same penalty gamma and quadrature)."""
    p = SinCos()
    mesh = tpt.StructuredMesh([0, 0], [1, 1], (12, 12))
    V2 = tpt.FunctionSpace(mesh, LegendreDGFEM(2, 2))
    cg_ = p_adaptive_constraints(V2, np.full(mesh.nelements, 1))
    x_trunc = _solve(V2, p, cg_, penalty=2.0, quad_order=8)
    V1 = tpt.FunctionSpace(mesh, LegendreDGFEM(1, 2))
    x1 = _solve(V1, p, penalty=6.0, quad_order=8)
    keep = np.nonzero(V2.fem._mi.max(axis=1) <= 1)[0]
    xt, xl = x_trunc.numpy(), x1.numpy()
    d = np.abs(xt[V2.element_dofs[:, keep]] - xl[V1.element_dofs]).max()
    assert d < 1e-7, d


def test_mixed_orders():
    """k=2 on the left half, k=1 on the right: high modes exactly zero on
    low-order elements; error between the uniform-order errors; the error
    against the JAX package's live run."""
    p = SinCos()
    mesh = tpt.StructuredMesh([0, 0], [1, 1], (12, 12))
    V = tpt.FunctionSpace(mesh, LegendreDGFEM(2, 2))
    deg = np.where(mesh.element_centers()[:, 0] < 0.5, 2, 1)
    cg_ = p_adaptive_constraints(V, deg)
    x = _solve(V, p, cg_)
    mask = variable_order_mask(V, deg)
    assert float(x[torch.as_tensor(np.nonzero(mask)[0])].abs().max()) == 0.0
    err = _l2(V, x)
    err2 = _l2(V, _solve(V, p))                            # uniform k=2
    V1 = tpt.FunctionSpace(mesh, LegendreDGFEM(1, 2))
    err1 = _l2(V1, _solve(V1, p))
    assert err2 < err < err1, (err2, err, err1)

    jmesh = jpt.StructuredMesh([0, 0], [1, 1], (12, 12))
    jV = jpt.FunctionSpace(jmesh, JLegendre(2, 2))
    jgo = jpt.GridOperator(jV, JDG(JSinCos(), method=DGMethod.SIPG, penalty=2.0),
                           constraints=jvo.p_adaptive_constraints(jV, deg))
    jslp = jpt.StationaryLinearProblemSolver(jgo, JBCGS(maxiter=40000),
                                             reduction=1e-11, verbose=0)
    jerr = float(j_l2(jV, jslp.apply(jV.zero()), _exact))
    assert abs(err - jerr) <= 1e-8 * jerr, (err, jerr)


def test_variable_order_opb_and_monomial():
    """Total-degree truncation to k=1 keeps exactly the P1 modes
    (variableopbfem.hh / variablemonomfem.hh analogs)."""
    mesh = tpt.StructuredMesh([0, 0], [1, 1], (4, 4))
    for FEM in (OPBFEM, MonomialDGFEM):
        V = tpt.FunctionSpace(mesh, FEM(2, 2))
        mask = variable_order_mask(V, np.full(mesh.nelements, 1), truncation="total")
        nb = V.fem.nbasis
        kept = nb - int(mask.reshape(mesh.nelements, nb)[0].sum())
        assert kept == 3, (FEM.__name__, kept)   # P1: {1, x, y}
