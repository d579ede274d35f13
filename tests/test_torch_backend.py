"""The port's assembled Jacobian, Jacobian diagonal and the backend paths
that use them, against the JAX package (fp64).

  * GridOperator.element_jacobians / jacobian / jacobian_diagonal: the same
    blocks, (row, col, value) triples and diagonal as the reference;
  * Jacobi on the general-jvp tier and the config1_poisson_2d_mf golden of
    tests/golden_parity.json (140 iterations, its L2 error), read from the
    file with test_parity.py's tolerance;
  * a callable preconditioner: LinearSolverBackend(solver="cg",
    precond=LatticeGMG(...)) takes as many iterations as the JAX backend on
    a 16^3 Q1 problem.
"""
import json
from pathlib import Path

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import dune_pdelab_tpu as jpt
import dune_pdelab_tpu_torch as tpt
from dune_pdelab_tpu.assembly.stencil import compile_stencil as j_compile
from dune_pdelab_tpu.linalg.gmg_lattice import LatticeGMG as JLatticeGMG
from dune_pdelab_tpu.ops import ConvectionDiffusionFEM as JFEM
from dune_pdelab_tpu.ops import ConvectionDiffusionProblem as JProblem
from dune_pdelab_tpu.solvers import LinearSolverBackend as JBackend
from dune_pdelab_tpu_torch.assembly.stencil import compile_stencil
from dune_pdelab_tpu_torch.linalg.gmg_lattice import LatticeGMG
from dune_pdelab_tpu_torch.models import ALL_CONFIGS
from dune_pdelab_tpu_torch.ops import ConvectionDiffusionFEM as TFEM
from dune_pdelab_tpu_torch.ops import ConvectionDiffusionProblem as TProblem
from dune_pdelab_tpu_torch.solvers import LinearSolverBackend
from dune_pdelab_tpu_torch.utils.common import set_default_device

pytestmark = pytest.mark.fast
torch.set_num_threads(1)
set_default_device("cpu")
F64 = torch.float64
PI = np.pi
GOLDEN = json.loads((Path(__file__).parent / "golden_parity.json").read_text())


class JVar(JProblem):
    def A(self, x):
        return 1.0 + 0.5 * jnp.sin(3 * x[..., 0]) * x[..., -1]

    def b(self, x):
        return 0.3 * jnp.ones_like(x)

    def c(self, x):
        return 0.7 + x[..., 0]


class TVar(TProblem):
    def A(self, x):
        return 1.0 + 0.5 * torch.sin(3 * x[..., 0]) * x[..., -1]

    def b(self, x):
        return 0.3 * torch.ones_like(x)

    def c(self, x):
        return 0.7 + x[..., 0]


class JUnit(JProblem):
    def f(self, x):
        return 1.0 + x[..., 0] * x[..., 1]


class TUnit(TProblem):
    def f(self, x):
        return 1.0 + x[..., 0] * x[..., 1]


def _gos(cells, k, JP=JVar, TP=TVar):
    out = []
    for pkg, P, FEM in ((jpt, JP, JFEM), (tpt, TP, TFEM)):
        mesh = pkg.StructuredMesh([0] * len(cells), [1] * len(cells), cells)
        V = pkg.FunctionSpace(mesh, pkg.QkFEM(k, len(cells)))
        out.append(pkg.GridOperator(V, FEM(P()), constraints=pkg.constraints(True, V),
                                    skip_boundary=True))
    return out


@pytest.mark.parametrize("cells,k", [((5, 4, 3), 1), ((4, 3), 2)])
def test_jacobian_and_diagonal_match_reference(cells, k):
    jgo, tgo = _gos(cells, k)
    n = tgo.space.ndofs
    x = np.random.default_rng(2).standard_normal(n)
    Je_j = np.asarray(jgo.element_jacobians(jnp.asarray(x)))
    Je_t = tgo.element_jacobians(torch.as_tensor(x)).numpy()
    assert np.abs(Je_t - Je_j).max() <= 1e-13 * np.abs(Je_j).max()
    A_j = jgo.jacobian(jnp.asarray(x))
    A_t = tgo.jacobian(torch.as_tensor(x))
    assert A_t.is_coalesced() and A_t.shape == (n, n)
    # the same sorted (row, col) pattern, explicit zeros included
    idx_j = np.asarray(A_j.indices)
    order = np.lexsort((idx_j[:, 1], idx_j[:, 0]))
    assert np.array_equal(A_t.indices().numpy().T, idx_j[order])
    data_j = np.asarray(A_j.data)[order]
    assert np.abs(A_t.values().numpy() - data_j).max() <= 1e-13 * np.abs(data_j).max()
    d_j = np.asarray(jgo.jacobian_diagonal(jnp.asarray(x)))
    d_t = tgo.jacobian_diagonal(torch.as_tensor(x)).numpy()
    assert np.abs(d_t - d_j).max() <= 1e-13 * np.abs(d_j).max()
    # J z through the assembled matrix equals the matrix-free apply
    z = torch.as_tensor(np.random.default_rng(3).standard_normal(n))
    y = tgo.jacobian_apply(torch.as_tensor(x), z)
    assert float((A_t @ z - y).abs().max()) <= 1e-12 * float(y.abs().max())


def test_config1_poisson_2d_mf_golden():
    """The port's models/configs.py config1_poisson_2d_mf: 64^2 Q1,
    matrix-free CG + Jacobi on the general-jvp tier (use_stencil=False)."""
    ref = GOLDEN["config1_poisson_2d_mf"]
    info = {}
    got = ALL_CONFIGS["config1"](info=info)
    assert "general-jvp" in info["ls"].report(info["go"])
    assert got["converged"] and got["ndofs"] == ref["ndofs"]
    assert got["iterations"] == ref["iterations"]
    assert got["l2_error"] == pytest.approx(ref["l2_error"], rel=1e-8, abs=1e-9)


def test_callable_preconditioner_lattice_gmg_matches_jax():
    """LinearSolverBackend(solver="cg", precond=LatticeGMG(...)): the
    reference's custom-preconditioner path (general-jvp A, M from the
    precond protocol) on a 16^3 Q1 problem."""
    jgo, tgo = _gos((16, 16, 16), 1, JUnit, TUnit)
    jgmg = JLatticeGMG(jgo.space, jgo.lop, fine_stencil=j_compile(jgo))
    tgmg = LatticeGMG(tgo.space, tgo.lop, fine_stencil=compile_stencil(tgo, dtype=F64))
    b_j = jgo.residual(jnp.zeros(jgo.space.ndofs))
    z_j, s_j = JBackend(solver="cg", precond=jgmg).solve(
        jgo, jnp.zeros(jgo.space.ndofs), b_j, 1e-10)
    ls = LinearSolverBackend(solver="cg", precond=tgmg)
    zero = tgo.space.zero(F64)
    z, s = ls.solve(tgo, zero, tgo.residual(zero), 1e-10)
    assert "custom preconditioner LatticeGMG" in ls.report(tgo)
    assert bool(s.converged) and s.iterations == int(s_j.iterations) <= 10
    z_j = np.asarray(z_j)
    assert np.linalg.norm(z.numpy() - z_j) <= 1e-8 * np.linalg.norm(z_j)
