"""The ported slice end to end against the JAX package (fp64, 15^3 cells).

Both chains of the 3D Poisson Q1 main path:
  * the bench chain: constraints -> GridOperator(skip_boundary=True) ->
    RHS (plain and slabbed) -> compile_stencil -> fused CG (the JAX package
    runs plain CG on the stencil in fp64, where its Pallas kernels decline);
  * the README chain: StationaryLinearProblemSolver + SEQ_CG_Jacobi.
They must match: b to 1e-12, equal iteration counts, solution to 1e-10.
Also checks that the port never imports jax or the JAX package.
"""
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import dune_pdelab_tpu as jpt
import dune_pdelab_tpu_torch as tpt
from dune_pdelab_tpu.assembly.stencil import compile_stencil as j_compile
from dune_pdelab_tpu.linalg import cg as j_cg
from dune_pdelab_tpu.ops import ConvectionDiffusionFEM as JFEM
from dune_pdelab_tpu.ops import ConvectionDiffusionProblem as JProblem
from dune_pdelab_tpu.solvers import SEQ_CG_Jacobi as J_SEQ_CG_Jacobi
from dune_pdelab_tpu_torch.assembly.fused_cg import make_fused_cg, qualifies
from dune_pdelab_tpu_torch.assembly.slabbed import residual_slabbed
from dune_pdelab_tpu_torch.assembly.stencil import compile_stencil
from dune_pdelab_tpu_torch.ops import ConvectionDiffusionFEM as TFEM
from dune_pdelab_tpu_torch.ops import ConvectionDiffusionProblem as TProblem
from dune_pdelab_tpu_torch.solvers import (
    SEQ_CG_AMG, SEQ_CG_Jacobi, SEQ_CG_SSOR, LinearSolverBackend)
from dune_pdelab_tpu_torch.utils.common import set_default_device

pytestmark = pytest.mark.fast
torch.set_num_threads(1)
set_default_device("cpu")

ROOT = Path(__file__).resolve().parents[1]
CELLS = (15, 15, 15)
F64 = torch.float64


class JP(JProblem):
    def f(self, x):
        return jnp.sin(3.0 * x[..., 0]) * x[..., 1] + 1.0 + x[..., 2] ** 2


class TP(TProblem):
    def f(self, x):
        return torch.sin(3.0 * x[..., 0]) * x[..., 1] + 1.0 + x[..., 2] ** 2


def _chain(pkg, Problem, FEM):
    mesh = pkg.StructuredMesh([0, 0, 0], [1, 1, 1], CELLS)
    V = pkg.FunctionSpace(mesh, pkg.QkFEM(1, 3))
    prob = Problem()
    cgm = pkg.constraints(prob.dirichlet_bctype(), V)
    go = pkg.GridOperator(V, FEM(prob), constraints=cgm, skip_boundary=True)
    return V, cgm, go


@pytest.fixture(scope="module")
def chains():
    return _chain(jpt, JP, JFEM), _chain(tpt, TP, TFEM)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def test_bench_chain_matches_jax(chains):
    (jV, _, jgo), (tV, tcg, tgo) = chains
    b_j = np.asarray(jgo.residual(jnp.zeros(jV.ndofs)))
    b = tgo.residual(tV.zero(F64))
    b_slab = residual_slabbed(tV, TFEM(TP()), tcg, tV.zero(F64), nslabs=4)
    for got in (b, b_slab):
        assert np.abs(got.numpy() - b_j).max() <= 1e-12 * np.abs(b_j).max()
    jst = j_compile(jgo)
    st = compile_stencil(tgo, dtype=F64)
    assert qualifies(st)
    z_j, s_j = j_cg(jst, jnp.asarray(b_j), tol=1e-10, maxiter=1000)
    z, s = make_fused_cg(st, maxiter=1000, tol=1e-10)(b_slab)
    assert bool(s.converged) and s.iterations == int(s_j.iterations)
    assert _rel(z.numpy(), z_j) <= 1e-10


def test_readme_chain_matches_jax(chains):
    (jV, _, jgo), (tV, _, tgo) = chains
    j_solver = jpt.StationaryLinearProblemSolver(jgo, J_SEQ_CG_Jacobi(),
                                                 reduction=1e-10, verbose=0)
    x_j = np.asarray(j_solver.apply(jV.zero()))
    ls = SEQ_CG_Jacobi()
    solver = tpt.StationaryLinearProblemSolver(tgo, ls, reduction=1e-10, verbose=0)
    x = solver.apply(tV.zero(F64))
    assert solver.result.converged
    assert solver.result.linear_solver_iterations == j_solver.result.linear_solver_iterations
    assert _rel(x.numpy(), x_j) <= 1e-10
    assert "compiled stencil StencilOperator [stencil27 plain torch" in ls.report(tgo)


def test_backend_general_jvp_tier(chains):
    """Without the stencil tier, CG + Richardson runs on the jvp apply and
    gives the same solution; Jacobi there takes go.jacobian_diagonal, equal
    to the stencil's diagonal, so it takes the same iterations; a callable
    preconditioner runs on this tier too."""
    _, (tV, _, tgo) = chains
    b = tgo.residual(tV.zero(F64))
    ref, s_ref = SEQ_CG_Jacobi().solve(tgo, tV.zero(F64), b, 1e-10)
    plain = LinearSolverBackend(precond="none", use_stencil=False)
    z, s = plain.solve(tgo, tV.zero(F64), b, 1e-12)
    assert "general-jvp" in plain.report()
    assert _rel(z.numpy(), ref.numpy()) <= 1e-8
    jac = LinearSolverBackend(use_stencil=False)
    z, s = jac.solve(tgo, tV.zero(F64), b, 1e-10)
    assert "general-jvp" in jac.report() and s.iterations == s_ref.iterations
    assert _rel(z.numpy(), ref.numpy()) <= 1e-10
    diag = tgo.jacobian_diagonal(tV.zero(F64))
    custom = LinearSolverBackend(precond=lambda go, x, t: (lambda r: r / diag))
    z, s = custom.solve(tgo, tV.zero(F64), b, 1e-10)
    assert "custom preconditioner" in custom.report()
    assert s.iterations == s_ref.iterations and _rel(z.numpy(), ref.numpy()) <= 1e-10
    # the block and polynomial preconditioners are ported (their parity
    # with the JAX package: tests/test_torch_dg.py); SSOR and AMG are not
    for p in ("chebyshev", "block_jacobi", "block_gs"):
        assert LinearSolverBackend(precond=p).precond == p
    with pytest.raises(ValueError, match="slice 10"):
        LinearSolverBackend(precond="ssor")
    for make, slice_ in [(SEQ_CG_AMG, "slice 10"), (SEQ_CG_SSOR, "slice 10")]:
        with pytest.raises(NotImplementedError, match=slice_):
            make()


_FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|dune_pdelab_tpu)(\.|\s|$)", re.M)


def test_port_never_imports_jax():
    files = sorted((ROOT / "dune_pdelab_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    bad = [str(f) for f in files if _FORBIDDEN.search(f.read_text())]
    assert not bad, bad
    code = ("import sys, pkgutil, importlib, dune_pdelab_tpu_torch as p\n"
            "for m in pkgutil.walk_packages(p.__path__, 'dune_pdelab_tpu_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'dune_pdelab_tpu.'))"
            " or m == 'dune_pdelab_tpu']\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)
