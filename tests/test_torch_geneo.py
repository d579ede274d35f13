"""Parity of the port's GenEO preconditioners with the JAX package (fp64).

On the layered high-contrast problem of tests/test_solver_utils.py (2D Q1,
12^2 cells, boxes (2, 2)):

  * lattice_box_subdomains: the same index sets and partition of unity;
  * the dense GenEOPreconditioner and the GenEOLatticePreconditioner
    (batched lattice ILU(0) local solves, ARPACK set-up) apply to 1e-8
    relative of the JAX ones, from the same ELL values;
  * geneo_preconditioner_for (dense and method='ilu') gives the JAX CG
    iteration counts (+-1) and solution; on a simplex mesh it takes the
    sparse-Jacobian fallback (1D slabs) and matches the JAX one too.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

import dune_pdelab_tpu as jpt
import dune_pdelab_tpu.linalg.geneo as jgeneo
import dune_pdelab_tpu_torch as tpt
import dune_pdelab_tpu_torch.linalg.geneo as tgeneo
from dune_pdelab_tpu.assembly.ell import assemble_ell as j_assemble_ell
from dune_pdelab_tpu.assembly.ell import ell_to_csr as j_ell_to_csr
from dune_pdelab_tpu.fe import PkFEM as JPk
from dune_pdelab_tpu.linalg.krylov import cg as jcg
from dune_pdelab_tpu.mesh import SimplexMesh as JSimplex
from dune_pdelab_tpu.ops import ConvectionDiffusionFEM as JFEM
from dune_pdelab_tpu.ops import ConvectionDiffusionProblem as JProblem
from dune_pdelab_tpu_torch.fe import PkFEM as TPk
from dune_pdelab_tpu_torch.interop import ell_from_numpy
from dune_pdelab_tpu_torch.linalg import cg
from dune_pdelab_tpu_torch.mesh import SimplexMesh as TSimplex
from dune_pdelab_tpu_torch.ops import ConvectionDiffusionFEM as TFEM
from dune_pdelab_tpu_torch.ops import ConvectionDiffusionProblem as TProblem
from dune_pdelab_tpu_torch.utils.common import set_default_device

pytestmark = pytest.mark.fast
torch.set_num_threads(1)
set_default_device("cpu")
F64 = torch.float64


class JHC(JProblem):
    def A(self, x):
        return jnp.where(jnp.floor(x[..., 1] * 8) % 2 == 0, 1.0, 1e4)

    def f(self, x):
        return jnp.ones(x.shape[:-1])


class THC(TProblem):
    def A(self, x):
        return torch.where(torch.floor(x[..., 1] * 8) % 2 == 0, 1.0, 1e4)

    def f(self, x):
        return torch.ones(x.shape[:-1], dtype=x.dtype)


def _ops(simplex=False, n=12):
    if simplex:
        jm = JSimplex.from_structured(jpt.StructuredMesh([0, 0], [1, 1], (n, n)))
        tm = TSimplex.from_structured(tpt.StructuredMesh([0, 0], [1, 1], (n, n)))
        jV, tV = jpt.FunctionSpace(jm, JPk(1, 2)), tpt.FunctionSpace(tm, TPk(1, 2))
    else:
        jm = jpt.StructuredMesh([0, 0], [1, 1], (n, n))
        tm = tpt.StructuredMesh([0, 0], [1, 1], (n, n))
        jV, tV = jpt.FunctionSpace(jm, jpt.QkFEM(1, 2)), tpt.FunctionSpace(tm, tpt.QkFEM(1, 2))
    jgo = jpt.GridOperator(jV, JFEM(JHC()), constraints=jpt.constraints(True, jV),
                           skip_boundary=simplex)
    tgo = tpt.GridOperator(tV, TFEM(THC()), constraints=tpt.constraints(True, tV),
                           skip_boundary=simplex)
    return jgo, tgo


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.abs(got - want).max() / np.abs(want).max()


def _rand(n, k=3, seed=2):
    return np.random.default_rng(seed).standard_normal((k, n))


@pytest.fixture(scope="module")
def lattice():
    jgo, tgo = _ops()
    jell = j_assemble_ell(jgo, jnp.zeros(jgo.space.ndofs))
    tell = ell_from_numpy(jell.dims, jell.k, jell.offsets, np.asarray(jell.values),
                          None if jell.mask is None else np.asarray(jell.mask), device="cpu")
    return jgo, tgo, jell, tell


@pytest.mark.parametrize("boxes,overlap", [((2, 2), 2), ((3, 2), 1), ((4, 1), 3)])
def test_box_subdomains(boxes, overlap):
    ji, jc = jgeneo.lattice_box_subdomains((13, 13), boxes, overlap)
    ti, tc = tgeneo.lattice_box_subdomains((13, 13), boxes, overlap)
    assert len(ti) == len(ji) == int(np.prod(boxes))
    for a, b, c, d in zip(ti, ji, tc, jc):
        assert np.array_equal(a, b) and np.array_equal(c, d)


def test_dense_variant_matches_jax(lattice):
    jgo, _, jell, _ = lattice
    A = j_ell_to_csr(jell)
    subs = jgeneo.lattice_box_subdomains(jell.grid_shape, (2, 2), 1)
    jM = jgeneo.GenEOPreconditioner(A, nev=3, subdomains=subs)
    tM = tgeneo.GenEOPreconditioner(A, nev=3, subdomains=subs, device="cpu")
    assert tM.ncoarse == jM.ncoarse == 12 and tM.m == jM.m
    for r in _rand(A.shape[0]):
        want = np.asarray(jM(jnp.asarray(r)))
        assert _rel(tM(torch.from_numpy(r)).numpy(), want) <= 1e-8
    # 1D slabs of a dense operator (tests/test_solver_utils.py:41-71)
    N = 512
    D = (np.diag(2 * np.ones(N)) - np.diag(np.ones(N - 1), 1) - np.diag(np.ones(N - 1), -1))
    jM1 = jgeneo.GenEOPreconditioner(D, nsub=8, overlap=8, nev=2)
    tM1 = tgeneo.GenEOPreconditioner(D, nsub=8, overlap=8, nev=2, device="cpu")
    r = _rand(N, 1)[0]
    assert _rel(tM1(torch.from_numpy(r)).numpy(), np.asarray(jM1(jnp.asarray(r)))) <= 1e-8


def test_lattice_variant_matches_jax(lattice):
    _, _, jell, tell = lattice
    jM = jgeneo.GenEOLatticePreconditioner(jell, (2, 2), overlap=1, nev=3)
    tM = tgeneo.GenEOLatticePreconditioner(tell, (2, 2), overlap=1, nev=3)
    assert tM.ncoarse == jM.ncoarse and tM.m == jM.m
    assert set(tM.setup_times) == {"extract", "eigsh", "ilu", "coarse"}
    assert not hasattr(tM, "_loc")          # no dense local operator
    for r in _rand(tell.values[0].numel()):
        want = np.asarray(jM(jnp.asarray(r)))
        assert _rel(tM(torch.from_numpy(r)).numpy(), want) <= 1e-8


@pytest.mark.parametrize("method", ["dense", "ilu"])
def test_preconditioner_for_matches_jax(method, lattice):
    jgo, tgo, _, _ = lattice
    jM = jgeneo.geneo_preconditioner_for(jgo, boxes=(2, 2), nev=3, method=method)
    tM = tgeneo.geneo_preconditioner_for(tgo, boxes=(2, 2), nev=3, method=method)
    want = {"dense": tgeneo.GenEOPreconditioner, "ilu": tgeneo.GenEOLatticePreconditioner}
    assert isinstance(tM, want[method])
    jb = jgo.residual(jgo.space.zero())
    jx, js = jcg(lambda z: jgo.jacobian_apply(jgo.space.zero(), z), jb, M=jM, tol=1e-8)
    x0 = tgo.space.zero(F64)
    tx, ts = cg(lambda z: tgo.jacobian_apply(x0, z), tgo.residual(x0), M=tM, tol=1e-8)
    assert bool(ts.converged) and abs(ts.iterations - int(js.iterations)) <= 1
    assert _rel(tx.numpy(), np.asarray(jx)) <= 1e-6


def test_simplex_fallback_matches_jax():
    jgo, tgo = _ops(simplex=True, n=8)
    jM = jgeneo.geneo_preconditioner_for(jgo, nsub=3, overlap=6, nev=2)
    tM = tgeneo.geneo_preconditioner_for(tgo, nsub=3, overlap=6, nev=2)
    assert isinstance(tM, tgeneo.GenEOPreconditioner) and tM.ncoarse == jM.ncoarse
    for r in _rand(tgo.space.ndofs, 2):
        want = np.asarray(jM(jnp.asarray(r)))
        assert _rel(tM(torch.from_numpy(r)).numpy(), want) <= 1e-8
    with pytest.raises(ValueError, match="divisible"):
        tgeneo.geneo_preconditioner_for(tgo, nsub=4)
