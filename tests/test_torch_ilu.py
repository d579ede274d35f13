"""Parity of the port's lattice ILU(0)/ILU(n) with dune_pdelab_tpu/linalg/ilu.py.

  * `_flat_shift` and `_fill_levels` (the symbolic level-of-fill) equal the
    reference's;
  * EllILU0 at levels 0 and 1 on the same assembled ELL matrix (carried
    across with interop.ell_from_numpy): the factors and the apply to 1e-12
    relative (fp64);
  * the ILU backends through LinearSolverBackend: the same iterations as the
    JAX package;
  * the config9_assembled_ilu golden of tests/golden_parity.json: 14
    iterations and the L2 error within 1e-6 relative.
"""
import json
import math
from pathlib import Path

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import dune_pdelab_tpu as jpt
import dune_pdelab_tpu_torch as tpt
from dune_pdelab_tpu.assembly.ell import assemble_ell as j_assemble
from dune_pdelab_tpu.linalg import ilu as jilu
from dune_pdelab_tpu.ops import ConvectionDiffusionFEM as JFEM
from dune_pdelab_tpu.ops import ConvectionDiffusionProblem as JProblem
from dune_pdelab_tpu.solvers import SEQ_BCGS_ILU0 as J_SEQ_BCGS_ILU0
from dune_pdelab_tpu.solvers import SEQ_CG_ILUn as J_SEQ_CG_ILUn
from dune_pdelab_tpu_torch.assembly.ell import assemble_ell, lattice_offsets
from dune_pdelab_tpu_torch.interop import ell_from_numpy, vector_from_numpy
from dune_pdelab_tpu_torch.linalg import ilu as tilu
from dune_pdelab_tpu_torch.ops import ConvectionDiffusionFEM as TFEM
from dune_pdelab_tpu_torch.ops import ConvectionDiffusionProblem as TProblem
from dune_pdelab_tpu_torch.solvers import SEQ_BCGS_ILU0, SEQ_CG_ILUn
from dune_pdelab_tpu_torch.utils.common import set_default_device

pytestmark = pytest.mark.fast
torch.set_num_threads(1)
set_default_device("cpu")
F64 = torch.float64
PI = math.pi
GOLDEN = json.loads((Path(__file__).parent / "golden_parity.json").read_text())


class JConv(JProblem):
    """Variable diffusion + convection + reaction (nonsymmetric)."""

    def A(self, x):
        return 1.0 + 0.5 * jnp.sin(3 * x[..., 0]) * x[..., 1]

    def b(self, x):
        v = [0.5 + x[..., 1], -0.3 * x[..., 0]]
        return jnp.stack(v + [0.1 * x[..., 2]] if x.shape[-1] == 3 else v, axis=-1)

    def c(self, x):
        return 0.7 + x[..., 0]

    def f(self, x):
        return 1.0 + x[..., 0]


class TConv(TProblem):
    def A(self, x):
        return 1.0 + 0.5 * torch.sin(3 * x[..., 0]) * x[..., 1]

    def b(self, x):
        v = [0.5 + x[..., 1], -0.3 * x[..., 0]]
        return torch.stack(v + [0.1 * x[..., 2]] if x.shape[-1] == 3 else v, dim=-1)

    def c(self, x):
        return 0.7 + x[..., 0]

    def f(self, x):
        return 1.0 + x[..., 0]


class JSym(JConv):
    def b(self, x):
        return jnp.zeros_like(x)


class TSym(TConv):
    def b(self, x):
        return torch.zeros_like(x)


def _pair(cells, k, JP=JConv, TP=TConv):
    out = []
    for pkg, P, FEM in ((jpt, JP, JFEM), (tpt, TP, TFEM)):
        dim = len(cells)
        V = pkg.FunctionSpace(pkg.StructuredMesh([0] * dim, [1] * dim, cells),
                              pkg.QkFEM(k, dim))
        out.append(pkg.GridOperator(V, FEM(P()), constraints=pkg.constraints(True, V),
                                    skip_boundary=True))
    return out


@pytest.mark.parametrize("dim,k", [(2, 1), (3, 1), (2, 2)])
def test_fill_levels_and_flat_shift(dim, k):
    offs = lattice_offsets(k, dim)
    for level in range(3):
        assert tilu._fill_levels(offs, level) == jilu._fill_levels(offs, level)
    dims = tuple(range(5, 5 + dim))
    for o in tilu._fill_levels(offs, 2):
        assert tilu._flat_shift(o, dims) == jilu._flat_shift(o, dims)


@pytest.mark.parametrize("cells,k,level", [((7, 6, 5), 1, 0), ((4, 4, 3), 1, 1),
                                           ((9, 7), 1, 1), ((5, 4), 2, 0)])
def test_factors_and_apply_match_jax(cells, k, level):
    jgo, tgo = _pair(cells, k)
    jm = j_assemble(jgo)
    sweeps, tri = 4 + 2 * level, 3 + level
    jp = jilu.EllILU0(jm, sweeps=sweeps, tri_iters=tri, level=level)
    tm = ell_from_numpy(jm.dims, jm.k, jm.offsets, np.asarray(jm.values),
                        np.asarray(jm.mask))
    tp = tilu.EllILU0(tm, sweeps=sweeps, tri_iters=tri, level=level)
    assert (tp.diag_t, tp.lower, tp.upper, tp.pairs) == (jp.diag_t, jp.lower, jp.upper,
                                                         jp.pairs)
    want = np.asarray(jp.vals)
    assert np.abs(tp.vals.numpy() - want).max() <= 1e-12 * np.abs(want).max()
    r = np.random.default_rng(8).standard_normal(tgo.space.ndofs)
    want = np.asarray(jp(jnp.asarray(r)))
    got = tp(vector_from_numpy(r)).numpy()
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
    # the port's own assembly gives the same preconditioner
    own = tilu.ilu0_preconditioner(tgo, tgo.space.zero(F64), sweeps=sweeps,
                                   tri_iters=tri, level=level)
    assert np.abs(own(vector_from_numpy(r)).numpy() - want).max() <= 1e-12 * np.abs(want).max()


@pytest.mark.parametrize("backend", ["bcgs_ilu0", "cg_ilu1"])
def test_ilu_backends_match_jax(backend):
    if backend == "bcgs_ilu0":
        jgo, tgo = _pair((10, 9), 1)
        jls, ls = J_SEQ_BCGS_ILU0(), SEQ_BCGS_ILU0()
    else:
        jgo, tgo = _pair((9, 8), 1, JSym, TSym)
        jls, ls = J_SEQ_CG_ILUn(level=1), SEQ_CG_ILUn(level=1)
    x0 = jnp.zeros(jgo.space.ndofs)
    z_j, s_j = jls.solve(jgo, x0, jgo.residual(x0), 1e-10)
    x = tgo.space.zero(F64)
    z, s = ls.solve(tgo, x, tgo.residual(x), 1e-10)
    assert "custom preconditioner" in ls.report(tgo)
    assert bool(s.converged) and s.iterations == int(s_j.iterations)
    z_j = np.asarray(z_j)
    assert np.linalg.norm(z.numpy() - z_j) <= 1e-9 * np.linalg.norm(z_j)


def test_config9_assembled_ilu_golden():
    """The port's config9: 12^3 Q1 cells, SEQ_CG_ILU0(use_stencil=False)
    through the stationary solver: the callable ILU runs on the general-jvp tier, its ELL feeds only
    the factorization (solvers/linear.py:302-312 in the reference)."""
    from dune_pdelab_tpu_torch.models import ALL_CONFIGS

    ref = GOLDEN["config9_assembled_ilu"]
    info = {}
    got = ALL_CONFIGS["config9"](info=info)
    go, V = info["go"], info["space"]
    assert "general-jvp (matrix-free) + custom preconditioner" in info["ls"].report(go)
    assert got["converged"] and got["ndofs"] == ref["ndofs"]
    assert got["iterations"] == ref["iterations"]
    assert abs(got["l2_error"] - ref["l2_error"]) <= 1e-6 * ref["l2_error"]
    # the ELL the ILU factors is the one assemble_ell gives
    assert assemble_ell(go, V.zero(F64)).values.shape == (27, 13, 13, 13)
