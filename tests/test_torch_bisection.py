"""Parity of the port's newest-vertex bisection with the JAX package.

  * `submesh`, `oriented_for_bisection` and three cycles of
    `refine_bisection` on an L-shape (2D) and a Kuhn box (3D, Traxler's
    typed bisection) with random marks: cells, vertices, parent cells,
    tags, midpoint ids and edge endpoints EQUAL (the port vectorises the
    reference's per-element loops; the order is the reference's);
  * the P1 and P2 transfers of `adapt_local_simplex` to 1e-14;
  * config6_adaptive_lshape (models/configs.py:206-265) from the port, held
    to tests/golden_parity.json: DOFs per cycle equal, L2 errors to 1e-10
    relative, the final CG iteration count exact (33, the golden and the
    JAX package's count today);
  * simplex_mesh_from_numpy carries parent cells and tags.
"""
import json
import os

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import dune_pdelab_tpu as jpt
import dune_pdelab_tpu_torch as tpt
from dune_pdelab_tpu.adaptivity.local import adapt_local_simplex as j_adapt
from dune_pdelab_tpu.fe import PkFEM as JPk
from dune_pdelab_tpu.mesh import SimplexMesh as JSimplex
from dune_pdelab_tpu_torch.adaptivity import adapt_local_simplex
from dune_pdelab_tpu_torch.interop import simplex_mesh_from_numpy
from dune_pdelab_tpu_torch.mesh import SimplexMesh as TSimplex
from dune_pdelab_tpu_torch.utils.common import set_default_device

pytestmark = pytest.mark.fast
torch.set_num_threads(1)
set_default_device("cpu")
F64 = torch.float64
GOLDEN = json.load(open(os.path.join(os.path.dirname(__file__), "golden_parity.json")))


def _start(dim, n):
    jm = JSimplex.from_structured(jpt.StructuredMesh([-1] * dim, [1] * dim, (n,) * dim))
    tm = TSimplex.from_structured(tpt.StructuredMesh([-1] * dim, [1] * dim, (n,) * dim))
    if dim == 2:
        c = jm.element_centers()
        keep = ~((c[:, 0] > 0) & (c[:, 1] < 0))
        jm, tm = jm.submesh(keep), tm.submesh(keep)
        np.testing.assert_array_equal(tm.cells, jm.cells)
        np.testing.assert_array_equal(tm.boundary_vertex_mask(), jm.boundary_vertex_mask())
    return jm.oriented_for_bisection(), tm.oriented_for_bisection()


def _assert_mesh_equal(tm, jm):
    np.testing.assert_array_equal(tm.cells, jm.cells)
    np.testing.assert_array_equal(tm.vertices, jm.vertices)
    np.testing.assert_array_equal(tm.boundary_vertex_mask(), jm.boundary_vertex_mask())
    for name in ("parent_cells", "bisect_tag"):
        if hasattr(jm, name):
            np.testing.assert_array_equal(getattr(tm, name), getattr(jm, name))


@pytest.mark.parametrize("dim,n", [(2, 6), (3, 3)])
def test_bisection_arrays_equal(dim, n):
    jm, tm = _start(dim, n)
    _assert_mesh_equal(tm, jm)
    rng = np.random.default_rng(dim)
    for cycle in range(3):
        marks = rng.random(jm.nelements) < 0.25
        if cycle == 1:
            marks = np.nonzero(marks)[0]          # index marks as well as masks
        jm, jt = jm.refine_bisection(marks)
        tm, tt = tm.refine_bisection(marks)
        _assert_mesh_equal(tm, jm)
        assert tt[0] == jt[0]
        np.testing.assert_array_equal(tt[1], jt[1])
        np.testing.assert_array_equal(tt[2], jt[2])
    rt = simplex_mesh_from_numpy(jm.vertices, jm.cells, jm.boundary_vertex_mask(),
                                 parent_cells=jm.parent_cells,
                                 bisect_tag=getattr(jm, "bisect_tag", None))
    _assert_mesh_equal(rt, jm)


def test_3d_needs_tags():
    tm = TSimplex.from_structured(tpt.StructuredMesh([0] * 3, [1] * 3, (1, 1, 1)))
    with pytest.raises(ValueError, match="oriented_for_bisection"):
        tm.refine_bisection([0])


@pytest.mark.parametrize("dim,k", [(2, 1), (2, 2), (3, 1)])
def test_transfer_matches_jax(dim, k):
    jm, tm = _start(dim, 4 if dim == 2 else 2)
    jV = jpt.FunctionSpace(jm, JPk(k, dim))
    tV = tpt.FunctionSpace(tm, tpt.PkFEM(k, dim))
    x = np.random.default_rng(0).standard_normal(jV.ndofs)
    marks = np.arange(jm.nelements) % 3 == 0
    jV2, jx = j_adapt(jV, jnp.asarray(x), marks)
    tV2, tx = adapt_local_simplex(tV, torch.from_numpy(x), marks)
    assert tV2.ndofs == jV2.ndofs
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=0, atol=1e-14 * np.abs(x).max())


def test_config6_golden():
    """config6_adaptive_lshape from the port's models/configs.py: P1 on the
    L-shape of an 8^2 triangulated square, Doerfler 0.5 on the edge-jump
    indicator, four bisection cycles, Jacobi-CG to 1e-12 with the boundary
    kernels built (no skip_boundary)."""
    from dune_pdelab_tpu_torch.models import ALL_CONFIGS

    want = GOLDEN["config6_adaptive_lshape"]
    got = ALL_CONFIGS["config6"]()
    for cyc in range(4):
        assert got[f"ndofs_cycle{cyc}"] == want[f"ndofs_cycle{cyc}"]
        assert got[f"l2_cycle{cyc}"] == pytest.approx(want[f"l2_cycle{cyc}"], rel=1e-10)
    assert got["ndofs"] == want["ndofs"]
    assert got["l2_error"] == pytest.approx(want["l2_error"], rel=1e-10)
    assert got["iterations"] == want["iterations"]
