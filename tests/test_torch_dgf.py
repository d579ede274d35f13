"""The port's DGF reader (io/dgf.py) against the JAX package's, on DGF
files the tests write into tmp_path with the blocks of the reference's
test grids (dune/pdelab/test/grids/*.dgf; tests/test_dgf.py):

  * Interval blocks in 2D and 3D, with and without an empty Simplex block
    (then triangulated), comments and a Boundarydomain default: the same
    mesh type, cells, bounds, vertices and boundary id;
  * Vertex + Simplex blocks (a re-entrant corner L-shape in 2D with
    firstindex 1 and cells of both orientations; Kuhn tetrahedra in 3D):
    vertices, oriented cells and boundary vertex masks equal;
  * a P1 Poisson solve with the r^(2/3) corner solution on the L-shape read
    in both packages: the same Jacobi-CG iterations and solutions within
    1e-10 of their largest entry.
"""
import numpy as np
import pytest
import torch

import dune_pdelab_tpu as jpt
import dune_pdelab_tpu_torch as tpt
from dune_pdelab_tpu.fe import PkFEM as JPk
from dune_pdelab_tpu.io import read_dgf as j_read_dgf
from dune_pdelab_tpu.ops import ConvectionDiffusionFEM as JFEM
from dune_pdelab_tpu.ops import ConvectionDiffusionProblem as JProblem
from dune_pdelab_tpu.solvers import SEQ_CG_Jacobi as J_CG_Jacobi
from dune_pdelab_tpu_torch.io import read_dgf
from dune_pdelab_tpu_torch.mesh import SimplexMesh as TSimplex
from dune_pdelab_tpu_torch.mesh import StructuredMesh as TStructured
from dune_pdelab_tpu_torch.ops import ConvectionDiffusionFEM as TFEM
from dune_pdelab_tpu_torch.ops import ConvectionDiffusionProblem as TProblem
from dune_pdelab_tpu_torch.utils.common import set_default_device

pytestmark = pytest.mark.fast
torch.set_num_threads(1)
set_default_device("cpu")
F64 = torch.float64


def _same(tm, jm):
    assert type(tm).__name__ == type(jm).__name__
    assert tm.dim == jm.dim and tm.nelements == jm.nelements
    np.testing.assert_array_equal(tm.vertex_coords(), jm.vertex_coords())
    np.testing.assert_array_equal(tm.element_vertex_indices(), jm.element_vertex_indices())
    if hasattr(jm, "boundary_vertex_mask"):
        np.testing.assert_array_equal(tm.boundary_vertex_mask(), jm.boundary_vertex_mask())
    assert tm.boundary_domain_default == jm.boundary_domain_default


@pytest.mark.parametrize("text", [
    "DGF\nInterval\n0 0\n2 1\n8 4\n#\n",
    "DGF\nInterval\n0 0\n2 1\n8 4\n#\nSimplex\n#\n",
    "DGF % a box\n% lower, upper, cells\nINTERVAL\n0 0 0   % origin\n1 2 3\n2 3 4\n#\n"
    "Boundarydomain\ndefault 3\n#\n",
    "DGF\nInterval\n0 0 0\n1 1 1\n2 2 2\n#\nsimplex\n#\n",
], ids=["2d", "2d-simplex", "3d-comments-boundary", "3d-simplex"])
def test_interval_blocks(tmp_path, text):
    path = tmp_path / "box.dgf"
    path.write_text(text)
    tm, jm = read_dgf(str(path)), j_read_dgf(str(path))
    _same(tm, jm)
    if isinstance(tm, TStructured):
        assert tm.cells == tuple(jm.cells)
        np.testing.assert_array_equal(tm.upper, jm.upper)
    else:
        assert isinstance(tm, TSimplex)


def _lshape_dgf(path):
    """The re-entrant corner L-shape ([-1, 1]^2 without the lower-right
    quadrant, 4^2 triangulated) as Vertex + Simplex blocks, firstindex 1,
    every third cell listed with reversed orientation."""
    sq = tpt.SimplexMesh.from_structured(tpt.StructuredMesh([-1, -1], [1, 1], (4, 4)))
    c = sq.element_centers()
    m = sq.submesh(~((c[:, 0] > 0) & (c[:, 1] < 0)))
    lines = ["DGF", "% re-entrant corner", "Vertex", "firstindex 1"]
    lines += [f"{float(x)!r} {float(y)!r}" for x, y in m.vertices]
    lines += ["#", "Simplex"]
    lines += [" ".join(str(v + 1) for v in (cell[::-1] if i % 3 == 0 else cell))
              for i, cell in enumerate(m.cells)]
    lines += ["#", "Boundarydomain", "default 1", "#"]
    path.write_text("\n".join(lines) + "\n")


def test_vertex_simplex_blocks(tmp_path):
    path = tmp_path / "corner.dgf"
    _lshape_dgf(path)
    _same(read_dgf(str(path)), j_read_dgf(str(path)))
    kuhn = tpt.SimplexMesh.from_structured(tpt.StructuredMesh([0] * 3, [1] * 3, (2, 2, 2)))
    text = ("DGF\nVertex\n" + "\n".join(" ".join(repr(float(v)) for v in p)
                                        for p in kuhn.vertices)
            + "\n#\nSimplex\n" + "\n".join(" ".join(str(v) for v in cell[::-1])
                                           for cell in kuhn.cells) + "\n#\n")
    path3 = tmp_path / "kuhn.dgf"
    path3.write_text(text)
    _same(read_dgf(str(path3)), j_read_dgf(str(path3)))
    bad = tmp_path / "bad.dgf"
    bad.write_text("DGF\nCube\n0 1 2 3\n#\n")
    with pytest.raises(NotImplementedError, match="Interval or Vertex"):
        read_dgf(str(bad))
    bad.write_text("not a grid\n")
    with pytest.raises(ValueError, match="not a DGF file"):
        read_dgf(str(bad))


def _u_exact(p):
    p = np.asarray(p).reshape(-1, 2)
    r = np.hypot(p[:, 0], p[:, 1])
    th = np.mod(np.arctan2(p[:, 1], p[:, 0]), 2 * np.pi)
    return np.where(r == 0, 0.0, r ** (2 / 3) * np.sin(2 * th / 3))


class JCorner(JProblem):
    def f(self, x):
        return np.zeros(x.shape[:-1])


class TCorner(TProblem):
    def f(self, x):
        return torch.zeros(x.shape[:-1], dtype=x.dtype)


def test_corner_solve_on_read_mesh(tmp_path):
    path = tmp_path / "corner.dgf"
    _lshape_dgf(path)
    jV = jpt.FunctionSpace(j_read_dgf(str(path)), JPk(1, 2))
    tV = tpt.FunctionSpace(read_dgf(str(path)), tpt.PkFEM(1, 2))
    jc, tc = jpt.constraints(True, jV), tpt.constraints(True, tV)
    js = jpt.StationaryLinearProblemSolver(jpt.GridOperator(jV, JFEM(JCorner()), constraints=jc),
                                           J_CG_Jacobi(), reduction=1e-12, verbose=0)
    jx = np.asarray(js.apply(jpt.interpolate_dirichlet(_u_exact, jV, jc, jV.zero())))
    ts = tpt.StationaryLinearProblemSolver(tpt.GridOperator(tV, TFEM(TCorner()), constraints=tc),
                                           tpt.SEQ_CG_Jacobi(), reduction=1e-12, verbose=0)
    tx = ts.apply(tpt.interpolate_dirichlet(lambda q: _u_exact(q.numpy()), tV, tc,
                                            tV.zero(F64)))
    assert ts.result.linear_solver_iterations == js.result.linear_solver_iterations
    np.testing.assert_allclose(tx.numpy(), jx, rtol=0, atol=1e-10 * np.abs(jx).max())
