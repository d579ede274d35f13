"""The port's Gmsh MSH 2.x input (`SimplexMesh.from_gmsh`, Python parser)
against the JAX package's, on files the test writes itself (never the
reference checkout's grids).

  * 2D (triangles with line facets) and 3D (tetrahedra with triangle
    facets) files: vertices, oriented cells, boundary masks, cell tags and
    facet tags equal;
  * a P1 Poisson solve on the read mesh equals the reference's;
  * malformed files raise (missing section, short element line, unknown
    node id, MSH 4); a good file reads through the native reader by
    default, with the Python parser's arrays.
"""
import numpy as np
import pytest
import torch

import dune_pdelab_tpu as jpt
import dune_pdelab_tpu_torch as tpt
from dune_pdelab_tpu.mesh import SimplexMesh as JSimplex
from dune_pdelab_tpu.ops import ConvectionDiffusionFEM as JFEM
from dune_pdelab_tpu.ops import ConvectionDiffusionProblem as JProblem
from dune_pdelab_tpu.solvers import SEQ_CG_Jacobi as J_CG_Jacobi
from dune_pdelab_tpu_torch.interop import simplex_mesh_from_numpy
from dune_pdelab_tpu_torch.mesh import SimplexMesh as TSimplex
from dune_pdelab_tpu_torch.ops import ConvectionDiffusionFEM as TFEM
from dune_pdelab_tpu_torch.ops import ConvectionDiffusionProblem as TProblem
from dune_pdelab_tpu_torch.utils.common import set_default_device

pytestmark = pytest.mark.fast
torch.set_num_threads(1)
set_default_device("cpu")
F64 = torch.float64


def _write_msh(path, mesh, cell_tag=7, facet_tag=3):
    """Serialize a SimplexMesh as MSH 2.2 ASCII (as tests/test_gmsh.py:26
    does for 2D; here 2D and 3D, every other cell listed in reverse
    orientation so the reader's orientation fix is exercised)."""
    uniq_f, _, counts = mesh.faces()
    bfaces = uniq_f[counts == 1]
    ftype, ctype = (1, 2) if mesh.dim == 2 else (2, 4)
    with open(path, "w") as f:
        f.write("$MeshFormat\n2.2 0 8\n$EndMeshFormat\n$Nodes\n")
        f.write(f"{mesh.nvertices}\n")
        for i, v in enumerate(mesh.vertices):
            x, y, z = (float(c) for c in (list(v) + [0.0])[:3])
            f.write(f"{i + 11} {x!r} {y!r} {z!r}\n")     # ids need not start at 1
        f.write("$EndNodes\n$Elements\n")
        f.write(f"{mesh.nelements + len(bfaces)}\n")
        eid = 1
        for i, fv in enumerate(bfaces):
            f.write(f"{eid} {ftype} 2 {facet_tag + i % 2} 1 "
                    + " ".join(str(v + 11) for v in fv) + "\n")
            eid += 1
        for i, c in enumerate(mesh.cells):
            c = c[::-1] if i % 2 else c
            f.write(f"{eid} {ctype} 2 {cell_tag} 1 " + " ".join(str(v + 11) for v in c) + "\n")
            eid += 1
        f.write("$EndElements\n")


@pytest.mark.parametrize("dim", [2, 3])
def test_from_gmsh_matches_jax(tmp_path, dim):
    n = (5, 4) if dim == 2 else (2, 2, 1)
    m0 = TSimplex.from_structured(tpt.StructuredMesh([0] * dim, [1] * dim, n))
    path = str(tmp_path / "m.msh")
    _write_msh(path, m0)
    jm, tm = JSimplex.from_gmsh(path), TSimplex.from_gmsh(path)
    assert tm.dim == dim and tm.nelements == m0.nelements
    np.testing.assert_array_equal(tm.vertices, jm.vertices)
    np.testing.assert_array_equal(tm.cells, jm.cells)
    np.testing.assert_array_equal(tm.boundary_vertex_mask(), jm.boundary_vertex_mask())
    np.testing.assert_array_equal(tm.cell_tags, jm.cell_tags)
    assert tm.facet_tags == jm.facet_tags and set(tm.facet_tags.values()) == {3, 4}
    rt = simplex_mesh_from_numpy(jm.vertices, jm.cells, jm.boundary_vertex_mask(),
                                 cell_tags=jm.cell_tags, facet_tags=jm.facet_tags)
    assert rt.facet_tags == jm.facet_tags
    np.testing.assert_array_equal(rt.cell_tags, jm.cell_tags)
    cc = tm.element_corner_coords()
    J = np.stack([cc[:, dim - i] - cc[:, 0] for i in range(dim)], axis=-1)
    assert (np.linalg.det(J) > 0).all()


class JS(JProblem):
    def f(self, x):
        return 1.0 + x[..., 0]


class TS(TProblem):
    def f(self, x):
        return 1.0 + x[..., 0]


def test_solve_on_read_mesh(tmp_path):
    path = str(tmp_path / "m.msh")
    _write_msh(path, TSimplex.from_structured(tpt.StructuredMesh([0, 0], [1, 1], (6, 5))))
    jV = jpt.FunctionSpace(JSimplex.from_gmsh(path), jpt.PkFEM(1, 2))
    tV = tpt.FunctionSpace(TSimplex.from_gmsh(path), tpt.PkFEM(1, 2))
    jc, tc = jpt.constraints(True, jV), tpt.constraints(True, tV)
    jx = jpt.StationaryLinearProblemSolver(jpt.GridOperator(jV, JFEM(JS()), constraints=jc),
                                           J_CG_Jacobi(), reduction=1e-12,
                                           verbose=0).apply(jV.zero())
    tx = tpt.StationaryLinearProblemSolver(tpt.GridOperator(tV, TFEM(TS()), constraints=tc),
                                           tpt.SEQ_CG_Jacobi(), reduction=1e-12,
                                           verbose=0).apply(tV.zero(F64))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=0, atol=1e-12)


BODY = ("$MeshFormat\n2.2 0 8\n$EndMeshFormat\n$Nodes\n3\n1 0 0 0\n2 1 0 0\n3 0 1 0\n"
        "$EndNodes\n$Elements\n1\n1 2 2 0 1 1 2 3\n$EndElements\n")


@pytest.mark.parametrize("bad,err,match", [
    (BODY.replace("$Nodes", "$Nodez"), ValueError, "Nodes not found"),
    (BODY.replace("1 2 2 0 1 1 2 3", "1 2 2 0 1 1 2"), ValueError, "malformed"),
    (BODY.replace("1 2 2 0 1 1 2 3", "1 2 2 0 1 1 2 9"), ValueError, "malformed"),
    (BODY.replace("2 1 0 0\n", "2 1 0\n"), ValueError, "malformed"),
    (BODY.replace("2.2 0 8", "4.1 0 8"), NotImplementedError, "2.x"),
    (BODY.replace("1 2 2 0 1 1 2 3", "1 1 2 0 1 1 2"), ValueError, "no triangles"),
])
def test_malformed_files_raise(tmp_path, bad, err, match):
    path = tmp_path / "bad.msh"
    path.write_text(bad)
    with pytest.raises(err, match=match):
        TSimplex.from_gmsh(str(path))


def test_good_file_and_native_reader(tmp_path):
    path = tmp_path / "ok.msh"
    path.write_text(BODY)
    m = TSimplex.from_gmsh(str(path))
    assert m.nelements == 1 and m.nvertices == 3 and m.msh_reader == "native"
    n = TSimplex.from_gmsh(str(path), reader="native")
    p = TSimplex.from_gmsh(str(path), reader="python")
    assert (n.msh_reader, p.msh_reader) == ("native", "python")
    np.testing.assert_array_equal(n.cells, p.cells)
    np.testing.assert_array_equal(n.vertices, p.vertices)
