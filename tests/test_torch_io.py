"""The port's io (VTK writers, native binary .vtu writer, native MSH
reader) against the JAX package, on files the tests write into tmp_path.

  * the seven cases of tests/test_io.py on the port. Every ASCII .vtu,
    .pvd and .pvtu file the port writes equals the JAX package's file for
    the same field as text (byte for byte); the binary .vtu files are
    equal byte for byte as well, and their decoded payloads give back the
    host copy of the field bit for bit;
  * binary=None takes the native writer above 65,536 vertices and ASCII
    at or below, as the reference chooses (vtk.py:124-125);
  * the native and Python MSH parses are equal to each other and to the
    JAX package's Python parse, in 2D and 3D; from_gmsh records the
    parser it ran, takes the native one by default, falls back to the
    Python parser when the native one refuses a file, and a malformed file
    raises on every path.
"""
import os
import struct
import xml.etree.ElementTree as ET

import numpy as np
import pytest
import torch

import dune_pdelab_tpu as jpt
import dune_pdelab_tpu_torch as tpt
from dune_pdelab_tpu.fe import PkFEM as JPk
from dune_pdelab_tpu.fe import QkDGFEM as JQkDG
from dune_pdelab_tpu.io import ParallelVTKWriter as JPar
from dune_pdelab_tpu.io import VTKSequenceWriter as JSeq
from dune_pdelab_tpu.io import VTKWriter as JWriter
from dune_pdelab_tpu.mesh import SimplexMesh as JSimplex
from dune_pdelab_tpu_torch.io import ParallelVTKWriter, VTKSequenceWriter, VTKWriter
from dune_pdelab_tpu_torch.io import msh_native, vtk_binary
from dune_pdelab_tpu_torch.mesh import SimplexMesh as TSimplex
from dune_pdelab_tpu_torch.utils.common import set_default_device

pytestmark = pytest.mark.fast
torch.set_num_threads(1)
set_default_device("cpu")
F64 = torch.float64


def _spaces(mesh_args, jfem, tfem, simplex=False):
    jm, tm = jpt.StructuredMesh(*mesh_args), tpt.StructuredMesh(*mesh_args)
    if simplex:
        jm, tm = JSimplex.from_structured(jm), TSimplex.from_structured(tm)
    return jpt.FunctionSpace(jm, jfem), tpt.FunctionSpace(tm, tfem)


def _same_text(a, b):
    assert open(a, "rb").read() == open(b, "rb").read()


def _field(jV, tV, fn):
    """The same interpolated field in both packages (numpy in, fp64)."""
    x = np.asarray(jV.interpolate(fn))
    np.testing.assert_array_equal(tV.interpolate(fn, dtype=F64).numpy(), x)
    return x, torch.as_tensor(x, dtype=F64)


def test_vtu_roundtrip(tmp_path):
    jV, tV = _spaces(([0, 0], [1, 1], (3, 2)), jpt.QkFEM(1, 2), tpt.QkFEM(1, 2))
    jx, tx = _field(jV, tV, lambda p: p[:, 0] + 2 * p[:, 1])
    path = VTKWriter(tV.mesh).add_field(tV, tx, "u").write(str(tmp_path / "out"))
    _same_text(path, JWriter(jV.mesh).add_field(jV, jx, "u").write(str(tmp_path / "j")))
    tree = ET.parse(path)
    assert tree.findall(".//Piece")[0].get("NumberOfCells") == "6"
    vals = np.array(tree.find(".//PointData/DataArray").text.split(), float)
    coords = tV.mesh.vertex_coords()
    assert np.allclose(vals, coords[:, 0] + 2 * coords[:, 1], atol=1e-12)


def test_vtu_dg_cell_data(tmp_path):
    jV, tV = _spaces(([0, 0], [1, 1], (2, 2)), JQkDG(1, 2), tpt.QkDGFEM(1, 2))
    jx, tx = _field(jV, tV, lambda p: 1.0 + p[:, 0] * p[:, 1])
    path = VTKWriter(tV.mesh).add_field(tV, tx, "rho").write(str(tmp_path / "dg"))
    _same_text(path, JWriter(jV.mesh).add_field(jV, jx, "rho").write(str(tmp_path / "j")))
    vals = np.array(ET.parse(path).find(".//CellData/DataArray").text.split(), float)
    c = tV.mesh.element_centers()
    assert np.allclose(vals, 1.0 + c[:, 0] * c[:, 1], atol=1e-9)


def test_vtu_3d_and_sequence(tmp_path):
    jV, tV = _spaces(([0, 0, 0], [1, 1, 1], (2, 2, 2)), jpt.QkFEM(1, 3), tpt.QkFEM(1, 3))
    tseq = VTKSequenceWriter(str(tmp_path / "series"))
    jseq = JSeq(str(tmp_path / "jseries"))
    for t in (0.0, 0.5):
        jx, tx = _field(jV, tV, lambda p: t + p[:, 2])
        tseq.write(tV.mesh, t, [(tV, tx, "u")])
        jseq.write(jV.mesh, t, [(jV, jx, "u")])
    for i in range(2):
        _same_text(tmp_path / f"series-{i:05d}.vtu", tmp_path / f"jseries-{i:05d}.vtu")
    pvd = (tmp_path / "series.pvd").read_text()
    assert pvd == (tmp_path / "jseries.pvd").read_text().replace("jseries", "series")
    assert len(ET.parse(str(tmp_path / "series.pvd")).findall(".//DataSet")) == 2


def test_binary_vtu_writer(tmp_path):
    """The native binary writer: the file equals the JAX package's byte for
    byte, its payload decodes to the field bit for bit, and the ASCII
    variant agrees."""
    jV, tV = _spaces(([0, 0], [1, 1], (3, 2)), jpt.QkFEM(1, 2), tpt.QkFEM(1, 2))
    jx, tx = _field(jV, tV, lambda p: p[:, 0] + 2 * p[:, 1])
    w = VTKWriter(tV.mesh).add_field(tV, tx, "u")
    path = w.write(str(tmp_path / "bin"), binary=True)
    _same_text(path, JWriter(jV.mesh).add_field(jV, jx, "u").write(
        str(tmp_path / "jbin"), binary=True))
    raw = open(path, "rb").read()
    start = raw.index(b"_", raw.index(b'encoding="raw"')) + 1
    nbytes = struct.unpack("<Q", raw[start:start + 8])[0]
    vals = np.frombuffer(raw[start + 8:start + 8 + nbytes], dtype=np.float64)
    np.testing.assert_array_equal(vals, w.point_data["u"])
    dec = vtk_binary.read_vtu_binary(path)
    np.testing.assert_array_equal(dec["PointData"]["u"], w.point_data["u"])
    np.testing.assert_array_equal(dec["Cells"]["connectivity"].reshape(-1, 4),
                                  tV.mesh.element_vertex_indices()[:, [0, 1, 3, 2]])
    ascii_path = w.write(str(tmp_path / "ascii"), binary=False)
    vals2 = np.array(ET.parse(ascii_path).find(".//PointData/DataArray").text.split(), float)
    assert np.allclose(vals, vals2)


def test_binary_vtu_speed_smoke(tmp_path):
    """A ~1M-point field through the binary path: binary=None takes it
    above 65,536 vertices (ASCII at or below), in under 10 s, and the
    payload decodes to the host copy bit for bit."""
    import time

    mesh = tpt.StructuredMesh([0, 0], [1, 1], (1023, 1023))
    V = tpt.FunctionSpace(mesh, tpt.QkFEM(1, 2))
    x = V.interpolate(lambda p: p[:, 0], dtype=F64)
    t0 = time.perf_counter()
    w = VTKWriter(mesh).add_field(V, x, "u")
    path = w.write(str(tmp_path / "big"))
    assert time.perf_counter() - t0 < 10.0
    assert os.path.getsize(path) > 8 * 1024**2
    np.testing.assert_array_equal(vtk_binary.read_vtu_binary(path)["PointData"]["u"],
                                  w.point_data["u"])
    small = tpt.StructuredMesh([0, 0], [1, 1], (255, 255))     # 65,536 vertices
    Vs = tpt.FunctionSpace(small, tpt.QkFEM(1, 2))
    p = VTKWriter(small).add_field(Vs, Vs.zero(F64), "u").write(str(tmp_path / "small"))
    assert b'format="ascii"' in open(p, "rb").read(4096)


def test_pvtu_parallel_pieces(tmp_path):
    """ParallelVTKWriter: the .pvtu and every piece equal the JAX
    package's files; the pieces' cells sum to the mesh's."""
    jV, tV = _spaces(([0, 0], [1, 1], (4, 4)), jpt.QkFEM(1, 2), tpt.QkFEM(1, 2))
    jx, tx = _field(jV, tV, lambda p: p[:, 0] + 2 * p[:, 1])
    owner = np.repeat(np.arange(4), 4)
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    path = ParallelVTKWriter(tV.mesh, torch.as_tensor(owner)).add_field(tV, tx, "u").write(
        str(tmp_path / "t" / "par"))
    JPar(jV.mesh, owner).add_field(jV, jx, "u").write(str(tmp_path / "j" / "par"))
    assert path.endswith(".pvtu")
    for name in ["par.pvtu"] + [f"par_p{r}.vtu" for r in range(4)]:
        _same_text(tmp_path / "t" / name, tmp_path / "j" / name)
    total = sum(int(ET.parse(str(tmp_path / "t" / pc.get("Source"))).find(".//Piece")
                    .get("NumberOfCells")) for pc in ET.parse(path).findall(".//Piece"))
    assert total == tV.mesh.nelements


def test_vtu_simplex_mesh(tmp_path):
    """Simplex meshes write TRIANGLE cells, as the JAX package does."""
    jV, tV = _spaces(([0, 0], [1, 1], (2, 2)), JPk(1, 2), tpt.PkFEM(1, 2), simplex=True)
    jx, tx = _field(jV, tV, lambda p: p[:, 0] - p[:, 1])
    path = VTKWriter(tV.mesh).add_field(tV, tx, "u").write(str(tmp_path / "tri"),
                                                           binary=False)
    _same_text(path, JWriter(jV.mesh).add_field(jV, jx, "u").write(
        str(tmp_path / "jtri"), binary=False))
    tree = ET.parse(path)
    assert set(tree.find(".//Cells/DataArray[@Name='types']").text.split()) == {"5"}


def _write_msh(path, mesh, extra=""):
    """MSH 2.2 ASCII of a SimplexMesh: boundary facets with tags 3/4, cells
    with tag 7, node ids from 11, every other cell reversed, and `extra`
    element lines (other element types) before the cells."""
    uniq_f, _, counts = mesh.faces()
    bfaces = uniq_f[counts == 1]
    ftype, ctype = (1, 2) if mesh.dim == 2 else (2, 4)
    extra_lines = [ln for ln in extra.split("\n") if ln]
    with open(path, "w") as f:
        f.write("$MeshFormat\n2.2 0 8\n$EndMeshFormat\n$Nodes\n")
        f.write(f"{mesh.nvertices}\n")
        for i, v in enumerate(mesh.vertices):
            x, y, z = (float(c) for c in (list(v) + [0.0])[:3])
            f.write(f"{i + 11} {x!r} {y!r} {z!r}\n")
        f.write("$EndNodes\n$Elements\n")
        f.write(f"{mesh.nelements + len(bfaces) + len(extra_lines)}\n")
        for i, fv in enumerate(bfaces):
            f.write(f"{i + 1} {ftype} 2 {3 + i % 2} 1 " + " ".join(str(v + 11) for v in fv)
                    + "\n")
        for ln in extra_lines:
            f.write(ln + "\n")
        for i, c in enumerate(mesh.cells):
            c = c[::-1] if i % 2 else c
            f.write(f"{i + 1} {ctype} 2 7 1 " + " ".join(str(v + 11) for v in c) + "\n")
        f.write("$EndElements\n")


@pytest.mark.parametrize("dim", [2, 3])
def test_native_msh_parse_matches(tmp_path, dim):
    """Native and Python parses are equal array for array (a point element
    and a quad are skipped by both) and equal to the JAX package's parse;
    the meshes read both ways are equal, with their tags."""
    src = TSimplex.from_structured(tpt.StructuredMesh([0] * dim, [1] * dim, (3,) * dim))
    path = str(tmp_path / "m.msh")
    _write_msh(path, src, extra="900 15 2 1 1 11\n901 3 2 1 1 11 12 13 14")
    nat = msh_native.parse_msh(path)
    py = TSimplex._parse_msh_py(path)
    ref = JSimplex._parse_msh_py(path)
    for a, b, c in zip(nat, py, ref):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, np.asarray(c))
    mn = TSimplex.from_gmsh(path, reader="native")
    mp = TSimplex.from_gmsh(path, reader="python")
    jm = JSimplex.from_gmsh(path)
    assert (mn.msh_reader, mp.msh_reader, TSimplex.from_gmsh(path).msh_reader) == (
        "native", "python", "native")
    for m in (mn, mp):
        np.testing.assert_array_equal(m.cells, jm.cells)
        np.testing.assert_array_equal(m.vertices, jm.vertices)
        np.testing.assert_array_equal(m.cell_tags, jm.cell_tags)
        np.testing.assert_array_equal(m.boundary_vertex_mask(), jm.boundary_vertex_mask())
        assert m.facet_tags == jm.facet_tags


BODY = ("$MeshFormat\n2.2 0 8\n$EndMeshFormat\n$Nodes\n3\n1 0 0 0\n2 1 0 0\n3 0 1 0\n"
        "$EndNodes\n$Elements\n1\n1 2 2 0 1 1 2 3\n$EndElements\n")


@pytest.mark.parametrize("bad,err", [
    (BODY.replace("$Nodes", "$Nodez"), ValueError),
    (BODY.replace("1 2 2 0 1 1 2 3", "1 2 2 0 1 1 2"), ValueError),
    (BODY.replace("1 2 2 0 1 1 2 3", "1 2 2 0 1 1 2 9"), ValueError),
    (BODY.replace("2 1 0 0\n", "2 1 0\n"), ValueError),
    (BODY.replace("1 2 2 0 1 1 2 3", "1 2 2 0 1 1 2 3 1"), ValueError),
    (BODY.replace("2.2 0 8", "4.1 0 8"), NotImplementedError),
])
def test_reader_rules_on_malformed_files(tmp_path, bad, err):
    """Both parsers refuse the same malformed files, so every reader
    choice raises, the default one with the Python parser's message (it
    falls back when the native reader refuses a file)."""
    path = str(tmp_path / "bad.msh")
    with open(path, "w") as f:
        f.write(bad)
    with pytest.raises(err):
        msh_native.parse_msh(path)
    with pytest.raises(err):
        TSimplex._parse_msh_py(path)
    for reader in (None, "native", "python"):
        with pytest.raises(err):
            TSimplex.from_gmsh(path, reader=reader)
    with pytest.raises(ValueError, match="reader="):
        TSimplex.from_gmsh(path, reader="fast")
