"""VTK output: .vtu unstructured-grid files, .pvd time series and .pvtu
partitioned output.

PyTorch port of dune_pdelab_tpu/io/vtk.py (reference analog:
dune/pdelab/gridfunctionspace/vtk.hh:65-337 `addSolutionToVTKWriter` and
the VTKSequenceWriter of dune/pdelab/test/testpoisson.cc:264-266).
Conforming fields are written as point data evaluated at the mesh
vertices, DG fields as cell data (element means). A field's tensor comes to
the host once, when it is added; the writing is host work. The payloads
are ASCII XML, or appended raw binary through the native writer
(io/vtk_binary.py) for binary=True and, with binary=None, above 65,536
vertices, as the reference chooses; a native writer that cannot be built
raises instead of falling back to ASCII.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from dune_pdelab_tpu_torch.space.space import to_numpy

_VTK_CELL = {2: 9, 3: 12}           # QUAD, HEXAHEDRON
_VTK_CELL_SIMPLEX = {2: 5, 3: 10}   # TRIANGLE, TETRA
BINARY_ABOVE = 65536                 # vertices; binary=None writes binary above


def _cell_type(mesh) -> int:
    if getattr(mesh, "geometry_type", "cube") == "simplex":
        return _VTK_CELL_SIMPLEX.get(mesh.dim, 5)
    return _VTK_CELL.get(mesh.dim, 3)


def _vtk_corner_order(dim: int, geometry: str = "cube"):
    """Corner order -> VTK node order (bit order for cubes; simplex corners
    pass through)."""
    if geometry == "simplex":
        return list(range(dim + 1))
    if dim == 1:
        return [0, 1]
    if dim == 2:
        return [0, 1, 3, 2]
    return [0, 1, 3, 2, 4, 5, 7, 6]


def _vertex_values(space, x) -> np.ndarray:
    """A C0/DG field at the mesh vertices: element-local corner values,
    averaged over the elements sharing a vertex (host numpy, the
    reference's arithmetic)."""
    mesh = space.mesh
    corners_ref = np.array(mesh.corner_offsets(), dtype=np.float64)
    vals, _ = space.fem.tabulate(corners_ref)               # (C, nb)
    u_loc = to_numpy(x)[np.asarray(space.element_dofs)]     # (E, nb)
    vvals = u_loc @ vals.T                                  # (E, C)
    ev = mesh.element_vertex_indices()
    out = np.zeros(mesh.nvertices)
    cnt = np.zeros(mesh.nvertices)
    np.add.at(out, ev.reshape(-1), vvals.reshape(-1))
    np.add.at(cnt, ev.reshape(-1), 1.0)
    return out / np.maximum(cnt, 1.0)


def _cell_means(space, x) -> np.ndarray:
    from dune_pdelab_tpu_torch.space.functions import evaluate_at_quadrature

    _, u, _, factor = evaluate_at_quadrature(space, x, gradient=False)
    vol = torch.sum(factor * torch.ones_like(u), dim=-1)
    return to_numpy(torch.sum(factor * u, dim=-1) / vol)


def _points(mesh):
    pts = mesh.vertex_coords()
    if mesh.dim < 3:
        pts = np.concatenate([pts, np.zeros((len(pts), 3 - mesh.dim))], axis=1)
    return pts


def _connectivity(mesh):
    return mesh.element_vertex_indices()[
        :, _vtk_corner_order(mesh.dim, getattr(mesh, "geometry_type", "cube"))]


class VTKWriter:
    """Collect fields over one mesh, write a .vtu file."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.point_data: dict[str, np.ndarray] = {}
        self.cell_data: dict[str, np.ndarray] = {}

    def add_field(self, space, x, name: str, mode: str | None = None):
        """Add a scalar discrete function. mode: 'point' | 'cell' | None
        (C0 -> point data, DG -> cell data)."""
        if space.mesh is not self.mesh:
            raise ValueError("field mesh differs from writer mesh")
        if mode is None:
            mode = "point" if space.fem.continuity == "C0" else "cell"
        if mode == "point":
            self.point_data[name] = _vertex_values(space, x)
        else:
            self.cell_data[name] = _cell_means(space, x)
        return self

    def add_vector_field(self, power_space, x, name: str):
        """Add a vector field from a PowerSpace subvector (flat layout)."""
        comps = [_vertex_values(power_space.children[c], power_space.restrict(x, c))
                 for c in range(power_space.nchildren)]
        arr = np.stack(comps, axis=-1)
        if arr.shape[-1] == 2:  # VTK wants 3 components
            arr = np.concatenate([arr, np.zeros_like(arr[:, :1])], axis=-1)
        self.point_data[name] = arr
        return self

    def add_cell_data(self, name: str, arr):
        """Attach a raw per-cell array (E,) or (E, ncomp); 2-vectors are
        padded to 3 components as VTK expects."""
        a = np.asarray(to_numpy(arr), dtype=np.float64)
        if a.shape[0] != self.mesh.nelements:
            raise ValueError(f"cell data {name}: {a.shape[0]} rows != "
                             f"{self.mesh.nelements} cells")
        if a.ndim > 1 and a.shape[-1] == 2:
            a = np.concatenate([a, np.zeros_like(a[:, :1])], axis=1)
        self.cell_data[name] = a
        return self

    def write(self, path: str, binary: bool | None = None) -> str:
        """Write the .vtu file: ASCII XML, or the native binary writer for
        binary=True and (binary=None) above 65,536 vertices."""
        mesh = self.mesh
        if not path.endswith(".vtu"):
            path = path + ".vtu"
        pts, conn = _points(mesh), _connectivity(mesh)
        if binary is True or (binary is None and mesh.nvertices > BINARY_ABOVE):
            from dune_pdelab_tpu_torch.io import vtk_binary
            return vtk_binary.write_vtu_binary(path, pts, conn, _cell_type(mesh),
                                               self.point_data, self.cell_data)
        ncorn = conn.shape[1]
        offsets = np.arange(1, mesh.nelements + 1) * ncorn
        types = np.full(mesh.nelements, _cell_type(mesh))

        def arr_to_txt(a, fmt="%.10g"):
            return "\n".join(" ".join(fmt % v for v in np.atleast_1d(row)) for row in a)

        def data_arrays(data: dict):
            return "\n".join(
                f'<DataArray type="Float64" Name="{name}" '
                f'NumberOfComponents="{a.shape[1] if a.ndim > 1 else 1}" format="ascii">\n'
                + arr_to_txt(a) + "\n</DataArray>" for name, a in data.items())

        xml = f"""<?xml version="1.0"?>
<VTKFile type="UnstructuredGrid" version="0.1" byte_order="LittleEndian">
<UnstructuredGrid>
<Piece NumberOfPoints="{mesh.nvertices}" NumberOfCells="{mesh.nelements}">
<PointData>
{data_arrays(self.point_data)}
</PointData>
<CellData>
{data_arrays(self.cell_data)}
</CellData>
<Points>
<DataArray type="Float64" NumberOfComponents="3" format="ascii">
{arr_to_txt(pts)}
</DataArray>
</Points>
<Cells>
<DataArray type="Int64" Name="connectivity" format="ascii">
{arr_to_txt(conn, "%d")}
</DataArray>
<DataArray type="Int64" Name="offsets" format="ascii">
{arr_to_txt(offsets, "%d")}
</DataArray>
<DataArray type="UInt8" Name="types" format="ascii">
{arr_to_txt(types, "%d")}
</DataArray>
</Cells>
</Piece>
</UnstructuredGrid>
</VTKFile>
"""
        with open(path, "w") as f:
            f.write(xml)
        return path


class ParallelVTKWriter:
    """Partitioned output: one ASCII .vtu piece per part and a .pvtu index
    (reference analog: dune/pdelab/gridfunctionspace/vtk.hh:65-400 with
    dune-grid's VTKWriter::pwrite). Parts are element partitions
    (`element_owner`, e.g. parallel/loadbalance.py's); fields are evaluated
    once over the whole mesh and restricted to each piece, so the files
    equal what per-rank writers would produce."""

    def __init__(self, mesh, element_owner, nshards: int | None = None):
        self.mesh = mesh
        self.owner = np.asarray(to_numpy(element_owner))
        if len(self.owner) != mesh.nelements:
            raise ValueError("element_owner length != nelements")
        self.nshards = int(self.owner.max()) + 1 if nshards is None else int(nshards)
        self.point_data: dict[str, np.ndarray] = {}
        self.cell_data: dict[str, np.ndarray] = {}

    add_field = VTKWriter.add_field
    add_vector_field = VTKWriter.add_vector_field

    def write(self, basename: str) -> str:
        """Write `basename_p{r}.vtu` for each part and `basename.pvtu`;
        returns the .pvtu path."""
        mesh = self.mesh
        base = basename[:-5] if basename.endswith(".pvtu") else basename
        pts_all, conn_all = _points(mesh), _connectivity(mesh)
        geo = getattr(mesh, "geometry_type", "cube")
        piece_files = []
        for r in range(self.nshards):
            sel = np.nonzero(self.owner == r)[0]
            conn = conn_all[sel]
            used = np.unique(conn.ravel())
            remap = np.full(mesh.nvertices, -1, np.int64)
            remap[used] = np.arange(len(used))
            w = VTKWriter(_PieceMesh(pts_all[used], remap[conn], mesh.dim, geo))
            w.point_data = {k: v[used] for k, v in self.point_data.items()}
            w.cell_data = {k: v[sel] for k, v in self.cell_data.items()}
            piece_files.append(w.write(f"{base}_p{r}.vtu", binary=False))

        def pdecl(data):
            return "\n".join(
                f'<PDataArray type="Float64" Name="{k}" '
                f'NumberOfComponents="{v.shape[1] if v.ndim > 1 else 1}"/>'
                for k, v in data.items())

        pieces = "\n".join(f'<Piece Source="{os.path.basename(f)}"/>' for f in piece_files)
        xml = f"""<?xml version="1.0"?>
<VTKFile type="PUnstructuredGrid" version="0.1" byte_order="LittleEndian">
<PUnstructuredGrid GhostLevel="0">
<PPointData>
{pdecl(self.point_data)}
</PPointData>
<PCellData>
{pdecl(self.cell_data)}
</PCellData>
<PPoints>
<PDataArray type="Float64" NumberOfComponents="3"/>
</PPoints>
{pieces}
</PUnstructuredGrid>
</VTKFile>
"""
        path = base + ".pvtu"
        with open(path, "w") as f:
            f.write(xml)
        return path


class _PieceMesh:
    """The mesh facade of one partition piece."""

    def __init__(self, pts, conn, dim, geometry="cube"):
        self._pts = pts
        self._conn = conn
        self.dim = dim
        self.geometry_type = geometry
        self.nvertices = len(pts)
        self.nelements = len(conn)

    def vertex_coords(self):
        return self._pts[:, :self.dim]

    def element_vertex_indices(self):
        # already in VTK corner order: undo the writer's reorder
        return self._conn[:, np.argsort(_vtk_corner_order(self.dim, self.geometry_type))]


class VTKSequenceWriter:
    """Time series: numbered .vtu files and a .pvd index."""

    def __init__(self, basename: str):
        self.basename = basename
        self.entries: list[tuple[float, str]] = []

    def write(self, mesh, time: float, fields) -> str:
        """fields: a list of (space, x, name) or a prepared VTKWriter."""
        if isinstance(fields, VTKWriter):
            w = fields
        else:
            w = VTKWriter(mesh)
            for space, x, name in fields:
                w.add_field(space, x, name)
        fname = w.write(f"{self.basename}-{len(self.entries):05d}.vtu")
        self.entries.append((time, os.path.basename(fname)))
        self._write_pvd()
        return fname

    def _write_pvd(self):
        lines = ['<?xml version="1.0"?>', '<VTKFile type="Collection" version="0.1">',
                 "<Collection>"]
        lines += [f'<DataSet timestep="{t}" part="0" file="{f}"/>' for t, f in self.entries]
        lines += ["</Collection>", "</VTKFile>"]
        with open(self.basename + ".pvd", "w") as f:
            f.write("\n".join(lines))
