"""DGF (DUNE grid format) reader, the grid input of the reference's test
fixtures (reference: dune/pdelab/test/grids/*.dgf, read there by
dune-grid's DGFParser). PyTorch-package port of dune_pdelab_tpu/io/dgf.py.

Supported blocks (the subset the reference grids use):
  * ``Interval``: lower point / upper point / cells per axis, a structured
    mesh; with an (empty) ``Simplex`` block it is triangulated.
  * ``Vertex`` + ``Simplex``: an unstructured triangle/tet mesh (0-based
    vertex indices, the DGF default; ``firstindex n`` shifts them).
``%`` comment lines and ``#`` block terminators follow the format; block
names are case-insensitive. A ``Boundarydomain`` default id is recorded as
``mesh.boundary_domain_default``.
"""
from __future__ import annotations

import numpy as np


def read_dgf(path):
    """Parse a DGF file into a StructuredMesh or SimplexMesh."""
    from dune_pdelab_tpu_torch.mesh.simplex import SimplexMesh
    from dune_pdelab_tpu_torch.mesh.structured import StructuredMesh

    blocks: dict[str, list[list[str]]] = {}
    cur = None
    with open(path) as f:
        first = f.readline().strip()
        if not first.upper().startswith("DGF"):
            raise ValueError(f"{path} is not a DGF file")
        for line in f:
            s = line.split("%")[0].strip()
            if not s:
                continue
            if s == "#":
                cur = None
                continue
            if cur is None:
                cur = s.split()[0].lower()
                blocks[cur] = []
                rest = s.split()[1:]
                if rest:
                    blocks[cur].append(rest)
            else:
                blocks[cur].append(s.split())

    bdefault = None
    for row in blocks.get("boundarydomain", []):
        if row and row[0].lower() == "default":
            bdefault = int(row[1])

    if "interval" in blocks:
        rows = blocks["interval"]
        mesh = StructuredMesh([float(v) for v in rows[0]], [float(v) for v in rows[1]],
                              tuple(int(v) for v in rows[2]))
        if "simplex" in blocks:
            mesh = SimplexMesh.from_structured(mesh)
        mesh.boundary_domain_default = bdefault
        return mesh

    if "vertex" in blocks and "simplex" in blocks:
        rows = blocks["vertex"]
        first_index = 0
        if rows and rows[0][0].lower() == "firstindex":
            first_index = int(rows[0][1])
            rows = rows[1:]
        verts = np.array([[float(v) for v in r] for r in rows])
        cells = np.array([[int(v) - first_index for v in r] for r in blocks["simplex"]])
        mesh = SimplexMesh(verts, cells)
        mesh._positively_oriented()
        mesh._boundary_vertices = mesh._face_count_boundary()
        mesh.boundary_domain_default = bdefault
        return mesh

    raise NotImplementedError(
        f"DGF blocks {sorted(blocks)} in {path}: need Interval or Vertex+Simplex")
