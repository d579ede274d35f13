"""ctypes binding of the native binary .vtu writer (csrc/vtu_writer.cc).

PyTorch-package port of dune_pdelab_tpu/io/vtk_binary.py: VTK XML
UnstructuredGrid with appended raw payloads (UInt64 headers,
little-endian). The library is built with g++ into build/torch_kernels/ at
first use (kernels/_host.py). `io.vtk.VTKWriter.write` takes it for
binary=True and, with binary=None, above 65,536 vertices; a writer that
cannot be built raises there.
"""
from __future__ import annotations

import ctypes

import numpy as np

_READY = False


def _load():
    global _READY
    from dune_pdelab_tpu_torch.kernels._host import host_library

    L = host_library("vtu_writer.cc")
    if not _READY:
        c_dp = ctypes.POINTER(ctypes.c_double)
        L.write_vtu_binary.restype = ctypes.c_int
        L.write_vtu_binary.argtypes = [
            ctypes.c_char_p,
            ctypes.c_int64, c_dp,
            ctypes.c_int64, ctypes.c_int, ctypes.POINTER(ctypes.c_int64),
            ctypes.c_uint8,
            ctypes.c_int, ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(c_dp),
            ctypes.c_int, ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(c_dp),
        ]
        _READY = True
    return L


def available() -> bool:
    """True when the writer library builds and loads (g++ present)."""
    try:
        _load()
        return True
    except (RuntimeError, OSError):
        return False


def _field_args(fields: dict):
    c_dp = ctypes.POINTER(ctypes.c_double)
    keep = [np.ascontiguousarray(np.asarray(a, np.float64)) for a in fields.values()]
    n = len(keep)
    return (n,
            (ctypes.c_char_p * max(n, 1))(*(k.encode() for k in fields)),
            (ctypes.c_int * max(n, 1))(*(a.shape[1] if a.ndim > 1 else 1 for a in keep)),
            (c_dp * max(n, 1))(*(a.ctypes.data_as(c_dp) for a in keep)),
            keep)


def write_vtu_binary(path: str, points, conn, celltype: int, point_data: dict,
                     cell_data: dict) -> str:
    """points (np, 3) float64; conn (nc, ncorners) int64; data dicts of
    (n,) or (n, ncomp) host arrays. Returns the path written (.vtu added)."""
    L = _load()
    if not path.endswith(".vtu"):
        path = path + ".vtu"
    points = np.ascontiguousarray(np.asarray(points, np.float64))
    conn = np.ascontiguousarray(np.asarray(conn, np.int64))
    npf, pn, pc, pd, _keep1 = _field_args(point_data)
    ncf, cn, cc, cd, _keep2 = _field_args(cell_data)
    rc = L.write_vtu_binary(
        path.encode(),
        points.shape[0], points.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        conn.shape[0], conn.shape[1], conn.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        celltype, npf, pn, pc, pd, ncf, cn, cc, cd)
    if rc != 0:
        raise OSError(f"native vtu writer failed with code {rc} on {path}")
    return path


def read_vtu_binary(path: str) -> dict:
    """Decode a file of `write_vtu_binary`: {"PointData": {name: array},
    "CellData": {name: array}, "Points": (np, 3), "Cells": {"connectivity",
    "offsets", "types"}}; arrays of more than one component are (n, ncomp)."""
    import re

    raw = open(path, "rb").read()
    mark = raw.index(b'<AppendedData encoding="raw">')
    start = raw.index(b"_", mark) + 1
    dtypes = {"Float64": np.float64, "Int64": np.int64, "UInt8": np.uint8}
    out = {"PointData": {}, "CellData": {}, "Cells": {}}
    section = None
    for line in raw[:mark].decode().splitlines():
        tag = re.match(r"<(\w+)>", line)
        if tag and tag.group(1) in ("PointData", "CellData", "Points", "Cells"):
            section = tag.group(1)
        da = re.match(r'<DataArray type="(\w+)" Name="([^"]*)" NumberOfComponents="(\d+)" '
                      r'format="appended" offset="(\d+)"', line)
        if not da:
            continue
        kind, name, ncomp, off = da.group(1), da.group(2), int(da.group(3)), int(da.group(4))
        n = int(np.frombuffer(raw, np.uint64, 1, start + off)[0])
        a = np.frombuffer(raw, dtypes[kind], n // np.dtype(dtypes[kind]).itemsize,
                          start + off + 8).copy()
        if ncomp > 1:
            a = a.reshape(-1, ncomp)
        if section == "Points":
            out["Points"] = a
        else:
            out[section][name] = a
    return out
