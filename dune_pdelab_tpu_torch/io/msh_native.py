"""ctypes binding of the native Gmsh MSH 2.x parser (csrc/msh_reader.cc).

PyTorch-package port of dune_pdelab_tpu/io/msh_native.py. The library is
built with g++ into build/torch_kernels/ at first use (kernels/_host.py);
the reference builds it beside its source and commits the binary, the port
commits none. The parser follows the Python parser's rules line by line
(mesh/simplex.py `_parse_msh_py`), so both give identical arrays and refuse
the same files. `SimplexMesh.from_gmsh` takes it when it can be built.
"""
from __future__ import annotations

import ctypes

import numpy as np

_READY = False
_MESSAGES = {
    2: "$MeshFormat not found", 4: "$Nodes not found", 5: "bad node count",
    6: "malformed node line", 7: "$Elements not found", 8: "bad element count",
    9: "malformed element line", 11: "an element without its type's number of nodes",
    12: "unknown node id",
}


def _load():
    global _READY
    from dune_pdelab_tpu_torch.kernels._host import host_library

    L = host_library("msh_reader.cc")
    if not _READY:
        i64p = ctypes.POINTER(ctypes.c_int64)
        L.msh_open.restype = ctypes.c_void_p
        L.msh_open.argtypes = [ctypes.c_char_p, i64p, i64p, i64p, i64p,
                               ctypes.POINTER(ctypes.c_int)]
        L.msh_fill.restype = None
        L.msh_fill.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_double),
                               i64p, i64p, i64p, i64p, i64p, i64p]
        L.msh_close.restype = None
        L.msh_close.argtypes = [ctypes.c_void_p]
        _READY = True
    return L


def available() -> bool:
    """True when the parser library builds and loads (g++ present)."""
    try:
        _load()
        return True
    except (RuntimeError, OSError):
        return False


def parse_msh(path: str):
    """Parse an MSH 2.x ASCII file natively.

    Returns (coords (nn, 3) f64, tris (nt, 3) i64, tritags (nt,) i64, tets
    (nq, 4) i64, tettags (nq,) i64, lines (nl, 2) i64, linetags (nl,) i64),
    the Python parser's tuple. A file that cannot be opened raises OSError,
    MSH 4 NotImplementedError, a malformed file ValueError (with the
    parser's error code); a library that cannot be built raises
    RuntimeError."""
    L = _load()
    counts = [ctypes.c_int64() for _ in range(4)]
    err = ctypes.c_int()
    h = L.msh_open(str(path).encode(), *(ctypes.byref(c) for c in counts),
                   ctypes.byref(err))
    if not h:
        code = err.value
        if code == 1:
            raise OSError(f"cannot open {path}")
        if code == 3:
            raise NotImplementedError(
                f"{path}: only the MSH 2.x ASCII format is supported "
                "(export from gmsh with -format msh22)")
        raise ValueError(f"malformed MSH file {path}: {_MESSAGES.get(code, 'error')} "
                         f"(native reader code {code})")
    try:
        nn, nt, nq, nl = (c.value for c in counts)
        coords = np.empty((nn, 3), np.float64)
        tris, tritags = np.empty((nt, 3), np.int64), np.empty(nt, np.int64)
        tets, tettags = np.empty((nq, 4), np.int64), np.empty(nq, np.int64)
        lns, lntags = np.empty((nl, 2), np.int64), np.empty(nl, np.int64)
        i64p = ctypes.POINTER(ctypes.c_int64)
        L.msh_fill(h, coords.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                   *(a.ctypes.data_as(i64p) for a in (tris, tritags, tets, tettags,
                                                      lns, lntags)))
    finally:
        L.msh_close(h)
    return coords, tris, tritags, tets, tettags, lns, lntags
