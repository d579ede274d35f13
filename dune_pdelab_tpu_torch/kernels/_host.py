"""Build and load the port's host C++ libraries (`csrc/*.cc`).

Each source is compiled with g++ into a shared library with a plain C
interface in `build/torch_kernels/`, under a name keyed by a hash of the
source and flags, at first use; the library is loaded with ctypes and kept
for the process. Several processes may build at once: each compiles to a
file of its own and renames it into place. A missing g++ or a failed
compile raises with the compiler's output; nothing falls back.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

from dune_pdelab_tpu_torch.kernels._build import BUILD_DIR, CSRC

GXX_FLAGS = ["-O3", "-shared", "-fPIC"]
_LOADED: dict[str, ctypes.CDLL] = {}


def host_library(source: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<source>` (built on first use)."""
    if source in _LOADED:
        return _LOADED[source]
    path = CSRC / source
    src = path.read_bytes()
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode() + src).hexdigest()[:16]
    lib = BUILD_DIR / f"lib{path.stem}_{h}.so"
    if not lib.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        try:
            proc = subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(path)],
                                  capture_output=True, text=True)
        except FileNotFoundError as e:
            raise RuntimeError(f"g++ not found: csrc/{source} is built at first use") from e
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}) on csrc/{source}:\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib)
    _LOADED[source] = ctypes.CDLL(str(lib))
    return _LOADED[source]
