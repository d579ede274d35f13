"""Build and load the hand-written CUDA kernels.

All `csrc/*.cu` sources are compiled with nvcc for sm_90a (one nvcc process
per source, run in parallel) and linked into one shared library with a
plain C interface, loaded with ctypes. The library lands in
`build/torch_kernels/` at the repository root under a name keyed by a hash
of the sources and flags, so an edit rebuilds and an unchanged tree reuses
it. A missing nvcc or a failed compile raises with the compiler's output;
nothing is downloaded and no fallback is taken.

Import stays cheap: nothing is built until the first kernel launch.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

from dune_pdelab_tpu_torch.utils.common import full_fp32_on_cuda

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
_L = ctypes.c_longlong
_BLOCK = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _L, _L, _L, _L, _P, _I, _I, _I, _P]
_FUSED = [_P, _P, _P, _I, _I, _I, _P, _I, _I, _D, _P, _P, _P, _P, _I, _P]
# C entry points: name -> argtypes (all return the cudaError_t as int)
_SIGNATURES = {
    "dpt_structured_fused_f32": _FUSED,
    "dpt_structured_fused_f64": _FUSED,
    "dpt_window_nblocks": [_I, _I, _I],
    "dpt_blockstencil_f32": _BLOCK,
    "dpt_blockstencil_f64": _BLOCK,
    "dpt_ell27_f32": [_P, _P, _P, _P, _I, _I, _I, _P],
    "dpt_ell27_f64": [_P, _P, _P, _P, _I, _I, _I, _P],
    "dpt_stencil27_f32": [_P, _P, _P, _I, _I, _I, _P, _P],
    "dpt_stencil27_f64": [_P, _P, _P, _I, _I, _I, _P, _P],
    "dpt_fused_cg_k1_f32": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P],
    "dpt_fused_cg_k1_f64": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P],
    "dpt_fused_cg_k2_f32": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P],
    "dpt_fused_cg_k2_f64": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P],
}

_lib = None
build_seconds = None   # wall time of the compile (None: reused or not built)
build_log = ""         # nvcc output of the compile (ptxas register report)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin); "
                       "the CUDA kernels are built from csrc/ at first use")


def library_path() -> Path:
    sources = sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in sources:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return BUILD_DIR / f"libdpt_kernels_{h.hexdigest()[:16]}.so"


def library() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    global _lib, build_seconds, build_log
    if _lib is not None:
        return _lib
    if not torch.cuda.is_available():
        raise RuntimeError("the CUDA kernels need a CUDA device")
    full_fp32_on_cuda()
    out = library_path()
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.perf_counter()
        # one nvcc per source, all started together, then one link
        objs, procs = [], []
        for src in sorted(CSRC.glob("*.cu")):
            obj = tmp.with_name(f"{tmp.name}.{src.stem}.o")
            cmd = [_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            objs.append(obj)
            procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT,
                                                text=True)))
        logs = [(cmd, p.communicate()[0], p.returncode) for cmd, p in procs]
        link = [_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
        if all(rc == 0 for _, _, rc in logs):
            proc = subprocess.run(link, capture_output=True, text=True)
            logs.append((link, proc.stdout + proc.stderr, proc.returncode))
        build_seconds = time.perf_counter() - t0
        build_log = "".join(text for _, text, _ in logs)
        for obj in objs:
            obj.unlink(missing_ok=True)
        for cmd, text, rc in logs:
            if rc != 0:
                raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{text}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _lib = lib
    return lib


def ptr(t: torch.Tensor | None):
    """Device pointer of a tensor as a ctypes argument (None for no tensor)."""
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def stream_ptr(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def check_tensor(t: torch.Tensor, name: str, shape, dtype=None, device=None):
    """Raise unless t has the shape, dtype, device and contiguity a kernel
    takes."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if dtype is not None and t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
