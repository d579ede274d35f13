"""Small shared utilities: dtype and device policy, timers, integer helpers.

PyTorch port of dune_pdelab_tpu/utils/common.py (reference:
dune/pdelab/common/clock.hh:17, common/benchmarkhelper.hh:51).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch

# Index dtype of DOF / element index tensors. The reference takes int32 (the
# TPU's fast path); torch's gathers and scatters (index_select, index_add_,
# advanced indexing) take int64, so the port's maps are int64.
INDEX_DTYPE = torch.int64


def default_float() -> torch.dtype:
    """Framework default real dtype: torch's default dtype.

    There is no global x64 switch; callers that want fp64 (the parity mode
    of the tests) pass `dtype=torch.float64` explicitly.
    """
    return torch.get_default_dtype()


_DEFAULT_DEVICE = None   # None: the card, torch.device("cuda")


def default_device() -> torch.device:
    """Where the port's entry points put their tensors when the caller
    names no device: the card (`torch.device("cuda")`) unless
    `set_default_device` chose another. There is no CPU fallback: on a
    machine without a card, torch raises at the first CUDA tensor."""
    return (torch.device("cuda") if _DEFAULT_DEVICE is None
            else _DEFAULT_DEVICE)


def set_default_device(dev) -> None:
    """Choose the device `default_device()` returns (e.g. "cpu" for the
    CPU tests); None restores the card."""
    global _DEFAULT_DEVICE
    _DEFAULT_DEVICE = None if dev is None else torch.device(dev)


def resolve_device(device) -> torch.device:
    """`device` as a torch.device, `default_device()` for None."""
    return default_device() if device is None else torch.device(device)


def full_fp32_on_cuda() -> None:
    """Keep fp32 contractions in full fp32 on the card.

    TF32 keeps about three decimal digits; the reference found that
    reduced-precision contractions silently corrupt assembled operators
    (dune_pdelab_tpu/assembly/gridoperator.py:250-259). Called where the
    port first touches CUDA (assembly contexts, kernel library load).
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def plain_tensors():
    """A context in which tensors are made outside torch.func's
    transforms. A device cache filled at its first use inside a jvp or vjp
    would otherwise hold that transform's wrappers, which escape their
    level at a later call (the general-jvp apply is transposed twice inside
    nested vjps on the CPU: solvers/linear.py transposed_twice)."""
    return torch._C._DisableFuncTorch()


def device_key(device) -> torch.device:
    """The one cache key of a device: "cuda", "cuda:0" and
    torch.device("cuda", 0) all give torch.device("cuda", 0) (an unindexed
    CUDA device is the current one). Strings of devices differ ("cuda" vs
    "cuda:0"), and a cache keyed on them builds its tensors twice."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device()
                         if torch.cuda.is_initialized() else 0)
    return d


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass
class Timer:
    """Wall-clock span timer (Dune::Timer analog, common/clock.hh)."""

    _start: float = field(default_factory=time.perf_counter)

    def reset(self) -> None:
        self._start = time.perf_counter()

    def elapsed(self) -> float:
        return time.perf_counter() - self._start


@dataclass
class TimingReport:
    """Named start/stop timings with per-name accumulation.

    Analog of BenchmarkHelper (common/benchmarkhelper.hh:51-120): named
    phases, per-run statistics. Host clock: a caller timing device work
    synchronises before `stop`.
    """

    timings: dict = field(default_factory=dict)
    _open: dict = field(default_factory=dict)

    def start(self, name: str) -> None:
        self._open[name] = time.perf_counter()

    def stop(self, name: str) -> float:
        dt = time.perf_counter() - self._open.pop(name)
        self.timings.setdefault(name, []).append(dt)
        return dt

    def total(self, name: str) -> float:
        return sum(self.timings.get(name, ()))

    def summary(self) -> dict:
        return {
            k: {"n": len(v), "total": sum(v), "min": min(v), "max": max(v)}
            for k, v in self.timings.items()
        }
