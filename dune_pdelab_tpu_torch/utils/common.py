"""Small shared utilities: dtype policy, timers, integer helpers.

PyTorch port of dune_pdelab_tpu/utils/common.py.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch


def default_float() -> torch.dtype:
    """Framework default real dtype: torch's default dtype.

    There is no global x64 switch; callers that want fp64 (the parity mode
    of the tests) pass `dtype=torch.float64` explicitly.
    """
    return torch.get_default_dtype()


def full_fp32_on_cuda() -> None:
    """Keep fp32 contractions in full fp32 on the card.

    TF32 keeps about three decimal digits; the reference found that
    reduced-precision contractions silently corrupt assembled operators
    (dune_pdelab_tpu/assembly/gridoperator.py:250-259). Called where the
    port first touches CUDA (assembly contexts, kernel library load).
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def device_key(device) -> torch.device:
    """The one cache key of a device: "cuda", "cuda:0" and
    torch.device("cuda", 0) all give torch.device("cuda", 0) (an unindexed
    CUDA device is the current one). Strings of devices differ ("cuda" vs
    "cuda:0"), and a cache keyed on them builds its tensors twice."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device()
                         if torch.cuda.is_available() else 0)
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
