"""Verbosity-tagged logging with process/host tags.

PyTorch port of dune_pdelab_tpu/utils/logging.py (reference:
dune/pdelab/common/logtag.hh:62-172 rank/host log prefixes, and the
rank-0-gated verbosity printing of the drivers, e.g.
instationary/implicitonestep.hh:79-81). The rank is torch.distributed's
when a process group is initialised, else 0.
"""
from __future__ import annotations

import socket
import sys
import time

import torch.distributed as dist


def _rank() -> int:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


class Logger:
    """Leveled logger; messages at level > verbosity are dropped. In
    multi-process runs only rank 0 prints unless all_ranks=True."""

    def __init__(self, verbosity: int = 1, tag: str | None = None,
                 stream=None, all_ranks: bool = False):
        self.verbosity = verbosity
        self.stream = stream or sys.stdout
        self.all_ranks = all_ranks
        self._t0 = time.perf_counter()
        if tag is None:
            tag = f"{socket.gethostname()}:{_rank()}"
        self.tag = tag

    def _enabled(self, level: int) -> bool:
        if level > self.verbosity:
            return False
        return self.all_ranks or _rank() == 0

    def log(self, level: int, msg: str):
        if self._enabled(level):
            dt = time.perf_counter() - self._t0
            self.stream.write(f"[{self.tag} {dt:9.3f}s] {msg}\n")

    def info(self, msg: str):
        self.log(1, msg)

    def detail(self, msg: str):
        self.log(2, msg)

    def debug(self, msg: str):
        self.log(3, msg)

    def phase(self, name: str, level: int = 1):
        """Context manager timing a named phase (Dune::Timer span analog)."""
        logger = self

        class _Phase:
            def __enter__(self):
                self.t0 = time.perf_counter()
                return self

            def __exit__(self, *exc):
                logger.log(level,
                           f"{name}: {time.perf_counter() - self.t0:.3f}s")

        return _Phase()
