#!/usr/bin/env python3
"""Run phases of chip_smoke.py alone on the card, in the order given.

    python3 tools/chip_phase.py PHASE [PHASE ...]

Each PHASE names a function of chip_smoke.py that takes (torch, pt, dev), e.g.
phase_slice13bc (phase 14), phase_slice13a (13), phase_adaptivity (12),
phase_algebraic (11), phase_stokes (10), or one of their sub-phases
(mixed_cubes, adjoint_runs, ...). Prints the card's name and power limit
first and each phase's seconds after it; builds no kernel up front (a
wrapper builds the library at its first launch), so it suits the
phases that launch none (10, 12, 14) and phase_parallel (15), which builds
the kernel library itself before its ranks load it.
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main():
    if len(sys.argv) < 2:
        raise SystemExit(__doc__)
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs
    import dune_pdelab_tpu_torch as pt

    if not torch.cuda.is_available():
        raise SystemExit("chip_phase: no CUDA device")
    cs.CARD = cs.card_line()
    print(cs.CARD, torch.__version__, torch.version.cuda, flush=True)
    for name in sys.argv[1:]:
        t0 = time.perf_counter()
        getattr(cs, name)(torch, pt, torch.device("cuda"))
        print(f"{name}: {time.perf_counter() - t0:.2f} s", flush=True)


if __name__ == "__main__":
    main()
