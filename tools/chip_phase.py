#!/usr/bin/env python3
"""Run one phase of chip_smoke.py alone on the card.

    python3 tools/chip_phase.py PHASE

PHASE names a function of chip_smoke.py that takes (torch, pt, dev), e.g.
phase_slice13bc (phase 14), phase_slice13a (13), phase_adaptivity (12),
phase_algebraic (11), phase_stokes (10), or one of their sub-phases
(mixed_cubes, adjoint_runs, ...). Prints the card's name and power limit
first and the phase's seconds last; builds no kernel, so it suits the
phases that launch none (10, 12, 14) and phase_parallel (15), which builds
the kernel library itself before its ranks load it.
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main():
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs
    import dune_pdelab_tpu_torch as pt

    if not torch.cuda.is_available():
        raise SystemExit("chip_phase: no CUDA device")
    cs.CARD = cs.card_line()
    print(cs.CARD, torch.__version__, torch.version.cuda, flush=True)
    t0 = time.perf_counter()
    getattr(cs, sys.argv[1])(torch, pt, torch.device("cuda"))
    print(f"{sys.argv[1]}: {time.perf_counter() - t0:.2f} s", flush=True)


if __name__ == "__main__":
    main()
