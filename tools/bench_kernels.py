#!/usr/bin/env python3
"""Time stencil27 and structured_fused of a checkout of the port on the card.

    python3 tools/bench_kernels.py [--root DIR]

Times the port found in checkout DIR (default: the checkout holding this
file), so that two commits can be timed in one run on one card: unpack the
other commit into a directory and pass it as --root. The timers, problems
and operator set-up are those of this checkout's chip_smoke.py; the checks
against the plain versions are its phase 2. Each time is CUDA events around
a loop of launches and, below 10^7 points, also around one CUDA graph of
launches, which shows the device's time where the host's per-call cost
would hide it. Shapes, fp32:
  stencil27: every LatticeGMG level of a 512^3-cell solve (513^3 down to
    5^3 DOFs), the fused-CG main path's 512^3, 3^3 and 67x45x33;
  structured_fused, field A: J.v at every VarCoeffGMG level of a
    512^3-cell solve (512^3 down to 8^3 cells) and the residual at 512^3.
Prints the card's name and power limit, the ptxas registers and spills of
the build, and one JSON line per measurement.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
STENCIL_DIMS = [(513,) * 3, (257,) * 3, (129,) * 3, (65,) * 3, (33,) * 3, (17,) * 3,
                (9,) * 3, (5,) * 3, (512,) * 3, (3, 3, 3), (67, 45, 33)]
FUSED_CELLS = [512, 256, 128, 64, 32, 16, 8]


def reps_for(n):
    return 20 if n > 10**7 else (200 if n > 10**5 else 1000)


def emit(**kw):
    print(json.dumps(kw), flush=True)


def bench_stencil(torch, np, cs, sk, dev):
    rng = np.random.default_rng(5)
    for dims in STENCIL_DIMS:
        n = math.prod(dims)
        mask = cs.faces_grid(torch, dims, dev).reshape(-1)
        w27 = 0.1 * rng.standard_normal((3, 3, 3))
        z = torch.as_tensor(rng.standard_normal(n), dtype=torch.float32, device=dev)

        def run():
            return sk.stencil27(z, mask, w27, dims)
        rec = {"kernel": "stencil27", "dims": list(dims), "dtype": "float32",
               "ms": cs.cuda_ms(torch, run, reps_for(n))}
        if n <= 10**7:
            rec["graph_ms"] = cs.graph_ms(torch, run, 200)
        emit(**rec)
        del z
        torch.cuda.empty_cache()


def bench_fused(torch, np, cs, pt, sfk, dev):
    from dune_pdelab_tpu_torch.assembly.structured_fused import (
        make_fused_japply, make_fused_residual)
    rng = np.random.default_rng(9)
    cases = [((c,) * 3, True) for c in FUSED_CELLS] + [((512,) * 3, False)]
    for cells, japply in cases:
        V, cgm, _, go = cs.q1_operator(torch, pt, cs.field_a_problem(), cells, dev)
        op = (make_fused_japply if japply else make_fused_residual)(go)
        tab, coef = op.state(torch.float32, dev)
        mask = cgm.mask_on(dev)
        x = torch.as_tensor(rng.standard_normal(V.ndofs), dtype=torch.float32, device=dev)

        def run():
            return sfk.structured_fused(x, mask, tab, coef, op.dims, japply)
        rec = {"kernel": "structured_fused", "cells": list(cells), "dtype": "float32",
               "problem": "field-A", "mode": "japply" if japply else "residual",
               "nqp": int(tab.shape[0]), "ms": cs.cuda_ms(torch, run, reps_for(V.ndofs) // 2)}
        if V.ndofs <= 10**7:
            rec["graph_ms"] = cs.graph_ms(torch, run, 100)
        emit(**rec)
        del x, tab, coef, mask, op, go
        torch.cuda.empty_cache()


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(HERE))
    root = Path(ap.parse_args().root).resolve()
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs                  # this checkout's helpers
    sys.path.insert(0, str(root))            # the timed checkout's package
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("bench_kernels: no CUDA device")
    import dune_pdelab_tpu_torch as pt
    from dune_pdelab_tpu_torch.kernels import _build
    from dune_pdelab_tpu_torch.kernels import stencil27 as sk
    from dune_pdelab_tpu_torch.kernels import structured_fused as sfk
    if Path(pt.__file__).resolve().parents[1] != root:
        raise SystemExit(f"bench_kernels: imported {pt.__file__}, not from {root}")
    t0 = time.perf_counter()
    _build.library()
    emit(root=str(root), card=cs.card_line(), build_s=time.perf_counter() - t0)
    for name, regs, spill in cs.ptxas_report(_build.build_log):
        emit(ptxas=name, registers=regs, spill=spill)
    dev = torch.device("cuda")
    bench_stencil(torch, np, cs, sk, dev)
    bench_fused(torch, np, cs, pt, sfk, dev)
    emit(root=str(root), done=True)


if __name__ == "__main__":
    main()
