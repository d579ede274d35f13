#!/usr/bin/env python3
"""Time stencil27, structured_fused, the DG block stencil and the DG
two-level solve of a checkout of the port on the card.

    python3 tools/bench_kernels.py [--root DIR] [--kernels LIST]

Times the port found in checkout DIR (default: the checkout holding this
file), so that two commits can be timed in one run on one card: unpack the
other commit into a directory and pass it as --root. The timers, problems
and operator set-up are those of this checkout's chip_smoke.py; the checks
against the plain versions are its phase 2 and block_err. Each time is CUDA events around
a loop of launches and, below 10^7 points, also around one CUDA graph of
launches, which shows the device's time where the host's per-call cost
would hide it. Shapes, fp32:
  stencil27: every LatticeGMG level of a 512^3-cell solve (513^3 down to
    5^3 DOFs), the fused-CG main path's 512^3, 3^3 and 67x45x33;
  structured_fused, field A: J.v at every VarCoeffGMG level of a
    512^3-cell solve (512^3 down to 8^3 cells) and the residual at 512^3;
  block_stencil_mm (K5) and block_stencil_em (K6) on SIPG weights at every
    shape chip_smoke.py launches them at: mode-major 64^3 and 128^3 Q1
    fp32 (phases 7b/7c), element-major 2048^2 Q2 fp32, 32^2 Q2 and Q1
    fp64 (config3/config7), 6^3 Q1 fp32 (compile_block_stencil's check on
    its proxy mesh) and 128^3 Q1 fp32, and the shared-memory path at
    37x29x23 Q2 and 10x8x6 Q3 fp64, each held against its plain version
    first (chip_smoke.py block_err);
  dgmg: chip_smoke.py phase 7c's DGTwoLevel PCG solve at 64^3 and 128^3 Q1
    cells, fp32: ms per iteration of DGMG_RUNS timed runs after a warm-up.
LIST is a comma-separated subset of stencil27, structured_fused,
blockstencil and dgmg (default: all four).
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
# (layout, cells, Q degree, dtype name)
BLOCK_CASES = [("mm", (64,) * 3, 1, "float32"), ("mm", (128,) * 3, 1, "float32"),
               ("em", (2048, 2048), 2, "float32"), ("em", (32, 32), 2, "float64"),
               ("em", (32, 32), 1, "float64"), ("em", (6,) * 3, 1, "float32"),
               ("em", (128,) * 3, 1, "float32"), ("em", (37, 29, 23), 2, "float64"),
               ("mm", (10, 8, 6), 3, "float64")]
DGMG_RUNS = 5
KERNELS = ("stencil27", "structured_fused", "blockstencil", "dgmg")


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


def bench_block(torch, np, cs, pt, bk, dev):
    from dune_pdelab_tpu_torch.assembly.blockstencil import compile_block_stencil
    rng = np.random.default_rng(11)
    for layout, cells, k, dtype_name in BLOCK_CASES:
        dtype = getattr(torch, dtype_name)
        _, go = cs.dg_operator(pt, cells, k, cs.unit_source_problem())
        st = compile_block_stencil(go, dtype=torch.float64, device=dev)
        W, dD = st.taps(dtype, dev)
        z = torch.as_tensor(rng.standard_normal(st.ndofs), dtype=dtype, device=dev)
        if layout == "mm":
            nx, ny, nz = cells
            z = z.reshape(nz, ny, nx, st.nb).permute(0, 3, 1, 2).contiguous()
        fn = getattr(bk, f"block_stencil_{layout}")
        ref = getattr(bk, f"block_stencil_{layout}_reference")

        def run():
            return fn(z, W, dD, cells)
        y, y_p = run(), ref(z, W, dD, cells)
        torch.cuda.synchronize()
        err = cs.block_err(f"block_stencil_{layout} {cells}", y, y_p)
        nbytes, flops = cs.block_work(cells, st.nb, z.element_size())
        rec = {"kernel": f"block_stencil_{layout}", "cells": list(cells), "k": k,
               "nb": st.nb, "dtype": dtype_name, "max_abs_err": err,
               "ms": cs.cuda_ms(torch, run, reps_for(st.ndofs)),
               **cs.bound(nbytes, flops)}
        if st.ndofs <= 10**7:
            rec["graph_ms"] = cs.graph_ms(torch, run, 200)
        emit(**rec)
        del z, y, y_p, W, dD, st, go
        torch.cuda.empty_cache()


def bench_dgmg(torch, cs, pt, dev):
    for cells in cs.DGMG_CELLS:
        it, ms = cs.dgmg_half(torch, pt, cells, dev, runs=DGMG_RUNS)
        emit(kernel="dgmg", cells=[cells] * 3, dtype="float32", iterations=it,
             ms_per_iteration=ms)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--kernels", default=",".join(KERNELS))
    args = ap.parse_args()
    root = Path(args.root).resolve()
    wanted = args.kernels.split(",")
    if not set(wanted) <= set(KERNELS):
        raise SystemExit(f"bench_kernels: --kernels takes a subset of {KERNELS}")
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs                  # this checkout's helpers
    sys.path.insert(0, str(root))            # the timed checkout's package
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("bench_kernels: no CUDA device")
    import dune_pdelab_tpu_torch as pt
    from dune_pdelab_tpu_torch.kernels import _build
    from dune_pdelab_tpu_torch.kernels import blockstencil as bk
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
    if "stencil27" in wanted:
        bench_stencil(torch, np, cs, sk, dev)
    if "structured_fused" in wanted:
        bench_fused(torch, np, cs, pt, sfk, dev)
    if "blockstencil" in wanted:
        bench_block(torch, np, cs, pt, bk, dev)
    if "dgmg" in wanted:
        bench_dgmg(torch, cs, pt, dev)
    emit(root=str(root), done=True)


if __name__ == "__main__":
    main()
