#!/usr/bin/env python3
"""Example 08's window-sharded Stokes solve (Taylor-Hood 8^2, 8 gloo ranks
on one device) with its two J.v implementations, timed in one rank pool.

- "flat": `WindowShardedGridOperator.jacobian_apply` on full vectors: each
  rank reads its window from them, its local J.v replayed from a CUDA graph
  on the card, and one all-gather sums the windows;
- "padded": the same J.v through the padded path on the same full vectors
  (`device_put`, the halo exchange and combine of `jacobian_apply_padded`
  at a linearization computed once, then `gather`).

Both run the example's Jacobi-GMRES(150) for `--iters` iterations, in the
order flat, padded, padded, flat. Then the seconds of each of the flat
path's first six calls at a linearization point and at a second one (the
first call eager, the second capturing the CUDA graph, the others replays).

    python3 tools/ex08_japply.py [--iters 300] [--device cpu]

Prints the card's name and power limit, then one JSON line.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def _operator(group, cells):
    import torch

    import dune_pdelab_tpu_torch as pt
    from dune_pdelab_tpu_torch.examples import ex08_windowed_stokes_parallel as ex08
    from dune_pdelab_tpu_torch.parallel.windowed import WindowShardedGridOperator

    dev = pt.default_device()
    _, W, go = ex08.setup(cells, dev)
    wgo = WindowShardedGridOperator(go, group=group, device=dev)
    x0 = W.zero(torch.float64, dev)
    return dev, go, wgo, x0


def _sync(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def gmres_task(group, variant, cells, iters):
    """One rank: `iters` GMRES iterations on the chosen J.v; its seconds,
    iterations and communication."""
    import torch

    from dune_pdelab_tpu_torch.linalg.krylov import restarted_gmres
    from dune_pdelab_tpu_torch.parallel import comm

    dev, go, wgo, x0 = _operator(group, cells)
    b = wgo.residual(x0)
    diag = go.jacobian_diagonal(x0)
    dsafe = torch.where(torch.abs(diag) > 1e-12, diag, torch.ones_like(diag))
    if variant == "flat":
        def A(p):
            return wgo.jacobian_apply(x0, p)
    else:
        lin = wgo._linearization(wgo.device_put(x0))

        def A(p):
            return wgo.gather(wgo._japply(lin, wgo.device_put(p), 0.0))
    comm.reset_stats()
    _sync(dev)
    t0 = time.perf_counter()
    z, stats = restarted_gmres(A, b, M=lambda r: r / dsafe, tol=1e-7, maxiter=iters,
                               restart=150)
    _sync(dev)
    s = time.perf_counter() - t0
    st = comm.stats()
    return {"seconds": s, "iterations": int(stats.iterations),
            "comm_calls": {k: v["calls"] for k, v in st.items()},
            "comm_seconds": sum(v["seconds"] for v in st.values()),
            "z_norm": float(torch.linalg.norm(z))}


def capture_task(group, cells, calls):
    """One rank: the seconds of each flat J.v call at a linearization point
    (the first eager, the second captures the graph, later ones replay),
    at x0 and then at a new point x1."""
    import torch

    dev, go, wgo, x0 = _operator(group, cells)
    g = torch.Generator().manual_seed(5)
    z = torch.randn(x0.numel(), generator=g, dtype=torch.float64).to(dev)
    x1 = x0 + 1e-3 * torch.randn(x0.numel(), generator=g, dtype=torch.float64).to(dev)
    out = {}
    for tag, x in (("x0", x0), ("x1", x1)):
        secs = []
        for _ in range(calls):
            _sync(dev)
            t0 = time.perf_counter()
            wgo.jacobian_apply(x, z)
            _sync(dev)
            secs.append(time.perf_counter() - t0)
        out[tag] = secs
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=300)
    ap.add_argument("--cells", type=int, default=8)
    ap.add_argument("--device", default=None, help="'cpu' for the CPU (default: the card)")
    a = ap.parse_args()
    import torch

    from dune_pdelab_tpu_torch.parallel.launch import RankPool

    if a.device is None:
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              check=True).stdout.strip().splitlines()[0]
    else:
        card = f"device {a.device}"
    print(card, flush=True)
    runs = []
    with RankPool(8, backend="gloo", device=a.device, timeout=900) as pool:
        for variant in ("flat", "padded", "padded", "flat"):
            res = pool.run(gmres_task, variant, a.cells, a.iters)
            r0 = res[0]
            runs.append({"variant": variant, **r0,
                         "ms_per_iteration": 1e3 * r0["seconds"] / max(r0["iterations"], 1),
                         "slowest_rank_s": max(r["seconds"] for r in res),
                         "same_result_on_ranks": len({r["z_norm"] for r in res}) == 1})
            print(json.dumps(runs[-1]), flush=True)
        cap = pool.run(capture_task, a.cells, 6)[0]
    print(json.dumps({"card": card, "torch": torch.__version__,
                      "cells": a.cells, "iters": a.iters, "runs": runs,
                      "flat_call_seconds": cap}))


if __name__ == "__main__":
    main()
