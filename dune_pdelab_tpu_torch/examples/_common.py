"""Shared plumbing of the example scripts: the device and dtype a run works
in, its output directory and the command line."""
from __future__ import annotations

import argparse
import contextlib
import os
import tempfile

import torch

from dune_pdelab_tpu_torch.utils import common


@contextlib.contextmanager
def on_device(device, dtype):
    """Run a block with `device` as the default device (the card for None)
    and `dtype` as torch's default dtype; both are restored afterwards. On
    the card fp32 contractions stay in full fp32 (no TF32)."""
    dev = common.resolve_device(device)
    saved_dev, saved_dtype = common._DEFAULT_DEVICE, torch.get_default_dtype()
    if dev.type == "cuda":
        common.full_fp32_on_cuda()
    common.set_default_device(dev)
    torch.set_default_dtype(dtype)
    try:
        yield dev
    finally:
        common._DEFAULT_DEVICE = saved_dev
        torch.set_default_dtype(saved_dtype)


def out_directory(out_dir, name):
    """`out_dir` (made if missing), or a fresh temporary directory for this
    run."""
    if out_dir is None:
        return tempfile.mkdtemp(prefix=f"{name}_")
    os.makedirs(out_dir, exist_ok=True)
    return out_dir


def parser(doc, name):
    """The options every example takes: --device and --out."""
    ap = argparse.ArgumentParser(prog=f"python -m dune_pdelab_tpu_torch.examples.{name}",
                                 description=(doc or "").split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs on the CPU)")
    ap.add_argument("--out", default=None,
                    help="directory for the output files (default: a fresh temporary one)")
    return ap


def finish(res):
    """The last line of every example."""
    print("OK")
    return res


def sync(dev):
    """Wait for the card's queued work (a no-op on the CPU), for timings."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def comm_summary(seconds):
    """This rank's communication since the last reset: seconds, calls and
    bytes over all kinds, beside the `seconds` of the work they served."""
    from dune_pdelab_tpu_torch.parallel import comm
    st = comm.stats().values()
    return {"seconds": sum(v["seconds"] for v in st), "calls": sum(v["calls"] for v in st),
            "bytes": sum(v["bytes"] for v in st), "of_seconds": seconds}


RANKS = 8       # the multi-rank examples' gloo ranks (the reference's 8 devices)


def rank_pool(device, nranks=RANKS):
    """The ranks of a multi-rank example: processes in one gloo group, each
    on the run's device (the card unless the run is on the CPU)."""
    from dune_pdelab_tpu_torch.parallel.launch import RankPool
    return RankPool(nranks, backend="gloo",
                    device="cpu" if common.resolve_device(device).type == "cpu" else None)
