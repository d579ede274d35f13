"""Checkpoint / resume of solver and time-stepper state.

PyTorch port of dune_pdelab_tpu/utils/checkpoint.py, in the reference's own
file format, so that either package restores the other's checkpoints: an
atomically written `.npz` of numpy arrays with a `__meta__` entry holding
a JSON manifest as uint8 bytes. Tensors are saved from wherever they lie
(the card included) as their numpy values and loaded onto `device`
(default: utils/common.default_device()) with their stored dtype, or
`dtype` when given, bit for bit. The reference has no checkpointing (its
nearest mechanisms are solution transfer across adaptation and load
balancing); all state here is flat arrays and scalars.
"""
from __future__ import annotations

import json
import os
import tempfile

import numpy as np
import torch

from dune_pdelab_tpu_torch.utils.common import resolve_device


def _to_numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def save_checkpoint(path: str, arrays: dict, meta: dict | None = None):
    """Atomically write arrays (+ JSON-serializable meta) to `path`.npz."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    payload = {k: _to_numpy(v) for k, v in arrays.items()}
    payload["__meta__"] = np.frombuffer(
        json.dumps(meta or {}).encode(), dtype=np.uint8)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    os.close(fd)
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **payload)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def load_checkpoint(path: str, dtype=None, device=None):
    """Returns (arrays dict of tensors on `device`, meta dict)."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    device = resolve_device(device)
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode()) if "__meta__" in z else {}
        arrays = {k: torch.as_tensor(z[k], dtype=dtype, device=device)
                  for k in z.files if k != "__meta__"}
    return arrays, meta


class CheckpointManager:
    """Numbered checkpoint sequence with retention: `keep` newest files."""

    def __init__(self, directory: str, prefix: str = "ckpt", keep: int = 3):
        self.dir = directory
        self.prefix = prefix
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.dir, f"{self.prefix}-{step:09d}.npz")

    def save(self, step: int, arrays: dict, meta: dict | None = None):
        meta = dict(meta or {})
        meta["step"] = step
        save_checkpoint(self._path(step), arrays, meta)
        self._prune()
        return self._path(step)

    def steps(self):
        out = []
        for f in os.listdir(self.dir):
            if f.startswith(self.prefix + "-") and f.endswith(".npz"):
                try:
                    out.append(int(f[len(self.prefix) + 1:-4]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self):
        s = self.steps()
        return s[-1] if s else None

    def restore(self, step: int | None = None, dtype=None, device=None):
        step = step if step is not None else self.latest_step()
        if step is None:
            return None, None
        return load_checkpoint(self._path(step), dtype, device)

    def _prune(self):
        s = self.steps()
        for old in s[: max(0, len(s) - self.keep)]:
            os.unlink(self._path(old))
