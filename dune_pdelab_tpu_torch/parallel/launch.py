"""Start ranks and run a function on each: the port's counterpart of handing
`jax.devices()[:n]` to a sharded operator.

    with RankPool(4, backend="gloo", device="cpu") as pool:
        results = pool.run(fn, a, b)          # fn(group, a, b) on every rank
        first2 = pool.run(fn, a, b, nranks=2)  # on a subgroup of ranks 0, 1
        task = pool.submit(fn, a, b)           # returns at once ...
        results = task.result()                # ... and waits here

A RankPool starts n Python processes (`python -m
dune_pdelab_tpu_torch.parallel.launch`), each of which joins one process
group through a `FileStore` in a fresh temporary directory (no TCP port, so
concurrent pools never collide) and then waits for tasks. A task is a
module-level function, named by module and qualified name (a function of
the `__main__` script is found again by the script's path), and picklable
arguments; each rank calls fn(group, *args, **kwargs) and its picklable
result comes back to the caller, rank by rank. With `nranks=k` below the
pool's size the task runs on a subgroup of the first k ranks (created once
per k on every rank, `new_group`); the other ranks return None.

The caller chooses the backend ("gloo", "nccl"); nothing falls back from
one to the other. `device` sets each rank's default device ("cpu" for the
CPU tests); without it rank r takes cuda:(r % cards) and makes it current.
A child imports torch, numpy and this package, and the module of the
function it runs. A rank that raises makes `run` raise with its traceback;
the pool is then stopped (every process killed) and starts again at the
next `run`.
"""
from __future__ import annotations

import importlib
import importlib.util
import os
import pickle
import subprocess
import sys
import tempfile
import time
import traceback
from multiprocessing.connection import Connection, wait


def _spec(fn):
    """How a child finds fn again: (module, qualname) or, for a function of
    the running script, ("path", file, qualname)."""
    mod = fn.__module__
    if mod == "__main__":
        main = sys.modules["__main__"]
        return ("path", os.path.abspath(main.__file__), fn.__qualname__)
    return (mod, fn.__qualname__)


def _resolve(spec):
    if spec[0] == "path":
        _, path, qual = spec
        name = "__rank_main__"
        mod = sys.modules.get(name)
        if mod is None:
            s = importlib.util.spec_from_file_location(name, path)
            mod = importlib.util.module_from_spec(s)
            sys.modules[name] = mod
            s.loader.exec_module(mod)
    else:
        mod = importlib.import_module(spec[0])
        qual = spec[1]
    obj = mod
    for part in qual.split("."):
        obj = getattr(obj, part)
    return obj


class RankError(RuntimeError):
    """A rank raised, died or overran the timeout."""


class RankPool:
    """n rank processes in one process group, reused across tasks."""

    def __init__(self, nranks, *, backend, device=None, threads=1, timeout=900.0):
        if backend not in ("gloo", "nccl"):
            raise ValueError(f"backend must be 'gloo' or 'nccl', got {backend!r}")
        self.nranks = int(nranks)
        self.backend = backend
        self.device = None if device is None else str(device)
        self.threads = int(threads)
        self.timeout = float(timeout)
        self._procs = None

    # -- lifecycle ------------------------------------------------------------
    def _start(self):
        self._tmp = tempfile.TemporaryDirectory(prefix="dpt_ranks_")
        store = os.path.join(self._tmp.name, "store")
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(p for p in sys.path if p)
        # each rank's host math (torch's intra-op pool, and the BLAS and
        # OpenMP pools numpy and scipy start with one thread per core) runs
        # on `threads` threads: n ranks on one host must not each take
        # every core
        for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
            env[var] = str(self.threads)
        self._procs, self._to, self._from = [], [], []
        for r in range(self.nranks):
            task_r, task_w = os.pipe()
            res_r, res_w = os.pipe()
            cmd = [sys.executable, "-m", "dune_pdelab_tpu_torch.parallel.launch",
                   str(task_r), str(res_w), str(r), str(self.nranks), store,
                   self.backend, self.device or "", str(self.threads)]
            self._procs.append(subprocess.Popen(cmd, pass_fds=(task_r, res_w),
                                                env=dict(env, LOCAL_RANK=str(r))))
            os.close(task_r)
            os.close(res_w)
            self._to.append(Connection(task_w, readable=False))
            self._from.append(Connection(res_r, writable=False))

    def close(self):
        """Stop every rank (politely, then by force)."""
        if self._procs is None:
            return
        for c in self._to:
            try:
                c.send(("stop",))
            except OSError:
                pass
        deadline = time.monotonic() + 10
        for p in self._procs:
            try:
                p.wait(max(deadline - time.monotonic(), 0.1))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        for c in self._to + self._from:
            c.close()
        self._tmp.cleanup()
        self._procs = None

    def _kill(self):
        for p in self._procs:
            p.kill()
        for p in self._procs:
            p.wait()
        for c in self._to + self._from:
            c.close()
        self._tmp.cleanup()
        self._procs = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- tasks ----------------------------------------------------------------
    def submit(self, fn, *args, nranks=None, **kwargs):
        """Start fn(group, *args, **kwargs) on each of the first `nranks`
        ranks (default all) and return at once; `.result()` waits for the
        ranks' results, rank 0 first. One task at a time."""
        k = self.nranks if nranks is None else int(nranks)
        if not 1 <= k <= self.nranks:
            raise ValueError(f"nranks={k} outside 1..{self.nranks}")
        if self._procs is None:
            self._start()
        msg = ("run", _spec(fn), args, kwargs, k)
        for c in self._to:
            c.send(msg)
        return _Pending(self, k)

    def run(self, fn, *args, nranks=None, **kwargs):
        """fn(group, *args, **kwargs) on each of the first `nranks` ranks
        (default all); returns their results, rank 0 first."""
        return self.submit(fn, *args, nranks=nranks, **kwargs).result()

    def _collect(self, k):
        results = [None] * self.nranks
        pending = dict(enumerate(self._from))
        deadline = time.monotonic() + self.timeout
        while pending:
            ready = wait(list(pending.values()), timeout=max(deadline - time.monotonic(), 0))
            if not ready:
                self._kill()
                raise RankError(f"ranks {sorted(pending)} did not finish within "
                                f"{self.timeout} s")
            for c in ready:
                r = next(i for i, cc in pending.items() if cc is c)
                try:
                    status, value = c.recv()
                except (EOFError, OSError):
                    code = self._procs[r].poll()
                    self._kill()
                    raise RankError(f"rank {r} died (exit code {code})") from None
                del pending[r]
                if status != "ok":
                    self._kill()
                    raise RankError(f"rank {r} raised:\n{value}")
                results[r] = value
        return results[:k]


class _Pending:
    """A task started by RankPool.submit."""

    def __init__(self, pool, k):
        self._pool, self._k, self._out = pool, k, None

    def result(self):
        if self._out is None:
            self._out = self._pool._collect(self._k)
        return self._out


def _child(task_fd, res_fd, rank, world, store, backend, device, threads):
    import torch
    import torch.distributed as dist

    from dune_pdelab_tpu_torch.utils.common import set_default_device

    tasks = Connection(task_fd, writable=False)
    results = Connection(res_fd, readable=False)
    torch.set_num_threads(threads)
    if device:
        set_default_device(device)
    else:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        set_default_device(dev)
    dist.init_process_group(backend, store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    groups = {world: None}
    while True:
        try:
            msg = tasks.recv()
        except EOFError:
            break
        if msg[0] == "stop":
            break
        _, spec, args, kwargs, k = msg
        try:
            if k not in groups:
                groups[k] = dist.new_group(list(range(k)))
            out = (_resolve(spec)(groups[k], *args, **kwargs) if rank < k else None)
            reply = ("ok", out)
            pickle.dumps(reply)
        except BaseException:
            reply = ("err", traceback.format_exc())
        results.send(reply)
    dist.destroy_process_group()


if __name__ == "__main__":
    a = sys.argv[1:]
    _child(int(a[0]), int(a[1]), int(a[2]), int(a[3]), a[4], a[5], a[6], int(a[7]))
