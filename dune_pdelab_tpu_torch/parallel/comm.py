"""Collective and neighbourwise communication on torch.distributed.

PyTorch port of dune_pdelab_tpu/parallel/comm.py, the analog of the
reference's two channels (SURVEY.md section 2.9): dune-grid neighbourwise
`communicate(DataHandle, ...)` with Add/Copy/Min/Max policies (reference:
dune/pdelab/gridfunctionspace/genericdatahandle.hh:646-790) and
`gridView().comm().sum/min/max`. Here:

  * a `Comm` wraps one process group (default: the world group; with no
    initialised group, one rank and no communication at all);
  * neighbour exchange is one `batch_isend_irecv` per exchange, at most one
    buffer per peer and direction (`Comm.sendrecv`); `exchange_planes`
    builds the plane exchange of a 1D rank chain on it, with the policy
    applied at the receiver;
  * reductions gather every rank's partial value and sum them in rank
    order, so every rank gets the same bits (`Comm.allsum`); the global dot
    (`Comm.dot`, the Krylov solvers' `dot=` hook) is reproducible: its bits
    do not depend on how the vectors are split over the ranks
    (`Comm.reproducible_sum`), so a solve takes the same iterations on any
    rank count as long as the applies agree bit for bit; `masked_dot` is
    the owner-masked disjointDot (reference:
    dune/pdelab/backend/istl/parallelhelper.hh:179).

Backends. The caller initialises the group and so chooses its backend;
nothing here switches it. NCCL moves device tensors directly. gloo's
send/recv and all_gather take host tensors, so on a gloo group a CUDA
tensor is staged: copied into a pinned host buffer without blocking, the
stream synchronised before gloo reads the buffer, and the received host
buffer copied back to the device. That is how several ranks share one card
(NCCL refuses two ranks on one device). A sharded apply that communicates
through gloo synchronises the host, so it cannot be captured into a CUDA
graph (`Comm.capturable`).

Counters. Every call that communicates adds to `STATS[kind]` (kind
"sendrecv", "allgather"): calls, bytes this rank sent, the largest single
payload in elements, and host seconds (staging included). The tests read
them to show that an apply moves halos only; `reset_stats()` clears them.
"""
from __future__ import annotations

import math
import time

import torch
import torch.distributed as dist

STATS: dict = {}

# Extraction levels of `Comm.reproducible_sum`: each keeps 52 - t bits below
# the bound (2^(t - 1) the global column count), three keep more than
# float64's 53 for any column count below 2^32.
_SUM_LEVELS = 3


def reset_stats() -> None:
    STATS.clear()


def stats() -> dict:
    """A copy of the counters: {kind: {"calls", "bytes", "largest", "seconds"}}."""
    return {k: dict(v) for k, v in STATS.items()}


def _count(kind, nbytes, nelem, seconds):
    s = STATS.setdefault(kind, {"calls": 0, "bytes": 0, "largest": 0, "seconds": 0.0})
    s["calls"] += 1
    s["bytes"] += int(nbytes)
    s["largest"] = max(s["largest"], int(nelem))
    s["seconds"] += seconds


def group_of(devices=None, group=None):
    """The process group an operator spans: `group`, else `devices` when it
    is a process group (the reference's `devices=` argument), else the
    world group (None)."""
    if group is not None:
        return group
    if devices is None or isinstance(devices, (list, tuple)):
        return None
    return devices


def rank_device(device=None) -> torch.device:
    """This rank's device: `device` when given; else the default device
    when this process chose one (`set_default_device`: parallel/launch.py
    sets each rank's, the card it works on or the CPU it was asked for);
    else cuda:(local rank % cards), the local rank read from LOCAL_RANK,
    else the global rank, else 0."""
    from dune_pdelab_tpu_torch.utils import common
    if device is not None:
        return torch.device(device)
    if common._DEFAULT_DEVICE is not None:
        return common._DEFAULT_DEVICE
    import os
    local = os.environ.get("LOCAL_RANK")
    if local is None:
        local = dist.get_rank() if dist.is_available() and dist.is_initialized() else 0
    return torch.device("cuda", int(local) % max(torch.cuda.device_count(), 1))


class Comm:
    """One process group: rank, size, backend and the operations the
    sharded operators use."""

    def __init__(self, group=None):
        self.group = group
        self.active = dist.is_available() and dist.is_initialized()
        if self.active:
            self.rank = dist.get_rank(group)
            if self.rank < 0:
                raise ValueError("this process is not a member of the process group")
            self.size = dist.get_world_size(group)
            self.backend = str(dist.get_backend(group))
        else:
            self.rank, self.size, self.backend = 0, 1, None

    def _global(self, r):
        return r if self.group is None else dist.get_global_rank(self.group, r)

    def _staged(self, t):
        return self.backend == "gloo" and t.device.type == "cuda"

    @property
    def capturable(self) -> bool:
        """Whether an apply on this group can be captured into a CUDA graph:
        only when it communicates nothing on the host (one rank)."""
        return self.size == 1

    def refuse_capture(self, what):
        """Raise (before any communication) when a CUDA graph capture is
        running and this group cannot be captured; GraphedApply then runs
        the apply eagerly."""
        if (not self.capturable and torch.cuda.is_available()
                and torch.cuda.is_current_stream_capturing()):
            raise RuntimeError(f"{what}: a {self.backend} group of {self.size} ranks "
                               "cannot be captured into a CUDA graph")

    # -- neighbour exchange ---------------------------------------------------
    def sendrecv(self, sends, recvs):
        """One neighbour exchange: sends = [(peer, tensor)], recvs = [(peer,
        buffer)] (group ranks; at most one of each per peer). Fills the
        buffers and returns them."""
        if not sends and not recvs:
            return [b for _, b in recvs]
        t0 = time.perf_counter()
        staged = [self._staged(t) for _, t in sends] + [self._staged(b) for _, b in recvs]
        host_send = []
        for _, t in sends:
            if self._staged(t):
                h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                h.copy_(t, non_blocking=True)
                host_send.append(h)
            else:
                host_send.append(t.contiguous())
        if any(staged):
            torch.cuda.current_stream().synchronize()   # before gloo reads the buffers
        host_recv = [torch.empty(b.shape, dtype=b.dtype, pin_memory=True)
                     if self._staged(b) else b for _, b in recvs]
        ops = ([dist.P2POp(dist.isend, h, self._global(p), self.group)
                for (p, _), h in zip(sends, host_send)]
               + [dist.P2POp(dist.irecv, h, self._global(p), self.group)
                  for (p, _), h in zip(recvs, host_recv)])
        for w in dist.batch_isend_irecv(ops):
            w.wait()
        out = []
        for (_, b), h in zip(recvs, host_recv):
            if h is not b:
                b.copy_(h, non_blocking=True)
            out.append(b)
        _count("sendrecv", sum(t.numel() * t.element_size() for _, t in sends),
               max([t.numel() for _, t in sends] + [0]), time.perf_counter() - t0)
        return out

    # -- collectives ----------------------------------------------------------
    def allgather(self, t):
        """[t of rank 0, t of rank 1, ...] (equal shapes) on every rank."""
        if self.size == 1:
            return [t]
        t0 = time.perf_counter()
        src = t.contiguous()
        if self._staged(src):
            src = src.to("cpu")
        out = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(out, src, group=self.group)
        if src.device != t.device:
            out = [o.to(t.device) for o in out]
        _count("allgather", t.numel() * t.element_size(), t.numel(), time.perf_counter() - t0)
        return out

    def allgather_cat(self, t, counts):
        """The concatenation of every rank's leading-dim block, blocks of
        `counts[r]` rows (padded to the largest for the gather)."""
        if self.size == 1:
            return t
        m = max(counts)
        pad = torch.zeros((m,) + tuple(t.shape[1:]), dtype=t.dtype, device=t.device)
        pad[:t.shape[0]] = t
        parts = self.allgather(pad)
        return torch.cat([p[:c] for p, c in zip(parts, counts)])

    def allsum(self, value):
        """Sum of a tensor over the ranks, in rank order: the same bits on
        every rank whatever the backend."""
        if self.size == 1:
            return value
        parts = self.allgather(value)
        total = parts[0]
        for p in parts[1:]:
            total = total + p
        return total

    def allreduce(self, value, op="sum"):
        if op == "sum":
            return self.allsum(value)
        if op not in ("min", "max"):
            raise ValueError(op)
        if self.size == 1:
            return value
        stacked = torch.stack(self.allgather(value))
        return stacked.amin(0) if op == "min" else stacked.amax(0)

    def dot(self, a, b):
        """Global dot of rank-local blocks with disjoint ownership (the
        Krylov `dot=` hook), reproducible: the same bits for any partition
        of the vectors over any number of ranks (`reproducible_sum` of the
        products), so every rank count takes the iterations of one rank."""
        p = torch.conj(a.reshape(-1)).to(_wide(a.dtype)) * b.reshape(-1).to(_wide(b.dtype))
        rows = torch.stack([p.real, p.imag]) if p.is_complex() else p[None]
        out = self.reproducible_sum(rows)
        if p.is_complex():
            out = torch.complex(out[0], out[1])
        else:
            out = out[0]
        return out.to(torch.result_type(a, b))

    def reproducible_sum(self, rows):
        """Row sums of a real float64 (k, n_local) tensor over every rank's
        columns, independent of how the columns are split (and of the order
        of any sum). Each level extracts q = (sigma + r) - sigma, the part
        of r on the grid of ulp(sigma) with sigma = 1.5 * 2^(e + t), 2^e
        bounding |r| and 2^(t - 1) the global column count: every sum of
        the q is exact in float64, in any order (Demmel and Nguyen's
        reproducible summation), and the next of `_SUM_LEVELS` levels sums
        what is left. Two
        small all-gathers (the bound, the level sums)."""
        k, n = rows.shape
        head = torch.cat([rows.abs().amax(dim=1) if n else rows.new_zeros(k),
                          rows.new_full((1,), float(n))])
        heads = torch.stack(self.allgather(head))
        bound, count = heads[:, :k].amax(dim=0), heads[:, k].sum()
        if not bool(torch.isfinite(bound).all()):
            return rows.new_full((k,), float("nan"))
        t = int(math.ceil(math.log2(max(float(count), 2.0)))) + 1
        e = torch.ceil(torch.log2(torch.where(bound > 0, bound, 1.0)))[:, None]
        r = rows
        sums = []
        for _ in range(_SUM_LEVELS):
            sigma = 1.5 * torch.exp2(e + t)
            q = (sigma + r) - sigma
            r = r - q
            sums.append(q.sum(dim=1))
            e = e + t - 52
        total = self.allsum(torch.stack(sums))          # exact: any order
        out = total[0]
        for lev in range(1, _SUM_LEVELS):
            out = out + total[lev]
        return out


def allreduce(value, group=None, op: str = "sum"):
    """comm().sum/min/max analog: `value` reduced over the group, the same
    on every rank."""
    return Comm(group).allreduce(value, op)


def exchange_planes(local, group=None, policy: str = "copy"):
    """Neighbourwise halo exchange along a 1D chain of the group's ranks.

    local: (nloc, ...) slab; returns (recv_prev, recv_next), the neighbour
    boundary planes (zeros at the chain ends). 'copy' and 'add' deliver
    them (the caller accumulates for 'add'; AddDataHandle); 'min'/'max'
    combine them with the own border planes."""
    comm = Comm(group)
    r, n = comm.rank, comm.size
    prev, nxt = torch.zeros_like(local[:1]), torch.zeros_like(local[-1:])
    sends, recvs = [], []
    if r > 0:
        sends.append((r - 1, local[:1]))
        recvs.append((r - 1, prev))
    if r < n - 1:
        sends.append((r + 1, local[-1:]))
        recvs.append((r + 1, nxt))
    comm.sendrecv(sends, recvs)
    if policy in ("copy", "add"):
        return prev, nxt
    if policy == "min":
        return torch.minimum(prev, local[:1]), torch.minimum(nxt, local[-1:])
    if policy == "max":
        return torch.maximum(prev, local[:1]), torch.maximum(nxt, local[-1:])
    raise ValueError(policy)


def masked_dot(a, b, owner_mask, group=None):
    """Owner-unique dot product for overlapping decompositions: each DOF is
    counted by exactly one rank (disjointDot + allreduce analog)."""
    return Comm(group).dot(torch.where(owner_mask, a, 0.0), b)


def _wide(dtype):
    """The dtype products are formed in: float64 (complex128), exact for
    float32 factors."""
    return torch.complex128 if dtype.is_complex else torch.float64


class _Replicated(torch.autograd.Function):
    @staticmethod
    def forward(t, comm):
        return t.clone()

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.comm = inputs[1]

    @staticmethod
    def jvp(ctx, t_t, *_):
        return t_t

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.allsum(g), None


def replicated(theta, group=None):
    """theta (a tensor or a tuple/dict of tensors), marked as one value held
    by every rank of the group: the identity forward, and backward the
    cotangent summed over the ranks in rank order. This is the sum JAX's
    shard_map inserts for a replicated input of a sharded computation: a
    parameter that a sharded residual's local operator closes over gets
    each rank's share of its gradient from that rank's elements only, and
    marking it makes the gradient count every rank."""
    from torch.utils._pytree import tree_map
    comm = Comm(group)
    if comm.size == 1:
        return theta
    return tree_map(lambda t: _Replicated.apply(t, comm) if isinstance(t, torch.Tensor)
                    else t, theta)
