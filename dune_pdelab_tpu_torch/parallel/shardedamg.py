"""Distributed smoothed-aggregation AMG: the parallel-AMG analog.

PyTorch port of dune_pdelab_tpu/parallel/shardedamg.py (reference:
dune/pdelab/backend/istl/novlpistlsolverbackend.hh:330-1128 NOVLP AMG,
ovlpistlsolverbackend.hh parallel AMG, parallelhelper.hh:273-440):

  * every level's matrices (A_l, R_l, P_l) are row-partitioned over the
    ranks in contiguous blocks of ceil(n / nranks) rows; a rank keeps its
    rows in the sequential cycle's padded-ELL layout (same columns, same
    order, same width), its columns renumbered into a window, the sorted
    set of columns its rows touch. The window's values arrive by one
    neighbour exchange from their owners per SpMV (the windowed
    operator's scheme, parallel/windowed.py, on raw CSR rows): the
    communication of an SpMV is O(window), never a full vector;
  * the dense coarse solve is gathered: one all-gather of the coarse
    residual (O(n_coarse)) per cycle, solved redundantly on every rank
    with the sequential LU, each rank keeping its rows;
  * the cycle is AlgebraicMultigrid's own (linalg/amg.py `_vcycle`,
    damped Jacobi or Chebyshev), so outputs match the sequential V-cycle
    to rounding and preconditioned-CG iteration counts match.
"""
from __future__ import annotations

import numpy as np
import torch

from dune_pdelab_tpu_torch.linalg.krylov import cg as _cg
from dune_pdelab_tpu_torch.parallel.comm import Comm, group_of, rank_device
from dune_pdelab_tpu_torch.utils.common import device_key


def _pad_rows(n, ndev):
    """Contiguous row partition: rank d owns rows [d*B, min((d+1)*B, n))."""
    return -(-n // ndev)


def _ell(A, k):
    """A CSR matrix as ELL (cols, vals, real) of width k in CSR order
    (AlgebraicMultigrid's layout); `real` marks the stored entries."""
    A = A.tocsr()
    A.sum_duplicates()
    n = A.shape[0]
    counts = np.diff(A.indptr)
    cols = np.zeros((n, k), np.int64)
    vals = np.zeros((n, k), np.float64)
    real = np.zeros((n, k), bool)
    r = np.repeat(np.arange(n), counts)
    pos = np.arange(A.nnz) - np.repeat(A.indptr[:-1], counts)
    cols[r, pos] = A.indices
    vals[r, pos] = A.data
    real[r, pos] = True
    return cols, vals, real


class _ShardedCSR:
    """This rank's rows of a row-partitioned matrix in window columns, and
    the exchange plan that fills the window."""

    def __init__(self, A, k, row_B, col_B, comm):
        ndev, me = comm.size, comm.rank
        self.comm = comm
        n_rows, n_cols = A.shape
        cols, vals, real = _ell(A, k)
        wins = []
        for d in range(ndev):
            r0, r1 = d * row_B, min((d + 1) * row_B, n_rows)
            wins.append(np.unique(cols[r0:r1][real[r0:r1]]))
        r0, r1 = me * row_B, min((me + 1) * row_B, n_rows)
        win = wins[me]
        self.W = len(win)
        lc = np.where(real[r0:r1], np.searchsorted(win, cols[r0:r1]), self.W)   # trash slot
        self.cols = lc
        self.vals = vals[r0:r1]

        wo = np.minimum(win // col_B, ndev - 1)
        mine = np.nonzero(wo == me)[0]
        self.own_pos, self.own_idx = mine, win[mine] - me * col_B
        self.recv = [(int(o), np.nonzero(wo == o)[0]) for o in np.unique(wo) if o != me]
        self.send = []
        for p in range(ndev):
            if p == me:
                continue
            wp = wins[p]
            rows = wp[np.minimum(wp // col_B, ndev - 1) == me] - me * col_B
            if len(rows):
                self.send.append((p, rows))
        self._dev = {}

    def tensors(self, dtype, device):
        key = (dtype, device_key(device))
        if key not in self._dev:
            def t(a, dt=None):
                return torch.as_tensor(a, dtype=dt, device=device)
            self._dev[key] = {
                "cols": t(self.cols), "vals": t(self.vals, dtype),
                "own_pos": t(self.own_pos), "own_idx": t(self.own_idx),
                "recv": [t(p) for _, p in self.recv], "send": [t(r) for _, r in self.send]}
        return self._dev[key]

    def window(self, x):
        """Owned column block -> window values (W + 1,; the last a zero)."""
        T = self.tensors(x.dtype, x.device)
        w = torch.zeros(self.W + 1, dtype=x.dtype, device=x.device)
        w[T["own_pos"]] = x[T["own_idx"]]
        sends = [(p, x[i]) for (p, _), i in zip(self.send, T["send"])]
        recvs = [(o, torch.empty(len(pos), dtype=x.dtype, device=x.device))
                 for o, pos in self.recv]
        self.comm.sendrecv(sends, recvs)
        for (_, buf), pos in zip(recvs, T["recv"]):
            w[pos] = buf
        return w

    def apply(self, x):
        """This rank's rows of (matrix @ x), from x's owned column block."""
        T = self.tensors(x.dtype, x.device)
        return (T["vals"] * self.window(x)[T["cols"]]).sum(dim=1)


class ShardedAMG:
    """Distributed V-cycle over an AlgebraicMultigrid hierarchy.

    amg: a linalg.amg.AlgebraicMultigrid set up with keep_host=True (or
    use `from_grid_operator`). devices / group: the process group (default:
    the world group). device: this rank's device.
    """

    def __init__(self, amg, devices=None, axis_name="shard", group=None, device=None):
        if not hasattr(amg, "host_levels"):
            raise ValueError("ShardedAMG needs an AlgebraicMultigrid set up "
                             "with keep_host=True")
        self.group = group_of(devices, group)
        self.comm = comm = Comm(self.group)
        self.device = rank_device(device)
        self.axis_name = axis_name
        ndev = comm.size
        self.ndev = ndev
        self.amg = amg
        host = amg.host_levels
        if not host:
            raise ValueError(
                "operator coarser than max_coarse: the sequential AMG is already "
                "a single dense solve; sharding it has no levels to distribute")
        sizes = [h[0].shape[0] for h in host] + [amg.host_coarse.shape[0]]
        self.sizes = sizes
        self.Bs = [_pad_rows(n, ndev) for n in sizes]
        self.N = sizes[0]
        self.B = self.Bs[0]
        self.NP = ndev * self.B
        self.counts = [[max(0, min((d + 1) * B, n) - d * B) for d in range(ndev)]
                       for n, B in zip(sizes, self.Bs)]
        self._levels = []
        for l, ((A, Pm, R, d, lmax), lvl) in enumerate(zip(host, amg._levels)):
            Bf, Bc = self.Bs[l], self.Bs[l + 1]
            me = comm.rank
            self._levels.append({
                "A": _ShardedCSR(A, lvl.A[0].shape[1], Bf, Bf, comm),
                "R": _ShardedCSR(R, lvl.R[0].shape[1], Bc, Bf, comm),
                "P": _ShardedCSR(Pm, lvl.P[0].shape[1], Bf, Bc, comm),
                "diag": np.asarray(d, np.float64)[me * Bf:me * Bf + self.counts[l][me]],
                "lmax": lmax})
        self._nc = sizes[-1]
        self._dev = {}

    @classmethod
    def from_grid_operator(cls, go, x_lin=None, time=0.0, devices=None,
                           axis_name="shard", setup_parts=None, group=None,
                           device=None, **amg_kw):
        """Set the hierarchy up from a GridOperator, by default with the
        distributed setup of linalg/amg.py (decoupled per-partition
        aggregation, one partition per rank; setup_parts=1 forces the
        coupled serial setup). reference: parallelhelper.hh:273-440."""
        from dune_pdelab_tpu_torch.linalg.amg import AlgebraicMultigrid
        if setup_parts is None:
            n = Comm(group_of(devices, group)).size
            setup_parts = n if n > 1 else None
        amg = AlgebraicMultigrid(**amg_kw).setup_from_grid_operator(
            go, x_lin, time, keep_host=True,
            parts=setup_parts if setup_parts and setup_parts > 1 else None)
        return cls(amg, devices=devices, axis_name=axis_name, group=group, device=device)

    # ---- layouts ------------------------------------------------------------------
    def _rows(self, l=0):
        me = self.comm.rank
        return me * self.Bs[l], me * self.Bs[l] + self.counts[l][me]

    def device_put(self, r):
        """This rank's rows of a full (N,) vector."""
        r0, r1 = self._rows()
        return torch.as_tensor(r).to(self.device)[r0:r1]

    def gather(self, rp):
        """Every rank's rows -> the full (N,) vector on every rank."""
        return self.comm.allgather_cat(rp, self.counts[0])

    def _coarse(self, dtype, device):
        key = (dtype, device_key(device))
        if key not in self._dev:
            lu, piv = self.amg._coarse
            self._dev[key] = (
                torch.as_tensor(lu, dtype=dtype, device=device),
                torch.as_tensor(piv, device=device),
                [torch.as_tensor(lv["diag"], dtype=dtype, device=device)
                 for lv in self._levels])
        return self._dev[key]

    # ---- the sharded V-cycle (AlgebraicMultigrid._vcycle on row blocks) -------
    def _smooth(self, l, x, r, steps, diag):
        amg = self.amg
        A = self._levels[l]["A"]
        if amg.smoother == "chebyshev":
            from dune_pdelab_tpu_torch.linalg import preconditioners
            cheb = preconditioners.chebyshev(A.apply, diag, self._levels[l]["lmax"],
                                             degree=amg.cheby_degree)
            for _ in range(steps):
                x = cheb(r) if x is None else x + cheb(r - A.apply(x))
            return x
        wj = amg.jacobi_damping
        for _ in range(steps):
            x = wj * r / diag if x is None else x + wj * (r - A.apply(x)) / diag
        return x

    def _vcycle(self, l, r, coarse):
        lu, piv, diags = coarse
        if l == len(self._levels):
            rg = self.comm.allgather_cat(r, self.counts[l])[:self._nc]
            zg = torch.linalg.lu_solve(lu, piv, rg[:, None])[:, 0]
            r0, r1 = self._rows(l)
            return zg[r0:r1]
        lv = self._levels[l]
        x = self._smooth(l, None, r, self.amg.presmooth, diags[l])
        res = r if x is None else r - lv["A"].apply(x)
        xc = self._vcycle(l + 1, lv["R"].apply(res), coarse)
        xp = lv["P"].apply(xc)
        x = xp if x is None else x + xp
        return self._smooth(l, x, r, self.amg.postsmooth, diags[l])

    # ---- public API -------------------------------------------------------------
    def apply_padded(self, rp):
        """One V-cycle on this rank's rows."""
        self.comm.refuse_capture("ShardedAMG")
        return self._vcycle(0, rp, self._coarse(rp.dtype, rp.device))

    def apply(self, r):
        """One V-cycle on a full (N,) vector; the full result on every rank."""
        return self.gather(self.apply_padded(self.device_put(r)))

    def __call__(self, r):
        return self.apply(r)

    def operator_padded(self, xp):
        """This rank's rows of A x (the level-0 matrix)."""
        self.comm.refuse_capture("ShardedAMG")
        return self._levels[0]["A"].apply(xp)

    def solve_cg(self, b, tol=1e-10, maxiter=5000, x0=None):
        """AMG-preconditioned CG with matrix, Krylov vectors and V-cycle on
        the row blocks (the NOVLP_CG_AMG analog); b and x0 full (N,)
        vectors. Returns the full solution and SolverStats; the arithmetic
        is the sequential assembled AMG-CG's, so the iteration counts match."""
        bp = self.device_put(b)
        x0p = None if x0 is None else self.device_put(x0).to(bp.dtype)
        z, stats = _cg(self.operator_padded, bp, x0=x0p, M=self.apply_padded, tol=tol,
                       maxiter=maxiter, dot=self.comm.dot)
        return self.gather(z), stats
