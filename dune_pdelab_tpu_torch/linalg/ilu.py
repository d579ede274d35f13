"""ILU(0) and ILU(n) on the lattice-ELL pattern: fine-grained parallel
factorization.

PyTorch port of dune_pdelab_tpu/linalg/ilu.py (reference:
dune/pdelab/backend/istl/seqistlsolverbackend.hh ILU0/ILUn). The two
fine-grained-parallel reformulations of Chow & Patel ("Fine-grained
parallel incomplete LU factorization", SISC 2015):

  * factorization: the ILU0 fixed-point equations iterated Jacobi-style; on
    the offset-keyed ELL lattice every inner sum over k collapses to a
    static set of offset pairs (o1, o2) with o1 + o2 = o, each term one
    shifted elementwise product of tap-value arrays;
  * application: the triangular solves L z = r (unit lower) and U y = z
    replaced by truncated Jacobi iterations x <- r - L_strict x and
    y <- D^{-1}(z - U_strict y).

Dirichlet-masked rows are identity rows (diag 1, no coupling). ILU(n): a
fill offset o = o1 + o2 from levels l1, l2 gets level l1 + l2 + 1,
minimised over decompositions; taps with level <= n join the pattern.

Factor and apply run in the dtype and on the device of the ELL values
(the reference factors a float64 host copy). Plain torch: the JAX package
runs the same shift-MACs outside any Pallas kernel.
"""
from __future__ import annotations

import numpy as np
import torch

from dune_pdelab_tpu_torch.assembly.ell import shift


def _flat_shift(off, dims):
    s = 0
    stride = 1
    for d in range(len(dims)):
        s += int(off[d]) * stride
        stride *= dims[d]
    return s


def _fill_levels(offs, level):
    """Symbolic level-of-fill on a translation-invariant offset pattern.

    Returns the extended offset list (original offsets first, in order).
    Fill offset o1 + o2 from levels l1, l2 gets level l1 + l2 + 1
    (minimized over paths), kept when <= `level`."""
    lev = {tuple(int(c) for c in o): 0 for o in offs}
    for _ in range(level):
        items = list(lev.items())
        for o1, l1 in items:
            for o2, l2 in items:
                o = tuple(a + b for a, b in zip(o1, o2))
                lv = l1 + l2 + 1
                if lv <= level and lev.get(o, level + 1) > lv:
                    lev[o] = lv
    fill = sorted(o for o, lv in lev.items() if lv > 0)
    return [tuple(int(c) for c in o) for o in offs] + fill


class EllILU0:
    """ILU(level) preconditioner for an EllMatrix; callable r -> z ~= A^{-1} r.

    level=0 is the classic ILU(0) (pattern = matrix pattern); level>=1
    extends the pattern by lattice fill offsets (`_fill_levels`)."""

    def __init__(self, ell, sweeps: int = 4, tri_iters: int = 3,
                 level: int = 0):
        self.ell = ell
        self.sweeps = sweeps
        self.tri_iters = tri_iters
        self.level = level
        dims = ell.dims
        self.grid_shape = tuple(reversed(dims))
        offs = np.asarray(ell.offsets)                  # (ntaps, dim)
        n0 = len(offs)
        if level > 0:
            offs = np.asarray(_fill_levels(offs, level))
        shifts = np.array([_flat_shift(o, dims) for o in offs])
        self.k = max(int(ell.k), int(np.abs(offs).max()))
        ntaps = len(offs)
        self.diag_t = int(np.nonzero(shifts == 0)[0][0])
        self.lower = [t for t in range(ntaps) if shifts[t] < 0]
        self.upper = [t for t in range(ntaps) if shifts[t] > 0]
        # offset pairs per target tap: (t1, t2 upper) with o1 + o2 = o_t
        key = {tuple(offs[t]): t for t in range(ntaps)}
        self.pairs = {}
        for t in range(ntaps):
            plist = []
            for t1 in range(ntaps):
                cond = (shifts[t1] < shifts[t]) if shifts[t] < 0 else (shifts[t1] < 0)
                if not cond:
                    continue
                t2 = key.get(tuple(offs[t] - offs[t1]))
                if t2 is not None and shifts[t2] > 0:
                    plist.append((t1, t2))
            self.pairs[t] = plist
        self.offs = offs
        # values with identity Dirichlet rows; fill taps start at 0
        v0 = ell.values
        vals = torch.cat([v0, v0.new_zeros((ntaps - n0,) + tuple(v0.shape[1:]))])
        if ell.mask is not None:
            m = ell.mask.to(v0.device).reshape(self.grid_shape)
            vals.masked_fill_(m, 0.0)
            vals[self.diag_t].masked_fill_(m, 1.0)
        # guard empty diagonals (padded/degenerate rows)
        vals[self.diag_t].masked_fill_(vals[self.diag_t] == 0.0, 1.0)
        # per-tap validity: (i, i+o) exists only when i+o is in the lattice
        ones = torch.ones(self.grid_shape, dtype=v0.dtype, device=v0.device)
        self.valid = [shift(ones, offs[t], self.k) for t in range(ntaps)]
        self._factorize(vals)

    # -- factorization --------------------------------------------------------
    def _shift_safe(self, arr, off):
        s = shift(arr, off, self.k)
        return torch.where(s == 0, 1.0, s)

    def _factorize(self, a):
        offs = self.offs
        lower = set(self.lower)
        vals = a
        for _ in range(self.sweeps):
            udiag = vals[self.diag_t]
            new = []
            for t in range(vals.shape[0]):
                acc = a[t]
                for (t1, t2) in self.pairs[t]:
                    acc = acc - vals[t1] * shift(vals[t2], offs[t1], self.k)
                if t in lower:
                    acc = acc / self._shift_safe(udiag, offs[t])
                new.append(acc * self.valid[t])
            vals = torch.stack(new)
        self.L = [(t, offs[t]) for t in self.lower]
        self.U = [(t, offs[t]) for t in self.upper]
        self.vals = vals
        self.udiag = vals[self.diag_t]

    # -- application ----------------------------------------------------------
    def _tri_apply(self, taps, z):
        """sum_t vals[t] * z(i + o_t) over the given taps."""
        out = None
        for (t, off) in taps:
            term = self.vals[t] * shift(z, off, self.k)
            out = term if out is None else out + term
        return out if out is not None else torch.zeros_like(z)

    def __call__(self, r):
        rg = r.reshape(self.grid_shape)
        x = rg
        for _ in range(self.tri_iters):
            x = rg - self._tri_apply(self.L, x)
        y = x / self.udiag
        for _ in range(self.tri_iters):
            y = (x - self._tri_apply(self.U, y)) / self.udiag
        return y.reshape(-1)


def ilu0_preconditioner(go, x_lin, time=0.0, sweeps=4, tri_iters=3, level=0):
    """LinearSolverBackend `precond` callable building EllILU0 from the
    assembled lattice-ELL Jacobian; raises when the space has no lattice
    structure."""
    from dune_pdelab_tpu_torch.assembly.ell import assemble_ell

    ell = assemble_ell(go, x_lin, time)
    if ell is None:
        raise ValueError("ILU needs a lattice (single-leaf C0 Qk) space")
    return EllILU0(ell, sweeps=sweeps, tri_iters=tri_iters, level=level)


def ilun_preconditioner(level):
    """ILU(n) `precond` factory (ISTLBackend_*_ILUn analog): higher fill
    levels trade factorization/apply cost for stronger smoothing."""
    def make(go, x_lin, time=0.0, sweeps=None, tri_iters=None):
        # larger patterns need more fixed-point sweeps to converge the
        # factorization (Chow-Patel) and more truncated-triangular terms
        kw = {"level": level,
              "sweeps": sweeps if sweeps is not None else 4 + 2 * level,
              "tri_iters": tri_iters if tri_iters is not None else 3 + level}
        return ilu0_preconditioner(go, x_lin, time, **kw)
    return make
