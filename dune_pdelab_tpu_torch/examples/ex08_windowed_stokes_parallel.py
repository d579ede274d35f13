"""Taylor-Hood Stokes solved on 8 ranks with the general window-sharded
operator (any mesh, any space), written as partitioned parallel VTK (a
.pvtu master and one .vtu piece per rank)
(examples/08_windowed_stokes_parallel.py; ovlpistlsolverbackend.hh running
a composite Stokes space over MPI ranks, VTKWriter::pwrite).

`parallel/windowed.py` shards contiguous element slabs with per-rank DOF
windows; each apply exchanges halo-sized windows between neighbouring
ranks. The ranks are processes in one gloo group on the run's device. The
Krylov vectors are the full ones and each apply is the sharded J.v (a
global dot on blocks would cost a collective per Gram-Schmidt step).

Run: python -m dune_pdelab_tpu_torch.examples.ex08_windowed_stokes_parallel [--device cpu]
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

import dune_pdelab_tpu_torch as pt
from dune_pdelab_tpu_torch.examples import _kernels
from dune_pdelab_tpu_torch.examples._common import (
    RANKS, comm_summary, finish, on_device, out_directory, parser, rank_pool,
)
from dune_pdelab_tpu_torch.io import ParallelVTKWriter
from dune_pdelab_tpu_torch.ops import TaylorHoodNavierStokes
from dune_pdelab_tpu_torch.ops.stokes import NavierStokesParameters
from dune_pdelab_tpu_torch.solvers.stokes import stokes_constraints, taylor_hood_space


def _a(x):
    return x**2 * (1 - x) ** 2


def _da(x):
    return 2 * x * (1 - x) * (1 - 2 * x)


def _dda(x):
    return 12 * x**2 - 12 * x + 2


def _ddda(x):
    return 24 * x - 12


class Manufactured(NavierStokesParameters):
    """Divergence-free velocity (a(x) a'(y), -a'(x) a(y)), pressure
    x^3 + y^3."""

    def __init__(self):
        super().__init__(mu=1.0, rho=0.0)

    def f(self, x):
        xx, yy = x[..., 0], x[..., 1]
        f1 = -(_dda(xx) * _da(yy) + _a(xx) * _ddda(yy)) + 3 * xx**2
        f2 = (_ddda(xx) * _a(yy) + _da(xx) * _dda(yy)) + 3 * yy**2
        return torch.stack([f1, f2], dim=-1)


def setup(cells, dev):
    mesh = pt.StructuredMesh([0, 0], [1, 1], (cells, cells))
    W = taylor_hood_space(mesh, degree=2)
    cg = stokes_constraints(W, bctype=True, pin_pressure=True, device=dev)
    go = pt.GridOperator(W, TaylorHoodNavierStokes(Manufactured()), constraints=cg)
    return mesh, W, go


def sharded_rank(group, cells, dtype_name):
    """One rank: the window-sharded operator over the group and
    Jacobi-preconditioned GMRES(150) to 1e-7 on its J.v."""
    from dune_pdelab_tpu_torch.linalg.krylov import restarted_gmres as gmres
    from dune_pdelab_tpu_torch.parallel import comm
    from dune_pdelab_tpu_torch.parallel.windowed import WindowShardedGridOperator

    dtype, dev = getattr(torch, dtype_name), pt.default_device()
    before = _kernels.snapshot()
    _, W, go = setup(cells, dev)
    wgo = WindowShardedGridOperator(go, group=group, device=dev)
    x0 = W.zero(dtype, dev)
    b = wgo.residual(x0)
    # Jacobi on the velocity blocks; the saddle point's zero pressure
    # diagonal takes the identity
    diag = go.jacobian_diagonal(x0)
    dsafe = torch.where(torch.abs(diag) > 1e-12, diag, torch.ones_like(diag))
    comm.reset_stats()
    t0 = time.perf_counter()
    z, stats = gmres(lambda p: wgo.jacobian_apply(x0, p), b, M=lambda r: r / dsafe,
                     tol=1e-7, maxiter=2000, restart=150)
    return {"ranks": wgo.ndev, "iterations": int(stats.iterations),
            "comm": comm_summary(time.perf_counter() - t0),
            "converged": bool(stats.converged), "x": (x0 - z).cpu().numpy(),
            "owner": np.asarray(wgo.element_owner), "launches": _kernels.since(before)}


def run(cells=8, check=True, pool=None, device=None, dtype=torch.float64, out_dir=None):
    """The 8-rank GMRES solve; returns its iterations, whether it reached
    1e-7, the true relative residual, max |vx - exact| (with `check`, at
    the reference's 8^2, held below 2e-4: the reference prints 1.21e-4), the
    .pvtu path and the ranks' kernel launches.
    At 8^2 the reference's GMRES(150) stops at its 2000-iteration cap short
    of 1e-7 (2100 iterations, true residual ~1e-5), and so does this one.
    `pool` is a RankPool of at least 8 ranks to use (one is started
    otherwise)."""
    out_dir = out_directory(out_dir, "ex08")
    dname = str(dtype).split(".")[-1]
    with on_device(device, dtype) as dev:
        if pool is None:
            with rank_pool(dev) as own:
                res = own.run(sharded_rank, cells, dname)
        else:
            res = pool.run(sharded_rank, cells, dname, nranks=RANKS)
        r0 = res[0]
        mesh, W, go = setup(cells, dev)
        print(f"ranks: {r0['ranks']}")
        x = torch.as_tensor(r0["x"], device=dev)
        b = go.residual(W.zero(dtype, dev))
        rr = float(torch.linalg.norm(go.residual(x)) / torch.linalg.norm(b))
        print(f"sharded GMRES: {r0['iterations']} iterations (converged {r0['converged']}), "
              f"true rel residual {rr:.2e}")

        # velocity against the exact field
        Vv = W.children[0].children[0]
        vx = W.children[0].restrict(W.restrict(x, 0), 0)
        vy = W.children[0].restrict(W.restrict(x, 0), 1)
        vex = Vv.interpolate(lambda p: _a(p[:, 0]) * _da(p[:, 1]), dtype=dtype, device=dev)
        verr = float(torch.max(torch.abs(vx - vex)))
        print(f"max |vx - exact| = {verr:.2e}")

        # partitioned output: one .vtu piece per rank and the .pvtu master,
        # on the element partition of the sharded solve
        w = ParallelVTKWriter(mesh, r0["owner"])
        w.add_field(Vv, vx, "vx")
        w.add_field(Vv, vy, "vy")
        path = w.write(os.path.join(out_dir, "stokes"))
        print(f"wrote {path} (+ {w.nshards} per-shard pieces)")
    if check and not verr < 2e-4:
        raise AssertionError(f"ex08: max |vx - exact| {verr}")
    return {"ndofs": W.ndofs, "ranks": r0["ranks"], "iterations": r0["iterations"],
            "converged": r0["converged"], "true_rel": rr, "vx_error": verr,
            "comm": r0["comm"], "pieces": w.nshards, "pvtu": path,
            "rank_launches": _kernels.summed(r["launches"] for r in res)}


def main(argv=None):
    ap = parser(__doc__, "ex08_windowed_stokes_parallel")
    ap.add_argument("--cells", type=int, default=8)
    a = ap.parse_args(argv)
    return finish(run(a.cells, device=a.device, out_dir=a.out))


if __name__ == "__main__":
    main()
