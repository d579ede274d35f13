"""The Poisson problem solved on 8 ranks with DOF sharding and halo
exchanges, held against the sequential solve
(examples/07_parallel_poisson.py; the overlapping/nonoverlapping ISTL
backends, dune/pdelab/backend/istl/novlpistlsolverbackend.hh).

The ranks are processes in one torch.distributed gloo group
(parallel/launch.py), each on the run's device; the global dots are
reproducible (the same bits on any partition).

Run: python -m dune_pdelab_tpu_torch.examples.ex07_parallel_poisson [--device cpu]
"""
from __future__ import annotations

import math
import time

import torch

import dune_pdelab_tpu_torch as pt
from dune_pdelab_tpu_torch.examples import _kernels
from dune_pdelab_tpu_torch.examples._common import (
    RANKS, comm_summary, finish, on_device, parser, rank_pool,
)
from dune_pdelab_tpu_torch.ops import ConvectionDiffusionFEM, ConvectionDiffusionProblem
from dune_pdelab_tpu_torch.space.functions import l2_difference

PI = math.pi


class Problem(ConvectionDiffusionProblem):
    def exact(self, p):
        return torch.sin(PI * p[:, 0]) * torch.cos(2 * PI * p[:, 1]) + p[:, 0]

    def f(self, x):
        return 5 * PI ** 2 * torch.sin(PI * x[..., 0]) * torch.cos(2 * PI * x[..., 1])

    def g(self, x):
        return torch.sin(PI * x[..., 0]) * torch.cos(2 * PI * x[..., 1]) + x[..., 0]


def setup(cells, dtype, dev):
    prob = Problem()
    V = pt.FunctionSpace(pt.StructuredMesh([0, 0], [1, 1], (cells, cells)), pt.QkFEM(1, 2))
    cg = pt.constraints(prob.dirichlet_bctype(), V, device=dev)
    go = pt.GridOperator(V, ConvectionDiffusionFEM(prob), constraints=cg)
    x0 = pt.interpolate_dirichlet(prob.g, V, cg, V.zero(dtype, dev))
    return prob, V, go, x0


def sharded_rank(group, cells, dtype_name, tol):
    """One rank: the block-DOF-sharded residual and Jacobi-CG (halo-window
    gathers and border add-exchanges; any local operator works)."""
    from dune_pdelab_tpu_torch.parallel import NonoverlappingShardedGridOperator, comm

    dev = pt.default_device()
    before = _kernels.snapshot()
    _, V, go, x0 = setup(cells, getattr(torch, dtype_name), dev)
    sgo = NonoverlappingShardedGridOperator(go, group=group, device=dev)
    b = sgo.residual(x0)
    diag = go.jacobian_diagonal(x0)
    comm.reset_stats()
    t0 = time.perf_counter()
    z, stats = sgo.solve_cg(x0, b, diag=diag, tol=tol)
    return {"ranks": torch.distributed.get_world_size(group),
            "comm": comm_summary(time.perf_counter() - t0),
            "iterations": int(stats.iterations), "x": (x0 - z).cpu().numpy(),
            "launches": _kernels.since(before)}


def run(cells=64, tol=1e-11, pool=None, device=None, dtype=torch.float64, out_dir=None):
    """The sequential Jacobi-CG solve and the 8-rank one; returns both
    iteration counts, max |x_par - x_seq|, the L2 error of x_par and the
    ranks' kernel launches.
    `pool` is a RankPool of at least 8 ranks to use (one is started
    otherwise)."""
    dname = str(dtype).split(".")[-1]
    with on_device(device, dtype) as dev:
        prob, V, go, x0 = setup(cells, dtype, dev)
        if pool is None:
            with rank_pool(dev) as own:
                task = own.submit(sharded_rank, cells, dname, tol)
                seq, slp = _sequential(go, x0, tol)
                res = task.result()
        else:
            task = pool.submit(sharded_rank, cells, dname, tol, nranks=RANKS)
            seq, slp = _sequential(go, x0, tol)
            res = task.result()
        r0 = res[0]
        x_par = torch.as_tensor(r0["x"], device=dev)
        diff = float(torch.max(torch.abs(x_par - seq)))
        err = float(l2_difference(V, x_par, prob.exact))
        print(f"ranks: {r0['ranks']}")
        print(f"CG iterations: {r0['iterations']} (sharded), "
              f"{slp.result.linear_solver_iterations} (sequential)")
        print(f"max |x_par - x_seq| = {diff:.2e}")
        print(f"L2 error vs exact  = {err:.3e}")
    if not (diff <= 1e-12 and r0["iterations"] == slp.result.linear_solver_iterations):
        raise AssertionError(f"ex07: sharded solve differs from the sequential one ({diff:.2e})")
    return {"ndofs": V.ndofs, "ranks": r0["ranks"], "iterations": r0["iterations"],
            "iterations_seq": slp.result.linear_solver_iterations, "max_diff": diff,
            "l2_error": err, "comm": r0["comm"],
            "rank_launches": _kernels.summed(r["launches"] for r in res)}


def _sequential(go, x0, tol):
    slp = pt.StationaryLinearProblemSolver(go, pt.SEQ_CG_Jacobi(), reduction=tol, verbose=0)
    return slp.apply(x0), slp


def main(argv=None):
    ap = parser(__doc__, "ex07_parallel_poisson")
    ap.add_argument("--cells", type=int, default=64)
    a = ap.parse_args(argv)
    return finish(run(a.cells, device=a.device, out_dir=a.out))


if __name__ == "__main__":
    main()
