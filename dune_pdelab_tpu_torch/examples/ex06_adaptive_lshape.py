"""L-shaped-domain corner singularity with estimate -> mark -> refine ->
transfer (examples/06_adaptive_lshape.py; dune-pdelab-tutorials tutorial05,
dune/pdelab/test/testadaptivity.cc).

Uses the simplex newest-vertex-bisection path; the cube hanging-node path
is `dune_pdelab_tpu_torch.adaptivity.local.adapt_local`.

Run: python -m dune_pdelab_tpu_torch.examples.ex06_adaptive_lshape [--device cpu]
"""
from __future__ import annotations

import math

import torch

import dune_pdelab_tpu_torch as pt
from dune_pdelab_tpu_torch.adaptivity.adaptivity import error_fraction, mark_elements
from dune_pdelab_tpu_torch.adaptivity.local import (
    adapt_local_simplex, p1_edge_jump_indicator,
)
from dune_pdelab_tpu_torch.examples._common import finish, on_device, parser
from dune_pdelab_tpu_torch.ops import ConvectionDiffusionFEM, ConvectionDiffusionProblem
from dune_pdelab_tpu_torch.space.functions import l2_difference


def u_exact(p):
    """r^(2/3) sin(2 theta / 3), theta in [0, 2 pi)."""
    r = torch.hypot(p[:, 0], p[:, 1])
    th = torch.remainder(torch.atan2(p[:, 1], p[:, 0]), 2 * math.pi)
    return torch.where(r == 0, torch.zeros_like(r), r ** (2 / 3) * torch.sin(2 * th / 3))


class Corner(ConvectionDiffusionProblem):
    def f(self, x):
        return torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)

    def g(self, x):
        return u_exact(x.reshape(-1, x.shape[-1])).reshape(x.shape[:-1])


def l_shape(n):
    """The n^2 square (-1, 1)^2 without its lower right quarter, triangulated
    and oriented for newest-vertex bisection."""
    sq = pt.SimplexMesh.from_structured(pt.StructuredMesh([-1, -1], [1, 1], (n, n)))
    c = sq.element_centers()
    return sq.submesh(~((c[:, 0] > 0) & (c[:, 1] < 0))).oriented_for_bisection()


def solve(V, dtype, dev, maxiter=20000):
    cgm = pt.constraints(True, V, device=dev)
    go = pt.GridOperator(V, ConvectionDiffusionFEM(Corner()), constraints=cgm)
    x0 = pt.interpolate_dirichlet(u_exact, V, cgm, V.zero(dtype, dev))
    slp = pt.StationaryLinearProblemSolver(go, pt.SEQ_CG_Jacobi(maxiter=maxiter),
                                           reduction=1e-12, verbose=0)
    return go, slp.apply(x0)


def run(start=8, cycles=10, fraction=0.5, device=None, dtype=torch.float32, out_dir=None):
    """`cycles` adaptive cycles from the `start`^2 L-shape (Doerfler marking
    of the P1 edge-jump indicator); returns N and the L2 error per cycle
    and after the last."""
    ndofs, errs = [], []
    with on_device(device, dtype) as dev:
        V = pt.FunctionSpace(l_shape(start), pt.PkFEM(1, 2))
        _, x = solve(V, dtype, dev)
        for it in range(cycles):
            err = float(l2_difference(V, x, u_exact))
            ndofs.append(V.ndofs)
            errs.append(err)
            print(f"iter {it}: ndofs={V.ndofs:6d}  L2 error={err:.4e}")
            eta2 = p1_edge_jump_indicator(V, x)
            marks, _ = mark_elements(eta2, error_fraction(eta2, fraction))
            V, x = adapt_local_simplex(V, x, marks)
            _, x = solve(V, dtype, dev)
        err = float(l2_difference(V, x, u_exact))
        ndofs.append(V.ndofs)
        errs.append(err)
        print(f"final : ndofs={V.ndofs:6d}  L2 error={err:.4e}")
    return {"ndofs": ndofs, "l2_errors": errs}


def main(argv=None):
    ap = parser(__doc__, "ex06_adaptive_lshape")
    ap.add_argument("--cycles", type=int, default=10)
    a = ap.parse_args(argv)
    return finish(run(cycles=a.cycles, device=a.device, out_dir=a.out))


if __name__ == "__main__":
    main()
