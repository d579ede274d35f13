"""Unstructured-grid workflow: a Gmsh mesh in, AMG-preconditioned solves,
VTK out, the ISTLBackend_SEQ_CG_AMG pipeline on a mesh where no geometric
multigrid exists (examples/14_unstructured_amg.py; GmshReader + pkfem.hh +
seqistlsolverbackend.hh AMG backends).

  1. the mesh: `--msh PATH` reads a Gmsh MSH 2.x file through
     SimplexMesh.from_gmsh; without it the triangulated 32^2 unit square
     (the reference's own stand-in for its grid), which is also written to
     an MSH 2.2 file and read back to prove the reader path;
  2. P1 and P2 conforming solves with smoothed-aggregation AMG beside
     Jacobi-CG;
  3. SIPG DG through the DG -> P1 -> AMG two-level preconditioner;
  4. ShardedAMG on 8 ranks (processes, gloo) wrapping the sequential
     hierarchy, with the sequential iteration count;
  5. VTK output with simplex cells.

Run: python -m dune_pdelab_tpu_torch.examples.ex14_unstructured_amg [--msh PATH] [--device cpu]
"""
from __future__ import annotations

import os

import numpy as np
import torch

import dune_pdelab_tpu_torch as pt
from dune_pdelab_tpu_torch.examples import _kernels
from dune_pdelab_tpu_torch.examples._common import (
    RANKS, finish, on_device, out_directory, parser, rank_pool,
)
from dune_pdelab_tpu_torch.io import VTKWriter
from dune_pdelab_tpu_torch.linalg import AlgebraicMultigrid, DGTwoLevel
from dune_pdelab_tpu_torch.linalg.krylov import cg
from dune_pdelab_tpu_torch.ops import ConvectionDiffusionFEM, ConvectionDiffusionProblem
from dune_pdelab_tpu_torch.ops.convectiondiffusiondg import ConvectionDiffusionDG, DGMethod


class Heated(ConvectionDiffusionProblem):
    """Unit source, zero Dirichlet values everywhere."""

    def f(self, x):
        return torch.ones(x.shape[:-1], dtype=x.dtype, device=x.device)


def write_msh(path, mesh):
    """A triangle mesh as MSH 2.2 ASCII (node ids from 1, physical tag 1)."""
    v, t = mesh.vertices, mesh.cells
    nv, nt = len(v), len(t)
    nodes = np.column_stack([np.arange(1, nv + 1), v[:, 0], v[:, 1], np.zeros(nv)])
    els = np.column_stack([np.arange(1, nt + 1), np.full(nt, 2), np.full(nt, 2),
                           np.ones(nt, np.int64), np.ones(nt, np.int64), t + 1])
    with open(path, "w") as f:
        f.write(f"$MeshFormat\n2.2 0 8\n$EndMeshFormat\n$Nodes\n{nv}\n")
        f.write(("%d %r %r %r\n" * nv) % tuple(nodes.ravel().tolist()))
        f.write(f"$EndNodes\n$Elements\n{nt}\n")
        f.write(("%d %d %d %d %d %d %d %d\n" * nt) % tuple(els.ravel().astype(np.int64).tolist()))
        f.write("$EndElements\n")


def make_mesh(msh, cells):
    if msh is not None:
        return pt.SimplexMesh.from_gmsh(msh)
    return pt.SimplexMesh.from_structured(pt.StructuredMesh([0, 0], [1, 1], (cells, cells)))


def p1_operator(mesh, dev):
    p = Heated()
    V = pt.FunctionSpace(mesh, pt.PkFEM(1, 2))
    go = pt.GridOperator(V, ConvectionDiffusionFEM(p),
                         constraints=pt.constraints(p.dirichlet_bctype(), V, device=dev))
    return V, go


def sharded_amg_rank(group, msh, cells, dtype_name):
    """One rank of step 4: CG on the P1 operator with the sequential AMG
    V-cycle and with ShardedAMG over the group (the same hierarchy)."""
    from dune_pdelab_tpu_torch.parallel import ShardedAMG

    dtype = getattr(torch, dtype_name)
    dev = pt.default_device()
    before = _kernels.snapshot()
    V, go = p1_operator(make_mesh(msh, cells), dev)
    amg = AlgebraicMultigrid().setup_from_grid_operator(go, keep_host=True)
    samg = ShardedAMG(amg, group=group, device=dev)
    x0 = V.zero(dtype, dev)
    b = go.residual(x0)
    zs, ss = cg(lambda q: go.jacobian_apply(x0, q), b, M=amg.apply, tol=1e-10)
    zp, sp = cg(lambda q: go.jacobian_apply(x0, q), b, M=samg.apply, tol=1e-10)
    return {"ranks": samg.ndev, "iterations": int(sp.iterations),
            "iterations_seq": int(ss.iterations), "diff": float(torch.linalg.norm(zs - zp)),
            "launches": _kernels.since(before)}


def run(cells=32, msh=None, pool=None, device=None, dtype=torch.float64, out_dir=None):
    """Steps 1-5; returns ndofs and iterations of each solve, the MSH round
    trip's check, the sharded and sequential AMG-CG iterations, their
    solutions' difference and the ranks' kernel launches. `pool` is a RankPool of at least 8 ranks to use
    (one is started for the run otherwise)."""
    out_dir = out_directory(out_dir, "ex14")
    out = {}
    with on_device(device, dtype) as dev:
        mesh = make_mesh(msh, cells)
        if msh is not None:
            print(f"loaded {msh}: {mesh.nvertices} vertices, {mesh.nelements} triangles")
        else:
            path = os.path.join(out_dir, "square.msh")
            write_msh(path, mesh)
            back = pt.SimplexMesh.from_gmsh(path)
            same = (np.array_equal(back.vertices, mesh.vertices)
                    and np.array_equal(np.sort(back.cells, 1), np.sort(mesh.cells, 1)))
            print(f"triangulated {cells}^2 square: {mesh.nvertices} vertices, "
                  f"{mesh.nelements} triangles; MSH 2.2 round trip through {back.msh_reader} "
                  f"reader {'equal' if same else 'DIFFERS'}")
            if not same:
                raise AssertionError("ex14: the MSH round trip changed the mesh")
            out["msh_roundtrip"] = back.msh_reader
        p = Heated()

        # -- P1 and P2 with AMG against Jacobi ---------------------------------
        for k in (1, 2):
            V = pt.FunctionSpace(mesh, pt.PkFEM(k, 2))
            cg_ = pt.constraints(p.dirichlet_bctype(), V, device=dev)
            go = pt.GridOperator(V, ConvectionDiffusionFEM(p), constraints=cg_)
            slp = pt.StationaryLinearProblemSolver(go, pt.SEQ_CG_AMG(), reduction=1e-10,
                                                   verbose=0)
            x = slp.apply(V.zero(dtype, dev))
            sj = pt.StationaryLinearProblemSolver(go, pt.SEQ_CG_Jacobi(), reduction=1e-10,
                                                  verbose=0)
            sj.apply(V.zero(dtype, dev))
            print(f"P{k}: ndofs={V.ndofs}  AMG-CG {slp.result.linear_solver_iterations} its "
                  f"vs Jacobi-CG {sj.result.linear_solver_iterations} its "
                  f"(converged={slp.result.converged})")
            out[f"p{k}"] = {"ndofs": V.ndofs, "amg": slp.result.linear_solver_iterations,
                            "jacobi": sj.result.linear_solver_iterations,
                            "converged": bool(slp.result.converged)}
            if k == 1:
                x_p1, V_p1 = x, V

        # -- SIPG through the DG -> P1 -> AMG two-level --------------------------
        Vdg = pt.FunctionSpace(mesh, pt.PkDGFEM(1, 2))
        godg = pt.GridOperator(Vdg, ConvectionDiffusionDG(p, method=DGMethod.SIPG))
        tl = DGTwoLevel(godg, ConvectionDiffusionFEM(p), device=dev)
        ls = pt.LinearSolverBackend(solver="cg", precond=tl, use_stencil=False)
        sdg = pt.StationaryLinearProblemSolver(godg, ls, reduction=1e-10, verbose=0)
        sdg.apply(Vdg.zero(dtype, dev))
        print(f"DG SIPG: ndofs={Vdg.ndofs}  two-level({tl.coarse_kind})-CG "
              f"{sdg.result.linear_solver_iterations} its")
        out["dg"] = {"ndofs": Vdg.ndofs, "coarse": tl.coarse_kind,
                     "iterations": sdg.result.linear_solver_iterations}

        # -- ShardedAMG on 8 ranks ---------------------------------------------
        if pool is None:
            with rank_pool(dev) as own:
                res = own.run(sharded_amg_rank, msh, cells, str(dtype).split(".")[-1])
        else:
            res = pool.run(sharded_amg_rank, msh, cells, str(dtype).split(".")[-1],
                           nranks=RANKS)
        r0 = res[0]
        print(f"distributed AMG ({r0['ranks']} ranks): {r0['iterations']} its == sequential "
              f"{r0['iterations_seq']}; solution diff {r0['diff']:.2e}")
        if not (r0["iterations"] == r0["iterations_seq"] and r0["diff"] <= 1e-12):
            raise AssertionError(f"ex14: sharded AMG-CG {r0}")
        out["sharded"] = {k: v for k, v in r0.items() if k != "launches"}
        out["rank_launches"] = _kernels.summed(r["launches"] for r in res)

        # -- VTK output --------------------------------------------------------
        path = VTKWriter(mesh).add_field(V_p1, x_p1, "u").write(
            os.path.join(out_dir, "out14_unstructured"))
        print(f"wrote {path}")
        out["vtu"] = path
    return out


def main(argv=None):
    ap = parser(__doc__, "ex14_unstructured_amg")
    ap.add_argument("--msh", default=None, help="a Gmsh MSH 2.x triangle mesh")
    ap.add_argument("--cells", type=int, default=32)
    a = ap.parse_args(argv)
    return finish(run(a.cells, a.msh, device=a.device, out_dir=a.out))


if __name__ == "__main__":
    main()
