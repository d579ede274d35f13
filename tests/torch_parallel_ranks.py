"""Rank-side halves of the port's distributed tests (tests/test_torch_parallel.py,
test_torch_windowed.py, test_torch_shardedamg.py).

Each function runs on every rank of a gloo group started by
dune_pdelab_tpu_torch.parallel.launch.RankPool (CPU, fp64) and returns
numpy results, rank 0's being compared in the test process with the JAX
package's values. This module imports torch, numpy and the port only: a
rank process never imports JAX or tests/conftest.py.
"""
import numpy as np
import torch
import torch.distributed as dist

import dune_pdelab_tpu_torch as pt
from dune_pdelab_tpu_torch.assembly.stencil import compile_stencil
from dune_pdelab_tpu_torch.linalg import cg
from dune_pdelab_tpu_torch.ops import (
    ConvectionDiffusionDG, ConvectionDiffusionFEM, ConvectionDiffusionProblem, DGMethod,
)
from dune_pdelab_tpu_torch.parallel import comm as pcomm
from dune_pdelab_tpu_torch.parallel import (
    DofShardedStencil, NonoverlappingShardedGridOperator, ShardedAMG,
    ShardedGeometricMultigrid, ShardedGridOperator, WindowShardedGridOperator,
    allreduce, block_partition, exchange_planes, masked_dot, rebalance, redistribute,
    sharded_cg_solve,
)

F64 = torch.float64
CPU = "cpu"


def rank_task(fn):
    """A rank's task: fp64 by default and the CPU as the default device, in
    the rank process only (the test process keeps its own defaults)."""
    import functools

    @functools.wraps(fn)
    def run(*args, **kwargs):
        torch.set_default_dtype(F64)
        pt.set_default_device(CPU)
        return fn(*args, **kwargs)
    return run


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _rng_vec(n, seed, count=1):
    rng = np.random.default_rng(seed)
    out = [torch.as_tensor(rng.standard_normal(n)) for _ in range(count)]
    return out[0] if count == 1 else out


@rank_task
def warm_up(group):
    """One tiny forward- and reverse-mode pass: the first torch.func call of
    a process imports its machinery (~2.5 s), paid here by every rank at
    once rather than by the first test to reach a rank."""
    x = torch.ones(3)
    torch.func.jvp(torch.sin, (x,), (x,))
    torch.func.vjp(torch.sin, x)[1](x)
    return dist.get_rank(group)


@rank_task
def imported_modules(group):
    """The modules of JAX or of the JAX package a rank process holds."""
    import sys
    return sorted(m for m in sys.modules
                  if m == "jax" or m.startswith(("jax.", "jaxlib", "dune_pdelab_tpu.")))


# ---- problems (the reference tests' own) ------------------------------------
class Problem(ConvectionDiffusionProblem):
    def f(self, x):
        return torch.sin(3 * x[..., 0]) * x[..., 1] + 1.0

    def j(self, x):
        return 0.1 * x[..., 0]


class Unit(ConvectionDiffusionProblem):
    def f(self, x):
        return torch.ones(x.shape[:-1], dtype=x.dtype, device=x.device)


class Lap(ConvectionDiffusionProblem):
    def A(self, x):
        return 1.0


class AmgProblem(ConvectionDiffusionProblem):
    """tests/test_shardedamg.py _Problem."""

    def f(self, x):
        return 5 * np.pi**2 * torch.sin(np.pi * x[..., 0]) * torch.cos(2 * np.pi * x[..., 1])

    def g(self, x):
        return torch.sin(np.pi * x[..., 0]) * torch.cos(2 * np.pi * x[..., 1]) + x[..., 0]


def cd_go(n=10, dim=2, k=2, problem=Problem):
    mesh = pt.StructuredMesh([0] * dim, [1] * dim, (n,) * dim)
    V = pt.FunctionSpace(mesh, pt.QkFEM(k, dim))
    p = problem()
    cgm = pt.constraints(p.dirichlet_bctype(), V, device=CPU)
    return V, pt.GridOperator(V, ConvectionDiffusionFEM(p), constraints=cgm)


def dg_go(n, problem=Unit, k=1):
    mesh = pt.StructuredMesh([0, 0], [1, 1], (n, n))
    V = pt.FunctionSpace(mesh, pt.QkDGFEM(k, 2))
    return V, pt.GridOperator(V, ConvectionDiffusionDG(problem(), method=DGMethod.SIPG))


def stencil_setup(cells, k):
    dim = len(cells)
    mesh = pt.StructuredMesh([0] * dim, [1] * dim, cells)
    V = pt.FunctionSpace(mesh, pt.QkFEM(k, dim))
    go = pt.GridOperator(V, ConvectionDiffusionFEM(Problem()),
                         constraints=pt.constraints(True, V, device=CPU))
    st = compile_stencil(go)
    assert st is not None
    return V, go, st


def taylor_hood_go(n=8):
    from dune_pdelab_tpu_torch.ops import TaylorHoodNavierStokes
    from dune_pdelab_tpu_torch.ops.stokes import NavierStokesParameters
    from dune_pdelab_tpu_torch.solvers.stokes import stokes_constraints, taylor_hood_space

    W = taylor_hood_space(pt.StructuredMesh([0, 0], [1, 1], (n, n)), degree=2)
    cgm = stokes_constraints(W, bctype=True, pin_pressure=True, device=CPU)
    return W, pt.GridOperator(W, TaylorHoodNavierStokes(
        NavierStokesParameters(mu=1.0, rho=0.0)), constraints=cgm)


def outflow_go(graft=False):
    """tests/test_windowed.py test_windowed_stokes_outflow_bc (Poiseuille,
    p_out = 1.3, mu = 0.7) or, graft=True, __graft_entry__'s mixed-BC mode
    (traction 1.3 n)."""
    from dune_pdelab_tpu_torch.ops import StokesBC, TaylorHoodNavierStokes
    from dune_pdelab_tpu_torch.ops.stokes import NavierStokesParameters
    from dune_pdelab_tpu_torch.solvers.stokes import taylor_hood_space

    class Outflow(NavierStokesParameters):
        def g(self, x):
            return torch.stack([x[..., 1] * (1 - x[..., 1]), 0.0 * x[..., 0]], dim=-1)

        def bctype(self, x):
            on_wall = (x[..., 1] < 1e-10) | (x[..., 1] > 1 - 1e-10)
            on_out = x[..., 0] > 2.0 - 1e-10
            dirichlet = torch.full_like(x[..., 0], float(StokesBC.VELOCITY_DIRICHLET))
            return torch.where(on_wall, dirichlet, torch.where(
                on_out, torch.full_like(x[..., 0], float(StokesBC.STRESS_NEUMANN)),
                dirichlet))

        def j(self, x, normal):
            return 1.3 * normal

    prm = Outflow(mu=0.7, rho=0.0)
    W = taylor_hood_space(pt.StructuredMesh([0, 0], [2.0, 1], (8, 4)), degree=2)
    cgm = pt.constraints((prm.velocity_bctype(), None), W, device=CPU)
    return W, pt.GridOperator(W, TaylorHoodNavierStokes(prm), constraints=cgm)


def simplex_sipg_go(n=5):
    from dune_pdelab_tpu_torch.fe import PkDGFEM
    sm = pt.SimplexMesh.from_structured(pt.StructuredMesh([0, 0], [1, 1], (n, n)))
    V = pt.FunctionSpace(sm, PkDGFEM(1, 2))
    return V, pt.GridOperator(V, ConvectionDiffusionDG(Problem()))


def adaptive_go(marks1, marks2=None, problem=Problem):
    m = pt.AdaptiveMesh([0, 0], [1, 1], (4, 4))
    for marks in (marks1, marks2):
        if marks is None:
            continue
        sel = np.zeros(m.nelements, bool)
        sel[list(marks)] = True
        m = m.refine(sel)
    V = pt.FunctionSpace(m, pt.QkFEM(1, 2))
    p = problem()
    cgm = pt.constraints(p.dirichlet_bctype(), V, device=CPU)
    assert cgm.has_affine
    return V, pt.GridOperator(V, ConvectionDiffusionFEM(p), constraints=cgm,
                              skip_boundary=True)


def ccfv_go():
    from dune_pdelab_tpu_torch.fe import P0FEM
    from dune_pdelab_tpu_torch.ops.ccfv import ConvectionDiffusionCCFV
    V = pt.FunctionSpace(pt.StructuredMesh([0, 0], [1, 1], (6, 6)), P0FEM(2))
    return V, pt.GridOperator(V, ConvectionDiffusionCCFV(Problem()))


def twophase_go():
    from dune_pdelab_tpu_torch.fe import P0FEM
    from dune_pdelab_tpu_torch.ops.twophase import TwoPhaseCCFV, TwoPhaseParameters

    class Disp(TwoPhaseParameters):
        def is_dirichlet(self, x):
            return (x[..., 0] < 1e-9) | (x[..., 0] > 1 - 1e-9)

        def g_l(self, x):
            return torch.where(x[..., 0] < 0.5, 2.0, 0.0).to(x.dtype)

        def g_g(self, x):
            return torch.full(x.shape[:-1], 1.5, dtype=x.dtype, device=x.device)

    prm = Disp(phi=0.2, K=lambda x: 1.0 + x[..., 0], mu_l=1.0, mu_g=0.2,
               gravity=(0.1, -0.3))
    W = pt.PowerSpace(pt.FunctionSpace(pt.StructuredMesh([0, 0], [1, 1], (12, 12)),
                                       P0FEM(2)), 2)
    return W, pt.GridOperator(W, TwoPhaseCCFV(prm))


GOS = {"cd": lambda n=10, dim=2, k=2: cd_go(n, dim, k),
       "dg": lambda n=12: dg_go(n, Problem),
       "dg_unit": lambda n=8: dg_go(n, Unit),
       "taylor_hood": taylor_hood_go, "outflow": outflow_go,
       "simplex_sipg": simplex_sipg_go, "adaptive": adaptive_go,
       "adaptive_unit": lambda marks: adaptive_go(marks, problem=Unit),
       "ccfv": ccfv_go, "twophase": twophase_go,
       "poisson3d": lambda cells: cd_go_cells(cells)}


def cd_go_cells(cells):
    """__graft_entry__._build_poisson: Q1, f = sin(3x) y + 1, j = 0."""
    class P(ConvectionDiffusionProblem):
        def f(self, x):
            return torch.sin(3.0 * x[..., 0]) * x[..., 1] + 1.0

    dim = len(cells)
    mesh = pt.StructuredMesh([0.0] * dim, [1.0] * dim, cells)
    V = pt.FunctionSpace(mesh, pt.QkFEM(1, dim))
    p = P()
    return V, pt.GridOperator(V, ConvectionDiffusionFEM(p),
                              constraints=pt.constraints(p.dirichlet_bctype(), V, device=CPU))


# ---- window-sharded operators -------------------------------------------------
def residual_jvp(group, case, args=(), cls="windowed", owner=None, seed=0, x_dist=None,
                 unconstrained=False):
    """Sharded residual and J.v of GOS[case] at seeded random x, z (full
    vectors on rank 0); x_dist = (mean, std) draws x from a normal."""
    V, go = GOS[case](*args)
    if isinstance(owner, tuple):
        owner = block_partition(go.mesh, owner)
    Op = {"windowed": WindowShardedGridOperator, "sharded": ShardedGridOperator,
          "novlp": NonoverlappingShardedGridOperator}[cls]
    w = Op(go, group=group, element_owner=owner, device=CPU)
    rng = np.random.default_rng(seed)
    if x_dist is None:
        x = torch.as_tensor(rng.standard_normal(V.ndofs))
    else:
        x = torch.as_tensor(rng.normal(x_dist[0], x_dist[1], V.ndofs))
    z = torch.as_tensor(rng.standard_normal(V.ndofs))
    r = w.residual(x)
    j = w.jacobian_apply(x, z)
    return {"r": _np(r), "j": _np(j), "B": w.B, "W": w.W,
            "npeers": len(w._recv) + len(w._send), "ndofs": V.ndofs}


@rank_task
def window_layout(group, case, args=(), owner=None):
    """The renumbering and every rank's window (compared index for index
    with the reference's WindowShardedGridOperator)."""
    V, go = GOS[case](*args)
    if isinstance(owner, tuple):
        owner = block_partition(go.mesh, owner)
    w = WindowShardedGridOperator(go, group=group, element_owner=owner, device=CPU)
    return {"pi": w._pi, "B": w.B, "NP": w.NP, "wins": w._wins, "mask": w._mask_np}


@rank_task
def roundtrip(group, n=8):
    V, go = cd_go(n=n, k=1)
    w = WindowShardedGridOperator(go, group=group, device=CPU)
    xx = _rng_vec(V.ndofs, 7)
    return _np(w.gather(w.device_put(xx)))


@rank_task
def comm_of_residual(group, n=8):
    """Counters of one padded residual and one padded J.v, and N."""
    V, go = cd_go(n=n, k=1)
    w = WindowShardedGridOperator(go, group=group, device=CPU)
    xp = w.device_put(_rng_vec(V.ndofs, 1))
    pcomm.reset_stats()
    w.residual_padded(xp)
    res = pcomm.stats()
    pcomm.reset_stats()
    w.jacobian_apply_padded(xp, xp)
    jac = pcomm.stats()
    return {"residual": res, "jvp": jac, "N": V.ndofs, "W": w.W, "B": w.B}


@rank_task
def solve_windowed(group, case, args=(), how="krylov", tol=1e-12):
    """CG on the zero-start correction problem: 'krylov' runs linalg.cg on
    the flat sharded J (M = r / d), 'solve_cg' the padded-block solve."""
    V, go = GOS[case](*args)
    w = NonoverlappingShardedGridOperator(go, group=group, device=CPU)
    x0 = V.zero(dtype=F64)
    b = go.residual(x0)
    d = go.jacobian_diagonal(x0)
    if how == "krylov":
        z, s = cg(lambda p: w.jacobian_apply(x0, p), b, M=lambda r: r / d, tol=tol)
    else:
        z, s = w.solve_cg(x0, b, diag=d, tol=tol)
    return {"z": _np(z), "its": int(s.iterations)}


@rank_task
def alias_diag(group):
    V, go = cd_go(n=6, k=1)
    s = ShardedGridOperator(go, group=group, device=CPU)
    d1 = go.jacobian_diagonal(V.zero(dtype=F64))
    d2 = s.jacobian_diagonal(V.zero(dtype=F64))
    return {"sub": issubclass(ShardedGridOperator, WindowShardedGridOperator),
            "diff": float((d1 - d2).norm())}


@rank_task
def config8(group, cells=16, reduction=1e-10):
    """The port's models/configs.py config8_windowed_sharded on every rank
    of the world group (the pool's eight)."""
    from dune_pdelab_tpu_torch.models import ALL_CONFIGS
    assert dist.get_world_size(group) == dist.get_world_size()
    return ALL_CONFIGS["config8"](cells=cells, reduction=reduction, device=CPU)


@rank_task
def adaptive_solve(group):
    V, go = adaptive_go((5, 10))
    w = WindowShardedGridOperator(go, group=group, device=CPU)
    x0 = V.zero(dtype=F64)
    b = go.residual(x0)
    d = go.jacobian_diagonal(x0)
    z, s = w.solve_cg(x0, b, diag=d, tol=1e-12)
    return {"z": _np(z), "its": int(s.iterations)}


@rank_task
def adjoint_gradient(group, n=8, tol=1e-13, maxiter=2000):
    """Adjoint gradients of sum(x(theta)^2) with the residual evaluated
    sequentially and window-sharded (tests/test_windowed.py
    test_windowed_adjoint_gradient_parity; the graft's mode at n = 6)."""
    from dune_pdelab_tpu_torch.solvers import implicit_solve

    mesh = pt.StructuredMesh([0, 0], [1, 1], (n, n))
    V = pt.FunctionSpace(mesh, pt.QkFEM(1, 2))
    cons = pt.constraints(True, V, device=CPU)

    def factory(theta):
        class P(ConvectionDiffusionProblem):
            def A(self, x):
                a = theta[0] + theta[1] * x[..., 0]
                return a[..., None, None] * torch.eye(x.shape[-1], dtype=x.dtype)

            def f(self, x):
                return torch.ones(x.shape[:-1], dtype=x.dtype)
        return ConvectionDiffusionFEM(P())

    def R_seq(x, theta):
        return pt.GridOperator(V, factory(theta), constraints=cons).residual(x)

    def R_shard(x, theta):
        go = pt.GridOperator(V, factory(pcomm.replicated(theta, group)), constraints=cons)
        return WindowShardedGridOperator(go, group=group, device=CPU).residual(x)

    def forward(theta):
        go = pt.GridOperator(V, factory(theta), constraints=cons)
        x0 = torch.zeros(V.ndofs)
        z, _ = cg(lambda p: go.jacobian_apply(x0, p), go.residual(x0), tol=tol,
                  maxiter=maxiter)
        return x0 - z

    out = {}
    for name, R in (("seq", R_seq), ("shard", R_shard)):
        theta = torch.tensor([1.0, 0.5], requires_grad=True)
        f = implicit_solve(R, forward, constraints=cons, adjoint_tol=tol,
                           adjoint_maxiter=maxiter)
        (g,) = torch.autograd.grad(torch.sum(f(theta) ** 2), theta)
        out[name] = _np(g)
    return out


@rank_task
def instationary(group):
    """3 implicit-Euler steps of the heat problem of tests/test_windowed.py
    through window-sharded go0 / go1."""
    from dune_pdelab_tpu_torch.instationary import OneStepMethod, implicit_euler
    from dune_pdelab_tpu_torch.ops import L2
    from dune_pdelab_tpu_torch.solvers import SEQ_CG_Jacobi

    class Heat(Problem):
        def g(self, x):
            return x[..., 0] * 0.0

    p = Heat()
    V = pt.FunctionSpace(pt.StructuredMesh([0, 0], [1, 1], (8, 8)), pt.QkFEM(1, 2))
    cgm = pt.constraints(p.dirichlet_bctype(), V, device=CPU)
    go0 = pt.GridOperator(V, ConvectionDiffusionFEM(p), constraints=cgm)
    go1 = pt.GridOperator(V, L2(), constraints=cgm)

    def run(g0, g1):
        osm = OneStepMethod(implicit_euler(), g0, g1, SEQ_CG_Jacobi(use_stencil=False),
                            pdesolver="newton", reduction=1e-10, max_iterations=20,
                            min_linear_reduction=1e-6)
        x = V.zero(dtype=F64)
        t, dt = 0.0, 0.05
        for _ in range(3):
            x = osm.apply(t, dt, x)
            t += dt
        return _np(x)

    return {"seq": run(go0, go1),
            "par": run(WindowShardedGridOperator(go0, group=group, device=CPU),
                       WindowShardedGridOperator(go1, group=group, device=CPU))}


@rank_task
def newton_nonlinear(group):
    """tests/test_parallel.py test_novlp_newton_nonlinear_parity."""
    from dune_pdelab_tpu_torch.ops.base import LocalOperator
    from dune_pdelab_tpu_torch.solvers import NewtonMethod, SEQ_CG_Jacobi

    class NL(LocalOperator):
        def alpha_volume(self, ctx, u):
            tab = ctx.tab
            gu = self.gradient_at_qp(tab, u)
            uq = self.value_at_qp(tab, u)
            return (self.accumulate_gradient(tab, ctx.factor, gu)
                    + self.accumulate_value(tab, ctx.factor, uq ** 3))

        def lambda_volume(self, ctx):
            ue = torch.sin(np.pi * ctx.x[..., 0]) * torch.sin(np.pi * ctx.x[..., 1])
            f = 2 * np.pi ** 2 * ue + ue ** 3
            return self.accumulate_value(ctx.tab, ctx.factor, -f)

    V = pt.FunctionSpace(pt.StructuredMesh([0, 0], [1, 1], (12, 12)), pt.QkFEM(1, 2))
    go = pt.GridOperator(V, NL(), constraints=pt.constraints(True, V, device=CPU))
    ngo = NonoverlappingShardedGridOperator(go, group=group, device=CPU)
    n = NewtonMethod(ngo, SEQ_CG_Jacobi(), reduction=1e-10, verbose=0)
    x = n.apply(V.zero(dtype=F64))
    return {"x": _np(x), "its": n.result.iterations, "converged": bool(n.result.converged)}


@rank_task
def graft_residual_cg(group):
    """__graft_entry__ mode 1: window-sharded residual and a 5-iteration CG
    correction on the (8, 8, 8) Poisson problem."""
    V, go = cd_go_cells((8, 8, 8))
    s = ShardedGridOperator(go, group=group, device=CPU)
    x0 = V.zero(dtype=F64)
    r = s.residual(x0)
    z, stats = cg(lambda p: s.jacobian_apply(x0, p), r, tol=1e-3, maxiter=5)
    x1 = x0 - z
    return {"r0": float(s.residual(x0).norm()), "r1": float(s.residual(x1).norm()),
            "x1": _np(x1), "its": int(stats.iterations)}


@rank_task
def graft_dg(group):
    """Modes 4 and 7: SIPG on 8^2 with the default partition (residual, a
    CG to 1e-3 in 20 iterations) and on a (n/2, 2) block partition."""
    V, go = dg_go(8, Unit)
    n = dist.get_world_size(group)
    x = _rng_vec(V.ndofs, 0)
    w = NonoverlappingShardedGridOperator(go, group=group, device=CPU)
    z, s = w.solve_cg(V.zero(dtype=F64), go.residual(V.zero(dtype=F64)), tol=1e-3, maxiter=20)
    w2 = WindowShardedGridOperator(go, group=group, device=CPU,
                                   element_owner=block_partition(go.mesh, (n // 2, 2)))
    return {"r": _np(w.residual(x)), "r2": _np(w2.residual(x)), "its": int(s.iterations),
            "z": _np(z)}


@rank_task
def graft_stokes(group, preconditioned):
    """Mode 6: the Taylor-Hood 8^2 J.v and unpreconditioned GMRES(80) to
    1e-5 within 400 iterations; or (preconditioned) mode 6b: GMRES(120)
    with StokesGMGSchur through the sharded operator. The Krylov vectors
    are the full (replicated) ones and the applies the sharded flat J.v:
    modified Gram-Schmidt takes j + 1 dots an iteration, which on padded
    blocks would each be a global reduction."""
    from dune_pdelab_tpu_torch.linalg.krylov import restarted_gmres as gmres
    from dune_pdelab_tpu_torch.solvers.stokes import StokesGMGSchur

    W, go = taylor_hood_go(8)
    w = WindowShardedGridOperator(go, group=group, device=CPU)
    x0 = W.zero(dtype=F64)
    xr = _rng_vec(W.ndofs, 7)
    bs = go.residual(xr)
    if preconditioned:
        M = StokesGMGSchur(W, mu=1.0)(w, x0, 0.0)
        z, s = gmres(lambda p: w.jacobian_apply(x0, p), bs, M=M, tol=1e-5, maxiter=150,
                     restart=120)
        return {"its": int(s.iterations), "z": _np(z)}
    y = w.jacobian_apply(x0, xr)
    z, s = gmres(lambda p: w.jacobian_apply(x0, p), bs, tol=1e-5, maxiter=400, restart=80)
    return {"y": _np(y), "its": int(s.iterations), "z": _np(z)}


@rank_task
def graft_gmg_vcycle(group):
    """Mode 5: ShardedGeometricMultigrid V-cycle on 16^2 Q1, and the
    sequential GeometricMultigrid's cycle."""
    from dune_pdelab_tpu_torch.linalg.multigrid import GeometricMultigrid
    mesh = pt.StructuredMesh([0, 0], [1, 1], (16, 16))
    p = Unit()
    gmg = ShardedGeometricMultigrid(ConvectionDiffusionFEM(p), mesh, pt.QkFEM(1, 2),
                                    bctype=p.dirichlet_bctype(), group=group, device=CPU)
    gmg.setup(dtype=F64)
    seq = GeometricMultigrid(ConvectionDiffusionFEM(p), mesh, pt.QkFEM(1, 2),
                             bctype=p.dirichlet_bctype(), device=CPU)
    seq.setup(dtype=F64)
    r = _rng_vec(gmg.spaces[0].ndofs, 1)
    return {"z": _np(gmg.apply(r)), "z_seq": _np(seq.apply(r))}


# ---- DOF-sharded stencils -------------------------------------------------------
def dof_stencil(group, cells, k, mesh_shape, tol=1e-12, seed=3, maxiter=5000):
    V, go, st = stencil_setup(cells, k)
    sh = DofShardedStencil(st, group=group, mesh_shape=mesh_shape, device=CPU)
    z = _rng_vec(V.ndofs, seed)
    y = sh.gather(sh(sh.device_put(z)))
    x0 = V.zero(dtype=F64)
    b = go.residual(x0)
    d = go.jacobian_diagonal(x0)
    x, s = sharded_cg_solve(sh, b, diag=d, tol=tol, maxiter=maxiter)
    return {"y": _np(y), "x": _np(x), "its": int(s.iterations)}


@rank_task
def graft_dof(group, cells, mesh_shape):
    """Modes 2 and 3 on the graft's Poisson problem: the sharded CG to 1e-6
    (50 iterations at most) and the apply on a 2D rank mesh."""
    V, go = cd_go_cells(cells)
    st = compile_stencil(go)
    x0 = V.zero(dtype=F64)
    b, d = go.residual(x0), go.jacobian_diagonal(x0)
    sh = DofShardedStencil(st, group=group, device=CPU)
    x, s = sharded_cg_solve(sh, b, diag=d, tol=1e-6, maxiter=50)
    sh2 = DofShardedStencil(st, group=group, mesh_shape=mesh_shape, device=CPU)
    return {"x": _np(x), "its": int(s.iterations), "y2": _np(sh2.gather(sh2(sh2.device_put(b))))}


@rank_task
def rebalance_mid_solve(group):
    """10 CG iterations on 4 ranks, the state redistributed to 8 ranks on a
    (4, 2) mesh, the solve finished there (test_rebalance_mid_solve)."""
    V, go, st = stencil_setup((12, 12, 12), 1)
    x0 = V.zero(dtype=F64)
    b, d = go.residual(x0), go.jacobian_diagonal(x0)
    four = dist.new_group([0, 1, 2, 3])
    src = xg = None
    if dist.get_rank() < 4:
        src = DofShardedStencil(st, group=four, device=CPU)
        x_half, _ = sharded_cg_solve(src, b, diag=d, tol=0.0, maxiter=10)
        xg = src.device_put(x_half)
    dst = (rebalance(src, group=group, mesh_shape=(4, 2)) if src is not None
           else DofShardedStencil(st, group=group, mesh_shape=(4, 2), device=CPU))
    moved = redistribute(xg, src, dst)
    x_fin, s = sharded_cg_solve(dst, b, diag=d, tol=1e-11, x0=moved)
    return {"x": _np(x_fin), "its": int(s.iterations)}


@rank_task
def comm_policies(group):
    """Plane exchange policies, allreduce and masked dots (test_comm_policies,
    test_data_handle_policies)."""
    r = dist.get_rank(group)
    nd = dist.get_world_size(group)
    loc = torch.arange(4.0 * r, 4.0 * r + 4)
    out = {}
    for pol in ("copy", "add", "min", "max"):
        prev, nxt = exchange_planes(loc.reshape(-1, 1), group=group, policy=pol)
        out[pol] = (float(prev.reshape(-1)[0]), float(nxt.reshape(-1)[0]))
    loc3 = torch.arange(3.0 * r, 3.0 * r + 3)
    prev, nxt = exchange_planes(loc3, group=group, policy="copy")
    out["copy3"] = (float(prev[0]), float(nxt[0]))
    prev, nxt = exchange_planes(loc3, group=group, policy="min")
    out["min3"] = (float(prev[0]), float(nxt[0]))
    out["all_sum"] = float(allreduce(loc.sum(), group=group))
    out["all_max"] = float(allreduce(loc.max(), group=group, op="max"))
    out["all_min"] = float(allreduce(loc.min(), group=group, op="min"))
    mask = (torch.arange(4 * r, 4 * r + 4) % 2) == 0
    out["masked_dot"] = float(masked_dot(loc, loc, mask, group=group))
    out["nd"] = nd
    return out


# ---- geometric multigrid ----------------------------------------------------------
def gmg_solve(group, n=32):
    """tests/test_parallel.py test_sharded_gmg_iteration_parity, sharded."""
    from dune_pdelab_tpu_torch.solvers import (
        LinearSolverBackend, StationaryLinearProblemSolver,
    )
    p = Problem()
    mesh = pt.StructuredMesh([0, 0], [1, 1], (n, n))
    fem = pt.QkFEM(1, 2)
    V = pt.FunctionSpace(mesh, fem)
    bctype = p.dirichlet_bctype()
    go = pt.GridOperator(V, ConvectionDiffusionFEM(p),
                         constraints=pt.constraints(bctype, V, device=CPU))
    gmg = ShardedGeometricMultigrid(ConvectionDiffusionFEM(p), mesh, fem, bctype=bctype,
                                    group=group, device=CPU)
    slp = StationaryLinearProblemSolver(go, LinearSolverBackend(solver="cg", precond=gmg),
                                        reduction=1e-10, verbose=0)
    x = slp.apply(V.zero(dtype=F64))
    return {"x": _np(x), "its": slp.result.linear_solver_iterations,
            "converged": bool(slp.result.converged)}


@rank_task
def lattice_gmg(group, cells, k=1, mesh_shape=None, gather_below=500, seed=0,
                solve=False, coarsest_cells=2, tol=1e-8, maxiter=50, dtype=F64):
    """ShardedLatticeGMG: one V-cycle on a seeded masked right-hand side
    (and, solve=True, GMG-CG); the counters of the V-cycle."""
    from dune_pdelab_tpu_torch.linalg.gmg_lattice import LatticeGMG
    from dune_pdelab_tpu_torch.parallel.gmg_sharded import ShardedLatticeGMG

    mesh = pt.StructuredMesh([0] * 3, [1] * 3, (cells,) * 3)
    V = pt.FunctionSpace(mesh, pt.QkFEM(k, 3))
    gmg = LatticeGMG(V, ConvectionDiffusionFEM(Lap()), coarsest_cells=coarsest_cells,
                     device=CPU)
    b = torch.as_tensor(np.random.default_rng(seed).standard_normal(V.ndofs), dtype=dtype)
    b = torch.where(gmg.stencils[0].mask, 0.0, b)
    sh = ShardedLatticeGMG(gmg, group=group, mesh_shape=mesh_shape,
                           gather_below=gather_below, device=CPU)
    pcomm.reset_stats()
    z = sh.apply_flat(b)
    out = {"z": _np(z), "z_seq": _np(gmg.apply(b)), "n_sharded": sh.n_sharded,
           "fine": V.ndofs, "coarse_switch": int(np.prod(gmg.dims[sh.n_sharded])),
           "padded": [s.padded_shape for s in sh.sstencils]}
    pcomm.reset_stats()
    sh.apply(sh.device_put(b))
    out["vcycle_stats"] = pcomm.stats()
    if solve:
        xg, info = sh.solve_host(b, tol=tol, maxiter=maxiter)
        out.update(x=_np(sh.gather(xg)), info=info)
    return out


# ---- algebraic multigrid -----------------------------------------------------------
def amg_pair(mesh_kind, n):
    from dune_pdelab_tpu_torch.fe import PkFEM
    from dune_pdelab_tpu_torch.linalg.amg import AlgebraicMultigrid
    if mesh_kind == "simplex":
        mesh = pt.SimplexMesh.from_structured(pt.StructuredMesh([0, 0], [1, 1], (n, n)))
        fem = PkFEM(1, 2)
    else:
        mesh = pt.StructuredMesh([0, 0], [1, 1], (n, n))
        fem = pt.QkFEM(1, 2)
    p = Unit() if mesh_kind == "unit" else AmgProblem()
    V = pt.FunctionSpace(mesh, fem)
    go = pt.GridOperator(V, ConvectionDiffusionFEM(p),
                         constraints=pt.constraints(p.dirichlet_bctype(), V, device=CPU))
    amg = AlgebraicMultigrid().setup_from_grid_operator(go, keep_host=True)
    return V, go, amg


@rank_task
def amg_vcycle(group, mesh_kind, n, seed):
    """The sharded V-cycle and the sequential one on a seeded r."""
    V, go, amg = amg_pair(mesh_kind, n)
    samg = ShardedAMG(amg, group=group, device=CPU)
    r = _rng_vec(V.ndofs, seed)
    return {"shard": _np(samg.apply(r)), "seq": _np(amg.apply(r))}


@rank_task
def amg_cg(group, n=48):
    """CG on go.jacobian_apply with the sharded and the sequential V-cycle."""
    V, go, amg = amg_pair("cube", n)
    samg = ShardedAMG(amg, group=group, device=CPU)
    x0 = V.zero(dtype=F64)
    b = _rng_vec(V.ndofs, 1)
    z1, s1 = cg(lambda q: go.jacobian_apply(x0, q), b, M=amg.apply, tol=1e-10)
    z2, s2 = cg(lambda q: go.jacobian_apply(x0, q), b, M=samg.apply, tol=1e-10)
    return {"its_seq": int(s1.iterations), "its": int(s2.iterations),
            "z_seq": _np(z1), "z": _np(z2)}


@rank_task
def amg_comm(group, n=32):
    """Counters of one sharded V-cycle, with the level sizes."""
    V, go, amg = amg_pair("cube", n)
    samg = ShardedAMG(amg, group=group, device=CPU)
    rp = samg.device_put(_rng_vec(V.ndofs, 5))
    pcomm.reset_stats()
    samg.apply_padded(rp)
    return {"stats": pcomm.stats(), "sizes": samg.sizes, "ndev": samg.ndev}


@rank_task
def amg_from_go(group, n=24):
    mesh = pt.StructuredMesh([0, 0], [1, 1], (n, n))
    p = AmgProblem()
    V = pt.FunctionSpace(mesh, pt.QkFEM(1, 2))
    go = pt.GridOperator(V, ConvectionDiffusionFEM(p),
                         constraints=pt.constraints(p.dirichlet_bctype(), V, device=CPU))
    samg = ShardedAMG.from_grid_operator(go, group=group, device=CPU)
    r = _rng_vec(V.ndofs, 4)
    z = samg.apply(r)
    return {"shape": tuple(z.shape), "rz": float(torch.dot(r, z)),
            "levels": len(samg.sizes)}


@rank_task
def amg_solve(group, n=48):
    """ShardedAMG.solve_cg against CG on the dense level-0 matrix with the
    sequential V-cycle."""
    V, go, amg = amg_pair("cube", n)
    samg = ShardedAMG(amg, group=group, device=CPU)
    b = go.residual(V.zero(dtype=F64))
    A = torch.as_tensor(amg.host_levels[0][0].toarray())
    z1, s1 = cg(lambda q: A @ q, b, M=amg.apply, tol=1e-11)
    z2, s2 = samg.solve_cg(b, tol=1e-11)
    return {"its_seq": int(s1.iterations), "its": int(s2.iterations),
            "z_seq": _np(z1), "z": _np(z2)}


@rank_task
def fail_on(group, rank):
    """Raises on one rank (the launcher must report it)."""
    if dist.get_rank(group) == rank:
        raise ValueError(f"rank {rank} fails on purpose")
    return dist.get_rank(group)
