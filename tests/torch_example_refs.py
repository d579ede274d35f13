"""The JAX package's halves of tests/test_torch_examples.py: each function
rebuilds one reference script's computation (examples/NN_*.py) at a test
size and returns its printed numbers as plain Python and numpy values.

They run in worker processes (spawned, so JAX starts clean there) while
the tests run the port's examples; `init` is each worker's initializer.
The scripts' problem classes are reused through importlib where importing
the script does nothing beyond enabling x64 (01-06, 09, 10, 13); 11, 12
and 15 set other JAX options at import, so their problems are copied here.
"""
import importlib.util
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def init():
    """Worker start: JAX on the CPU in fp64, as tests/conftest.py sets it."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)


def ref_script(name):
    """The reference script examples/<name>.py as a module (its main() is
    not run)."""
    spec = importlib.util.spec_from_file_location(f"_ref_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _stationary(go, solver, x0, reduction):
    import dune_pdelab_tpu as jpt
    slp = jpt.StationaryLinearProblemSolver(go, solver, reduction=reduction, verbose=0)
    return slp.apply(x0), slp.result.linear_solver_iterations


def ex01(cells):
    import jax.numpy as jnp
    import dune_pdelab_tpu as jpt
    from dune_pdelab_tpu.ops import ConvectionDiffusionFEM
    from dune_pdelab_tpu.solvers import SEQ_CG_Jacobi
    from dune_pdelab_tpu.space.functions import l2_difference

    prob = ref_script("01_poisson").Problem()
    V = jpt.FunctionSpace(jpt.StructuredMesh([0, 0], [1, 1], (cells, cells)), jpt.QkFEM(2, 2))
    cg = jpt.constraints(prob.dirichlet_bctype(), V)
    go = jpt.GridOperator(V, ConvectionDiffusionFEM(prob), constraints=cg)
    x0 = jpt.interpolate_dirichlet(lambda q: np.asarray(prob.g(jnp.asarray(q))), V, cg, V.zero())
    x, its = _stationary(go, SEQ_CG_Jacobi(), x0, 1e-10)
    return {"ndofs": V.ndofs, "iterations": its,
            "l2_error": float(l2_difference(V, x, prob.exact))}


def ex02(sizes):
    import dune_pdelab_tpu as jpt
    from dune_pdelab_tpu.fe import QkDGFEM
    from dune_pdelab_tpu.ops.convectiondiffusiondg import ConvectionDiffusionDG
    from dune_pdelab_tpu.solvers import LinearSolverBackend
    from dune_pdelab_tpu.space.functions import l2_difference

    prob = ref_script("02_convectiondiffusion_dg").Problem()
    errs, its = [], []
    for n in sizes:
        V = jpt.FunctionSpace(jpt.StructuredMesh([0, 0], [1, 1], (n, n)), QkDGFEM(1, 2))
        go = jpt.GridOperator(V, ConvectionDiffusionDG(prob, penalty=2.0))
        ls = LinearSolverBackend(solver="bicgstab", precond="block_jacobi", maxiter=2000)
        x, it = _stationary(go, ls, V.zero(), 1e-10)
        errs.append(float(l2_difference(V, x, prob.exact)))
        its.append(it)
    return {"iterations": its, "l2_errors": errs, "order": float(np.log2(errs[-2] / errs[-1]))}


def ex03(cells):
    import dune_pdelab_tpu as jpt
    from dune_pdelab_tpu.solvers import NewtonMethod, SEQ_CG_Jacobi
    from dune_pdelab_tpu.space.functions import l2_difference

    ref = ref_script("03_nonlinear_newton")
    V = jpt.FunctionSpace(jpt.StructuredMesh([0, 0], [1, 1], (cells, cells)), jpt.QkFEM(1, 2))
    cg = jpt.constraints(True, V)
    go = jpt.GridOperator(V, ref.NonlinearPoisson(), constraints=cg)
    newton = NewtonMethod(go, SEQ_CG_Jacobi(), reduction=1e-10, verbose=0,
                          reassemble_threshold=0.0)
    x = newton.apply(jpt.interpolate_dirichlet(ref.u_exact, V, cg, V.zero()))
    return {"newton_iterations": newton.result.iterations,
            "l2_error": float(l2_difference(V, x, ref.u_exact))}


def ex04(cells, T, dt=1e-3):
    import jax.numpy as jnp
    import dune_pdelab_tpu as jpt
    from dune_pdelab_tpu.instationary import OneStepMethod, crank_nicolson
    from dune_pdelab_tpu.ops import ConvectionDiffusionFEM
    from dune_pdelab_tpu.ops.l2 import L2
    from dune_pdelab_tpu.solvers import SEQ_CG_Jacobi
    from dune_pdelab_tpu.space.functions import l2_difference

    ref = ref_script("04_instationary_heat")
    V = jpt.FunctionSpace(jpt.StructuredMesh([0, 0], [1, 1], (cells, cells)), jpt.QkFEM(1, 2))
    cg = jpt.constraints(True, V)
    osm = OneStepMethod(crank_nicolson(),
                        jpt.GridOperator(V, ConvectionDiffusionFEM(ref.Heat()), constraints=cg),
                        jpt.GridOperator(V, L2(), constraints=cg), SEQ_CG_Jacobi(),
                        pdesolver="linear", reduction=1e-11)
    x = V.interpolate(lambda p: ref.u_exact(np.atleast_2d(p), 0.0))
    t, steps = 0.0, 0
    while t < T - 1e-12:
        x = osm.apply(t, dt, x)
        t += dt
        steps += 1
    return {"t": t, "steps": steps,
            "l2_error": float(l2_difference(V, x, lambda p: ref.u_exact(p, t))),
            "max_u": float(jnp.max(jnp.abs(x)))}


def ex05(cells):
    import jax.numpy as jnp
    import dune_pdelab_tpu as jpt
    from dune_pdelab_tpu.ops.stokes import NavierStokesParameters, TaylorHoodNavierStokes
    from dune_pdelab_tpu.solvers import LinearSolverBackend
    from dune_pdelab_tpu.solvers.stokes import (
        StokesBlockJacobi, stokes_constraints, taylor_hood_space,
    )

    ref_script("05_stokes_taylor_hood")        # imports cleanly; its main() holds lid_u
    W = taylor_hood_space(jpt.StructuredMesh([0, 0], [1, 1], (cells, cells)), degree=2)
    cg = stokes_constraints(W, bctype=True, pin_pressure=True)
    go = jpt.GridOperator(W, TaylorHoodNavierStokes(NavierStokesParameters(mu=1.0, rho=0.0)),
                          constraints=cg)

    def lid_u(p):
        p = np.atleast_2d(p)
        ux = np.where(np.isclose(p[:, 1], 1.0), 4.0 * p[:, 0] * (1.0 - p[:, 0]), 0.0)
        return np.stack([ux, np.zeros_like(ux)], axis=-1)

    x0 = W.interpolate((lid_u, lambda p: np.zeros(len(np.atleast_2d(p)))))
    x0 = jnp.where(cg.mask, x0, 0.0)
    ls = LinearSolverBackend(solver="gmres", precond=StokesBlockJacobi(W), restart=100,
                             maxiter=20000)
    x, its = _stationary(go, ls, x0, 1e-7)
    u, p = W.restrict(x, 0), W.restrict(x, 1)
    return {"ndofs_u": int(u.shape[0]), "ndofs_p": int(p.shape[0]), "iterations": its,
            "max_u": float(jnp.max(jnp.abs(u))), "mean_p": float(jnp.mean(p))}


def ex15(cells):
    import jax.numpy as jnp
    import dune_pdelab_tpu as jpt
    from dune_pdelab_tpu.assembly.stencil import compile_stencil
    from dune_pdelab_tpu.linalg.gmg_lattice import LatticeGMG
    from dune_pdelab_tpu.ops import ConvectionDiffusionFEM, ConvectionDiffusionProblem
    from dune_pdelab_tpu.solvers.refinement import refine_solve

    class P(ConvectionDiffusionProblem):       # examples/15's problem, copied
        def f(self, x):
            return jnp.ones(x.shape[:-1], x.dtype)

    p = P()
    V = jpt.FunctionSpace(jpt.StructuredMesh([0, 0, 0], [1, 1, 1], (cells,) * 3), jpt.QkFEM(1, 3))
    lop = ConvectionDiffusionFEM(p)
    go = jpt.GridOperator(V, lop, constraints=jpt.constraints(p.dirichlet_bctype(), V),
                          skip_boundary=True)
    b = -go.residual(jnp.zeros(V.ndofs, jnp.float64))
    st = compile_stencil(go)
    gmg = LatticeGMG(V, lop, fine_stencil=st)
    _, info = gmg.solve_host(b, tol=1e-8)
    _, stats = refine_solve(st, lambda r32: gmg.solve_host(r32, tol=1e-4, maxiter=30)[0], b,
                            tol=1e-8)
    return {"levels": gmg.nlevels, "iterations": info["iterations"],
            "true_rel": float(info["true_defect"] / info["defect0"]),
            "refine_sweeps": int(stats.outer_iterations)}


def ex09(darcy_cells, pme_cells):
    import dune_pdelab_tpu as jpt
    from dune_pdelab_tpu.fe import P0FEM
    from dune_pdelab_tpu.ops import ConvectionDiffusionCCFV, NonlinearConvectionDiffusionFEM
    from dune_pdelab_tpu.solvers import NewtonMethod, SEQ_CG_Jacobi
    from dune_pdelab_tpu.space.functions import l2_difference

    ref = ref_script("09_darcy_porous_media")
    n, m = darcy_cells, pme_cells
    V = jpt.FunctionSpace(jpt.StructuredMesh([0, 0], [1, 1], (n, n)), P0FEM(2))
    head, its = _stationary(jpt.GridOperator(V, ConvectionDiffusionCCFV(ref.QuarterFiveSpot())),
                            SEQ_CG_Jacobi(), V.zero(), 1e-12)
    pm = ref.PorousMedium()
    W = jpt.FunctionSpace(jpt.StructuredMesh([0, 0], [1, 1], (m, m)), jpt.QkFEM(1, 2))
    cg = jpt.constraints(pm.dirichlet_bctype(), W)
    go = jpt.GridOperator(W, NonlinearConvectionDiffusionFEM(pm), constraints=cg)
    xc = W.interpolate(lambda pts: np.full(len(pts), pm.C))
    newton = NewtonMethod(go, SEQ_CG_Jacobi(), reduction=1e-11, verbose=0)
    x = newton.apply(jpt.interpolate_dirichlet(pm.g, W, cg, xc))
    return {"iterations": its, "head": np.asarray(head),
            "pme_newton_iterations": newton.result.iterations,
            "pme_l2_error": float(l2_difference(W, x, pm.exact))}


def ex10(nx, T):
    import jax.numpy as jnp
    import dune_pdelab_tpu as jpt
    from dune_pdelab_tpu.fe import QkDGFEM
    from dune_pdelab_tpu.instationary import CFLTimeController, ExplicitOneStepMethod, shu3
    from dune_pdelab_tpu.ops import L2
    from dune_pdelab_tpu.ops.acoustics import LinearAcousticsDG
    from dune_pdelab_tpu.space.space import PowerSpace

    ref_script("10_acoustics_explicit_rk")     # imports cleanly; its problem is in main()
    mesh = jpt.StructuredMesh([0, 0], [2, 1], (nx, 2), periodic=(False, True))
    leaf = jpt.FunctionSpace(mesh, QkDGFEM(1, 2))
    Q = PowerSpace(leaf, 3)
    go0 = jpt.GridOperator(Q, LinearAcousticsDG(c=lambda x: jnp.where(x[..., 0] < 1.0, 1.0, 2.0),
                                                bc="absorb", cmax=2.0))
    osm = ExplicitOneStepMethod(shu3(), go0, jpt.GridOperator(Q, L2()))

    def g(x):
        return np.exp(-((x - 0.5) / 0.08) ** 2)

    x = Q.interpolate((lambda p: g(p[:, 0]), lambda p: g(p[:, 0]), lambda p: np.zeros(len(p))))
    ctrl = CFLTimeController(0.35, go0)
    t, dt0, steps = 0.0, 0.2 / (nx / 2 * 3 * 2.0), 0
    while t < T - 1e-12:
        dt = min(ctrl.suggest_timestep(t, dt0, x), T - t)
        t, x = osm.solve(t, dt, min(t + 10 * dt, T), x)
        steps += 10
    coords = np.asarray(leaf.dof_coords())
    pv = np.abs(np.asarray(Q.restrict(x, 0)))
    sel = coords[:, 0] > 1.1
    return {"t": t, "steps": steps, "reflection": float(pv[coords[:, 0] < 0.85].max()),
            "peak_x": float(coords[sel][np.argmax(pv[sel]), 0]), "amplitude": float(pv[sel].max())}


def ex13(cells, tend, dt=2e-3):
    import jax.numpy as jnp
    import dune_pdelab_tpu as jpt
    from dune_pdelab_tpu.fe import P0FEM
    from dune_pdelab_tpu.instationary import OneStepMethod, implicit_euler
    from dune_pdelab_tpu.ops import TwoPhaseCCFV, TwoPhaseStorage
    from dune_pdelab_tpu.solvers import SEQ_BCGS_Jacobi
    from dune_pdelab_tpu.space.space import PowerSpace

    prm = ref_script("13_twophase_flow").Reservoir()
    mesh = jpt.StructuredMesh([0, 0], [1, 1], (cells, cells))
    W = PowerSpace(jpt.FunctionSpace(mesh, P0FEM(2)), 2)
    go1 = jpt.GridOperator(W, TwoPhaseStorage(prm))
    osm = OneStepMethod(implicit_euler(), jpt.GridOperator(W, TwoPhaseCCFV(prm)), go1,
                        SEQ_BCGS_Jacobi(), pdesolver="newton", reduction=1e-7,
                        max_iterations=50, min_linear_reduction=1e-4,
                        line_search_accept_best=True, verbose=0)
    E = mesh.nelements
    x0 = jnp.concatenate([jnp.zeros(E), jnp.full(E, 1.3)])
    t, x = osm.solve(0.0, dt, tend, x0, max_step_retries=6)
    m0 = np.asarray(go1.residual_unconstrained(x0))
    m1 = np.asarray(go1.residual_unconstrained(x))
    return {"t": t, "failed_steps": osm.result.failed_steps,
            "newton_iterations": osm.result.total_newton_iterations, "x": np.asarray(x),
            "liquid_gain": float(m1[:E].sum() - m0[:E].sum()),
            "gas_change": float(m1[E:].sum() - m0[E:].sum())}


def _l_shape_space(start):
    import dune_pdelab_tpu as jpt
    from dune_pdelab_tpu.fe.basis import PkFEM
    from dune_pdelab_tpu.mesh.simplex import SimplexMesh

    sq = SimplexMesh.from_structured(jpt.StructuredMesh([-1, -1], [1, 1], (start, start)))
    c = sq.element_centers()
    return jpt.FunctionSpace(sq.submesh(~((c[:, 0] > 0) & (c[:, 1] < 0))).oriented_for_bisection(),
                             PkFEM(1, 2))


def ex06(start, cycles):
    from dune_pdelab_tpu.adaptivity.adaptivity import error_fraction, mark_elements
    from dune_pdelab_tpu.adaptivity.local import adapt_local_simplex, p1_edge_jump_indicator
    from dune_pdelab_tpu.space.functions import l2_difference

    ref = ref_script("06_adaptive_lshape")
    V = _l_shape_space(start)
    x = ref.solve(V)
    ns, errs = [], []
    for _ in range(cycles):
        ns.append(V.ndofs)
        errs.append(float(l2_difference(V, x, ref.u_exact)))
        eta2 = p1_edge_jump_indicator(V, x)
        marks, _ = mark_elements(eta2, error_fraction(eta2, 0.5))
        V, x = adapt_local_simplex(V, x, marks)
        x = ref.solve(V)
    ns.append(V.ndofs)
    errs.append(float(l2_difference(V, x, ref.u_exact)))
    return {"ndofs": ns, "l2_errors": errs}


def ex12(start, levels):
    import jax.numpy as jnp
    import dune_pdelab_tpu as jpt
    from dune_pdelab_tpu.adaptivity import (
        dwr_indicators, error_fraction, mark_elements, space_transfer,
    )
    from dune_pdelab_tpu.adaptivity.local import adapt_local_simplex
    from dune_pdelab_tpu.fe.basis import PkFEM
    from dune_pdelab_tpu.ops import ConvectionDiffusionFEM, ConvectionDiffusionProblem
    from dune_pdelab_tpu.ops.l2 import L2
    from dune_pdelab_tpu.solvers import SEQ_CG_Jacobi

    # examples/12's goal and problem, copied (its import sets jax_platforms)
    center, radius = np.array([-0.5, 0.5]), 0.3
    u_exact = ref_script("06_adaptive_lshape").u_exact

    class Corner(ConvectionDiffusionProblem):
        def f(self, x):
            return jnp.zeros(x.shape[:-1])

        def g(self, x):
            return jnp.asarray(u_exact(np.atleast_2d(np.asarray(x))))

    def chi(x):
        x = jnp.asarray(x)
        d2 = jnp.sum((x - jnp.asarray(center, x.dtype)) ** 2, axis=-1)
        s = jnp.maximum(0.0, 1.0 - d2 / radius**2)
        return s * s

    n = 600
    h = 2 * radius / n
    gx = center[0] - radius + h * (np.arange(n) + 0.5)
    gy = center[1] - radius + h * (np.arange(n) + 0.5)
    X, Y = np.meshgrid(gx, gy, indexing="ij")
    pts = np.stack([X.ravel(), Y.ravel()], axis=1)
    J = float(np.sum(np.asarray(chi(pts)) * u_exact(pts)) * h * h)

    V = _l_shape_space(start)
    ns, errs, ests = [], [], []
    for _ in range(levels):
        cgm = jpt.constraints(True, V)
        go = jpt.GridOperator(V, ConvectionDiffusionFEM(Corner()), constraints=cgm)
        x0 = jpt.interpolate_dirichlet(lambda q: u_exact(np.atleast_2d(q)), V, cgm, V.zero())
        x, _ = _stationary(go, SEQ_CG_Jacobi(), x0, 1e-12)
        Vr = jpt.FunctionSpace(V.mesh, PkFEM(2, 2))
        gor = jpt.GridOperator(Vr, ConvectionDiffusionFEM(Corner()),
                               constraints=jpt.constraints(True, Vr))
        q = jpt.GridOperator(Vr, L2(scale=chi)).jacobian_apply(Vr.zero(), jnp.ones(Vr.ndofs))

        def goal(u):
            return jnp.dot(q, u)

        errs.append(J - float(goal(space_transfer(V, Vr)(x))))
        eta, est = dwr_indicators(go, gor, x, goal, tol=1e-12)
        ests.append(float(est))
        ns.append(V.ndofs)
        marks, _ = mark_elements(np.asarray(eta), error_fraction(np.asarray(eta), 0.7))
        V, x = adapt_local_simplex(V, x, marks)
    return {"J": J, "ndofs": ns, "true_errors": errs, "estimates": ests}


def ex11(cells, theta_true, theta_start):
    import jax
    import jax.numpy as jnp
    import dune_pdelab_tpu as jpt
    from dune_pdelab_tpu.ops import ConvectionDiffusionFEM, ConvectionDiffusionProblem
    from dune_pdelab_tpu.solvers import differentiable_stationary_solve

    def factory(theta):                        # examples/11's factory, copied
        class P(ConvectionDiffusionProblem):
            def A(self, x):
                a = (theta[0] + theta[1] * x[..., 0] + theta[2] * x[..., 1]
                     + theta[3] * x[..., 0] * x[..., 1])
                return a[..., None, None] * jnp.eye(x.shape[-1], dtype=x.dtype)

            def f(self, x):
                return jnp.ones(x.shape[:-1], x.dtype)
        return ConvectionDiffusionFEM(P())

    V = jpt.FunctionSpace(jpt.StructuredMesh([0, 0], [1, 1], (cells, cells)), jpt.QkFEM(1, 2))
    solve = differentiable_stationary_solve(V, factory, constraints=jpt.constraints(True, V),
                                            solver="cg", tol=1e-13)
    x_obs = solve(jnp.array(theta_true))
    v0, g0 = jax.value_and_grad(lambda t: jnp.sum((solve(t) - x_obs) ** 2))(
        jnp.array(theta_start))
    return {"misfit0": float(v0), "grad0": np.asarray(g0)}


# ---- the multi-rank examples' sequential halves (tests/test_torch_examples_parallel.py)
def ex07(cells, tol=1e-11):
    """examples/07's problem, copied (the script sets XLA_FLAGS at import):
    the sequential Jacobi-CG solve the sharded one is held to."""
    import jax.numpy as jnp
    import dune_pdelab_tpu as jpt
    from dune_pdelab_tpu.ops import ConvectionDiffusionFEM, ConvectionDiffusionProblem
    from dune_pdelab_tpu.solvers import SEQ_CG_Jacobi
    from dune_pdelab_tpu.space.functions import l2_difference

    class Problem(ConvectionDiffusionProblem):
        def exact(self, p):
            return np.sin(np.pi * p[:, 0]) * np.cos(2 * np.pi * p[:, 1]) + p[:, 0]

        def f(self, x):
            return 5 * np.pi ** 2 * jnp.sin(np.pi * x[..., 0]) * jnp.cos(2 * np.pi * x[..., 1])

        def g(self, x):
            return jnp.sin(np.pi * x[..., 0]) * jnp.cos(2 * np.pi * x[..., 1]) + x[..., 0]

    prob = Problem()
    V = jpt.FunctionSpace(jpt.StructuredMesh([0, 0], [1, 1], (cells, cells)), jpt.QkFEM(1, 2))
    cg = jpt.constraints(prob.dirichlet_bctype(), V)
    go = jpt.GridOperator(V, ConvectionDiffusionFEM(prob), constraints=cg)
    x0 = jpt.interpolate_dirichlet(lambda q: np.asarray(prob.g(jnp.asarray(q))), V, cg, V.zero())
    x, its = _stationary(go, SEQ_CG_Jacobi(), x0, tol)
    return {"ndofs": V.ndofs, "iterations": its, "x": np.asarray(x),
            "l2_error": float(l2_difference(V, x, prob.exact))}


def ex08(cells):
    """examples/08's problem and solver, copied (the script sets XLA_FLAGS):
    Jacobi-preconditioned GMRES(150) to 1e-7 on full vectors."""
    import jax
    import jax.numpy as jnp
    import dune_pdelab_tpu as jpt
    from dune_pdelab_tpu.linalg.krylov import restarted_gmres as gmres
    from dune_pdelab_tpu.ops import TaylorHoodNavierStokes
    from dune_pdelab_tpu.ops.stokes import NavierStokesParameters
    from dune_pdelab_tpu.solvers.stokes import stokes_constraints, taylor_hood_space

    def a(x):
        return x**2 * (1 - x) ** 2

    def da(x):
        return 2 * x * (1 - x) * (1 - 2 * x)

    def dda(x):
        return 12 * x**2 - 12 * x + 2

    def ddda(x):
        return 24 * x - 12

    class Manufactured(NavierStokesParameters):
        def __init__(self):
            super().__init__(mu=1.0, rho=0.0)

        def f(self, x):
            xx, yy = x[..., 0], x[..., 1]
            f1 = -(dda(xx) * da(yy) + a(xx) * ddda(yy)) + 3 * xx**2
            f2 = (ddda(xx) * a(yy) + da(xx) * dda(yy)) + 3 * yy**2
            return jnp.stack([f1, f2], axis=-1)

    W = taylor_hood_space(jpt.StructuredMesh([0, 0], [1, 1], (cells, cells)), degree=2)
    cg = stokes_constraints(W, bctype=True, pin_pressure=True)
    go = jpt.GridOperator(W, TaylorHoodNavierStokes(Manufactured()), constraints=cg)
    x0 = W.zero()
    b = go.residual(x0)
    diag = np.asarray(go.jacobian_diagonal(x0))
    d = jnp.asarray(np.where(np.abs(diag) > 1e-12, diag, 1.0))
    z, stats = jax.jit(lambda b: gmres(lambda p: go.jacobian_apply(x0, p), b, M=lambda r: r / d,
                                       tol=1e-7, maxiter=2000, restart=150))(b)
    x = x0 - z
    Vv = W.children[0].children[0]
    vx = W.children[0].restrict(W.restrict(x, 0), 0)
    vex = Vv.interpolate(lambda p: a(p[:, 0]) * da(p[:, 1]))
    return {"ndofs": W.ndofs, "iterations": int(stats.iterations),
            "converged": bool(stats.converged), "x": np.asarray(x),
            "vx_error": float(jnp.max(jnp.abs(vx - vex)))}


def ex14(cells):
    """examples/14 on its structured stand-in mesh, copied (the script sets
    XLA_FLAGS): the P1/P2 AMG and Jacobi iterations, the DG two-level's
    and the AMG-CG solve the sharded one is held to."""
    import jax.numpy as jnp
    import dune_pdelab_tpu as jpt
    from dune_pdelab_tpu.fe import PkDGFEM, PkFEM
    from dune_pdelab_tpu.linalg import AlgebraicMultigrid, DGTwoLevel
    from dune_pdelab_tpu.linalg.krylov import cg
    from dune_pdelab_tpu.mesh import SimplexMesh
    from dune_pdelab_tpu.ops import ConvectionDiffusionFEM, ConvectionDiffusionProblem
    from dune_pdelab_tpu.ops.convectiondiffusiondg import ConvectionDiffusionDG, DGMethod
    from dune_pdelab_tpu.solvers import LinearSolverBackend, SEQ_CG_AMG, SEQ_CG_Jacobi

    class Heated(ConvectionDiffusionProblem):
        def f(self, x):
            return jnp.ones(x.shape[:-1], x.dtype)

    p = Heated()
    mesh = SimplexMesh.from_structured(jpt.StructuredMesh([0, 0], [1, 1], (cells, cells)))
    out = {}
    for k in (1, 2):
        V = jpt.FunctionSpace(mesh, PkFEM(k, 2))
        go = jpt.GridOperator(V, ConvectionDiffusionFEM(p),
                              constraints=jpt.constraints(p.dirichlet_bctype(), V))
        _, amg = _stationary(go, SEQ_CG_AMG(), V.zero(), 1e-10)
        _, jac = _stationary(go, SEQ_CG_Jacobi(), V.zero(), 1e-10)
        out[f"p{k}"] = {"ndofs": V.ndofs, "amg": amg, "jacobi": jac}
        if k == 1:
            V1, go1 = V, go
    Vdg = jpt.FunctionSpace(mesh, PkDGFEM(1, 2))
    godg = jpt.GridOperator(Vdg, ConvectionDiffusionDG(p, method=DGMethod.SIPG))
    tl = DGTwoLevel(godg, ConvectionDiffusionFEM(p))
    _, its = _stationary(godg, LinearSolverBackend(solver="cg", precond=tl, use_stencil=False),
                         Vdg.zero(), 1e-10)
    out["dg"] = {"ndofs": Vdg.ndofs, "coarse": tl.coarse_kind, "iterations": its}
    amg = AlgebraicMultigrid().setup_from_grid_operator(go1, keep_host=True)
    b = go1.residual(V1.zero())
    _, ss = cg(lambda q: go1.jacobian_apply(V1.zero(), q), b, M=amg.apply, tol=1e-10)
    out["amg_cg"] = int(ss.iterations)
    return out
