#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (dune_pdelab_tpu_torch) on one H100.

Run from the repository root on a machine with a Hopper card:

    python3 chip_smoke.py

Phases (each passes or raises; there is no CPU path):
  1. build the hand-written CUDA kernels from dune_pdelab_tpu_torch/csrc;
  2. each kernel against its plain PyTorch version on the card, with kernel
     and plain times: stencil27 and the fused-CG pair at 128^3, at an
     unaligned (67, 45, 33) grid (fp32 and fp64) and at the main path's
     512^3 grid (fp32); structured_fused (fp32) at 512^3 cells and at a
     ragged 66x44x32 cells, residual and Jacobian-apply modes, for a
     field-A problem and a tensor-A + b + c + f problem (and fp64 at the
     ragged size);
  3. the main path at full size: 3D Poisson Q1, 511 cells per axis
     (N = 134,217,728 DOFs), fp32: mesh -> space -> constraints ->
     GridOperator -> slabbed RHS -> compile_stencil (proxy branch) ->
     make_fused_cg for 50 iterations, checked against the true residual and
     against a plain CG on the same operator;
  4. the README entry point, StationaryLinearProblemSolver + SEQ_CG_Jacobi at
     127 cells, in fp32 and fp64 (fp64 checked against a plain CG);
  5. the multigrid routes: (a) LatticeGMG-CG solve_host at 512^3 cells,
     fp32, tol 1e-8 (bench.py:641-714); (b) fp64 defect correction around
     it to a true relative defect of 1e-8 (bench.py:478-560); (c)
     VarCoeffGMG on the fused structured operator at 256^3 and 512^3
     cells (bench.py:562-639); (d) the config13_scale_lattice_gmg golden at
     128^3 in fp64 (models/configs.py:525-562, without its sharded check),
     held against tests/golden_parity.json.

Launch counts are set to 0 before each of phases 3, 4 and 5 and read after
it; a kernel of that path that was never launched fails the run. Prints
phase results and times, the card's name and power limit, one JSON line
{"kernels": [...]} with each kernel's launches over phases 3-5, error and
times, and as its last line {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
MAIN_CELLS = 511      # cells per axis of the main path: N = 512^3 DOFs
MAIN_ITERS = 50       # fused-CG iterations at tol = 0
README_CELLS = 127    # README entry point: 2,097,152 DOFs
MG_CELLS = 512        # multigrid routes: cells per axis (even, so it coarsens)
VAR_CELLS = (256, 512)
FUSED_CELLS = [(512, 512, 512), (66, 44, 32)]   # structured_fused checks
C13_CELLS = 128       # config13 golden


def log(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def cuda_ms(torch, fn, reps):
    """Mean milliseconds of fn() over reps launches, timed with CUDA events
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def q1_laplace_taps(h):
    """(3, 3, 3) taps of the 3D Q1 Laplacian on a cube of side h."""
    import numpy as np
    w = np.zeros((3, 3, 3))
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                nnz = abs(dx) + abs(dy) + abs(dz)
                w[dz + 1, dy + 1, dx + 1] = {0: 8 / 3, 1: 0.0, 2: -1 / 6,
                                             3: -1 / 12}[nnz] * h
    return w


def phase_kernels(torch, dims_list, main_dims, dev):
    """Phase 2: kernels against plain versions on the card."""
    import numpy as np
    from dune_pdelab_tpu_torch.kernels import fused_cg as fk
    from dune_pdelab_tpu_torch.kernels import stencil27 as sk

    rng = np.random.default_rng(2024)
    record = {}
    for dims, dtype in dims_list:
        nx, ny, nz = dims
        tag = f"{nx}x{ny}x{nz} {str(dtype).replace('torch.', '')}"
        w27 = q1_laplace_taps(1.0 / (nx - 1)) * (1 + 0.1 * rng.standard_normal((3, 3, 3)))
        tol = 1e-6 if dtype == torch.float32 else 1e-13
        dtol = 1e-5 if dtype == torch.float32 else 1e-12
        faces = torch.zeros((nz, ny, nx), dtype=torch.bool, device=dev)
        faces[0] = faces[-1] = True
        faces[:, 0] = faces[:, -1] = True
        faces[:, :, 0] = faces[:, :, -1] = True
        mask = faces.reshape(-1)

        def rand():
            v = torch.as_tensor(rng.standard_normal((nz, ny, nx)), dtype=dtype,
                                device=dev)
            return torch.where(faces, 0.0, v)

        def err(a, b):
            e = float((a - b).abs().max())
            lim = tol * float(b.abs().max())
            if not e <= lim:
                raise AssertionError(f"{tag}: max abs err {e:.3e} > {lim:.3e}")
            return e

        def rel(a, b):
            e = abs(float(a) - float(b)) / abs(float(b))
            if not e <= dtol:
                raise AssertionError(f"{tag}: dot rel err {e:.3e} > {dtol:.1e}")
            return e

        z = torch.as_tensor(rng.standard_normal(nx * ny * nz), dtype=dtype, device=dev)
        e_st = err(sk.stencil27(z, mask, w27, dims), sk.stencil27_reference(z, mask, w27, dims))

        r, p, x = rand(), rand(), rand()
        beta = torch.tensor(0.37, dtype=dtype, device=dev)
        alpha = torch.tensor(0.21, dtype=dtype, device=dev)
        pn, pap = fk.fused_cg_k1(r, p, beta, w27)
        pn_p, pap_p = fk.fused_cg_k1_reference(r, p, beta, w27)
        e_k1, d_k1 = err(pn, pn_p), rel(pap, pap_p)
        xn, rn, rr = fk.fused_cg_k2(x, r, p, alpha, w27)
        xn_p, rn_p, rr_p = fk.fused_cg_k2_reference(x, r, p, alpha, w27)
        e_k2, d_k2 = max(err(xn, xn_p), err(rn, rn_p)), rel(rr, rr_p)
        torch.cuda.synchronize()

        reps = 20 if nx * ny * nz > 10**7 else 50
        t = {
            "stencil27": (cuda_ms(torch, lambda: sk.stencil27(z, mask, w27, dims), reps),
                          cuda_ms(torch, lambda: sk.stencil27_reference(z, mask, w27, dims), reps)),
            "fused_cg_k1": (cuda_ms(torch, lambda: fk.fused_cg_k1(r, p, beta, w27), reps),
                            cuda_ms(torch, lambda: fk.fused_cg_k1_reference(r, p, beta, w27), reps)),
            "fused_cg_k2": (cuda_ms(torch, lambda: fk.fused_cg_k2(x, r, p, alpha, w27), reps),
                            cuda_ms(torch, lambda: fk.fused_cg_k2_reference(x, r, p, alpha, w27), reps)),
        }
        errs = {"stencil27": e_st, "fused_cg_k1": e_k1, "fused_cg_k2": e_k2}
        nbytes = nx * ny * nz * (2 * z.element_size() + 1)
        log(f"[phase 2] {tag}: max abs err stencil27 {e_st:.3e}, k1 {e_k1:.3e} "
            f"(dot rel {d_k1:.2e}), k2 {e_k2:.3e} (dot rel {d_k2:.2e}); "
            f"stencil27 {t['stencil27'][0]:.4f} ms "
            f"(plain {t['stencil27'][1]:.4f}, {nbytes / t['stencil27'][0] / 1e6:.1f} GB/s "
            f"effective), k1 {t['fused_cg_k1'][0]:.4f} ms (plain "
            f"{t['fused_cg_k1'][1]:.4f}), k2 {t['fused_cg_k2'][0]:.4f} ms "
            f"(plain {t['fused_cg_k2'][1]:.4f})")
        if tuple(dims) == tuple(main_dims) and dtype == torch.float32:
            record = {k: {"max_abs_err": errs[k], "ms": t[k][0], "plain_ms": t[k][1]}
                      for k in errs}
        del z, r, p, x, pn, pn_p, xn, rn, xn_p, rn_p
        torch.cuda.empty_cache()
    if not record:
        raise AssertionError("phase 2 did not run the main path's shape")
    return record


def unit_source_problem():
    """3D Poisson with f == 1 and homogeneous Dirichlet data (bench.py:183-185)."""
    import torch
    from dune_pdelab_tpu_torch.ops import ConvectionDiffusionProblem

    class UnitSource(ConvectionDiffusionProblem):
        def f(self, x):
            return torch.ones(x.shape[:-1], dtype=x.dtype, device=x.device)
    return UnitSource()


def field_a_problem():
    """The varsolve problem (bench.py:582-590): A = 1 + 0.5 sin(pi x)
    sin(pi y) sin(pi z), f == 1, homogeneous Dirichlet data."""
    import torch
    from dune_pdelab_tpu_torch.ops import ConvectionDiffusionProblem

    class FieldA(ConvectionDiffusionProblem):
        def A(self, x):
            s = (torch.sin(math.pi * x[..., 0]) * torch.sin(math.pi * x[..., 1])
                 * torch.sin(math.pi * x[..., 2]))
            return 1.0 + 0.5 * s

        def f(self, x):
            return torch.ones(x.shape[:-1], dtype=x.dtype, device=x.device)
    return FieldA()


def tensor_conv_problem():
    """Full anisotropic tensor + convection + reaction + source
    (tests/test_structured_fused.py TensorConv)."""
    import torch
    from dune_pdelab_tpu_torch.ops import ConvectionDiffusionProblem

    class TensorConv(ConvectionDiffusionProblem):
        def A(self, x):
            base = torch.eye(3, dtype=x.dtype, device=x.device) + 0.3
            return (1.0 + x[..., 1] * x[..., 2])[..., None, None] * base

        def b(self, x):
            return torch.stack([x[..., 1], -x[..., 0], 0.5 * torch.ones_like(x[..., 0])],
                               dim=-1)

        def c(self, x):
            return 0.2 + x[..., 2]

        def f(self, x):
            return torch.cos(2 * x[..., 0]) * x[..., 1]
    return TensorConv()


def q1_operator(torch, pt, problem, cells, dev):
    """GridOperator of ConvectionDiffusionFEM(problem) on the unit cube,
    Q1, Dirichlet on every face, constraints on `dev`."""
    from dune_pdelab_tpu_torch.ops import ConvectionDiffusionFEM
    mesh = pt.StructuredMesh([0, 0, 0], [1, 1, 1], cells)
    V = pt.FunctionSpace(mesh, pt.QkFEM(1, 3))
    cgm = pt.constraints(problem.dirichlet_bctype(), V, device=dev)
    lop = ConvectionDiffusionFEM(problem)
    return V, cgm, lop, pt.GridOperator(V, lop, constraints=cgm, skip_boundary=True)


def phase_fused_kernel(torch, pt, dev):
    """Phase 2 (structured_fused): kernel against its plain version on the
    card at the main path's 512^3 cells and a ragged 66x44x32 cells, both
    modes, a field-A and a tensor-A + b + c + f problem."""
    import numpy as np
    from dune_pdelab_tpu_torch.assembly.structured_fused import (
        make_fused_japply, make_fused_residual)
    from dune_pdelab_tpu_torch.kernels import structured_fused as sfk

    rng = np.random.default_rng(77)
    record = {}
    cases = [(c, torch.float32) for c in FUSED_CELLS] + [(FUSED_CELLS[-1], torch.float64)]
    for cells, dtype in cases:
        for pname, make_problem in (("field-A", field_a_problem),
                                    ("tensor-A+b+c+f", tensor_conv_problem)):
            V, cgm, _, go = q1_operator(torch, pt, make_problem(), cells, dev)
            x = torch.as_tensor(rng.standard_normal(V.ndofs), dtype=dtype, device=dev)
            for mode, make in (("residual", make_fused_residual),
                               ("japply", make_fused_japply)):
                op = make(go)
                t0 = time.perf_counter()
                tab, coef = op.state(x.dtype, x.device)
                torch.cuda.synchronize()
                eval_s = time.perf_counter() - t0
                y = op(x)
                y_p = sfk.structured_fused_reference(x, cgm.mask, tab, coef, op.dims,
                                                     mode == "japply")
                torch.cuda.synchronize()
                if not bool(torch.isfinite(y).all()):
                    raise AssertionError(f"structured_fused {cells} {pname} {mode}: non-finite")
                err = float((y - y_p).abs().max())
                tol = 1e-5 if dtype == torch.float32 else 1e-12
                lim = tol * float(y_p.abs().max())
                tag = (f"{cells[0]}x{cells[1]}x{cells[2]} cells "
                       f"{str(dtype).replace('torch.', '')} {pname} {mode}")
                if not err <= lim:
                    raise AssertionError(f"structured_fused {tag}: max abs err "
                                         f"{err:.3e} > {lim:.3e}")
                big = V.ndofs > 10**7
                ms = cuda_ms(torch, lambda: op(x), 10 if big else 50)
                plain_ms = cuda_ms(torch, lambda: sfk.structured_fused_reference(
                    x, cgm.mask, tab, coef, op.dims, mode == "japply"), 2 if big else 10)
                nel = int(np.prod(cells))
                log(f"[phase 2] structured_fused {tag}: max abs err {err:.3e} "
                    f"(max|y| {float(y_p.abs().max()):.3e}), {ms:.4f} ms "
                    f"({nel / ms / 1e6:.3f} Gelem/s; plain {plain_ms:.4f} ms), "
                    f"coefficients {sum(t.numel() for t in coef[2:] if t is not None) * x.element_size() / 2**30:.2f} GiB "
                    f"evaluated in {eval_s:.2f} s")
                if (tuple(cells) == FUSED_CELLS[0] and pname == "field-A"
                        and mode == "japply"):
                    record["structured_fused"] = {"max_abs_err": err, "ms": ms,
                                                  "plain_ms": plain_ms}
                del op, tab, coef, y, y_p
                torch.cuda.empty_cache()
            del x, go, cgm, V
            torch.cuda.empty_cache()
    if not record:
        raise AssertionError("phase 2 did not run structured_fused at the main path's size")
    return record


def choose_nslabs(torch, pt, lop, cells, dev):
    """Slab count for residual_slabbed from the measured peak memory of one
    8-plane slab, so that a slab stays within a quarter of free memory."""
    from dune_pdelab_tpu_torch.assembly.gridoperator import GridOperator
    n = cells
    h = 1.0 / n
    mesh = pt.StructuredMesh([0, 0, 0], [1, 1, 8 * h], (n, n, 8))
    go = GridOperator(pt.FunctionSpace(mesh, pt.QkFEM(1, 3)), lop, skip_boundary=True)
    x = torch.zeros(go.space.ndofs, dtype=torch.float32, device=dev)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    go.residual_unconstrained(x)
    torch.cuda.synchronize()
    per_elem = (torch.cuda.max_memory_allocated() - base) / mesh.nelements
    del go, x
    torch.cuda.empty_cache()
    free, _ = torch.cuda.mem_get_info()
    nslabs = max(1, math.ceil(n**3 * per_elem / (0.25 * free)))
    log(f"[phase 3] slab probe: {per_elem:.1f} B/element peak, {free / 2**30:.1f} GiB "
        f"free -> nslabs = {nslabs}")
    return nslabs


def phase_main(torch, pt, cells, iters, dev):
    """Phase 3: the bench chain at full size."""
    from dune_pdelab_tpu_torch.assembly import stencil as stencil_mod
    from dune_pdelab_tpu_torch.assembly.fused_cg import make_fused_cg, qualifies
    from dune_pdelab_tpu_torch.assembly.slabbed import residual_slabbed
    from dune_pdelab_tpu_torch.kernels.stencil27 import stencil27_reference
    from dune_pdelab_tpu_torch.linalg import cg
    from dune_pdelab_tpu_torch.ops import ConvectionDiffusionFEM

    f32 = torch.float32
    t0 = time.perf_counter()
    prob = unit_source_problem()
    mesh = pt.StructuredMesh([0, 0, 0], [1, 1, 1], (cells,) * 3)
    V = pt.FunctionSpace(mesh, pt.QkFEM(1, 3))
    cgm = pt.constraints(prob.dirichlet_bctype(), V, device=dev)
    lop = ConvectionDiffusionFEM(prob)
    go = pt.GridOperator(V, lop, constraints=cgm, skip_boundary=True)
    N = V.ndofs
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    log(f"[phase 3] setup: N = {N} DOFs, {setup_s:.2f} s")

    nslabs = choose_nslabs(torch, pt, lop, cells, dev)
    x0 = V.zero(f32, dev)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    b = residual_slabbed(V, lop, cgm, x0, nslabs=nslabs)
    torch.cuda.synchronize()
    res_s = time.perf_counter() - t0
    bnorm = float(torch.linalg.norm(b))
    if not (math.isfinite(bnorm) and bnorm > 0):
        raise AssertionError(f"RHS norm {bnorm}")
    log(f"[phase 3] residual_slabbed: nslabs {nslabs}, {res_s:.2f} s, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, |b| = {bnorm:.6e}")

    proxy = (mesh.nelements > stencil_mod.PROXY_MIN_ELEMENTS
             and stencil_mod._coefficients_spatially_constant(lop, mesh))
    if not proxy:
        raise AssertionError("compile_stencil would not take the proxy branch")
    t0 = time.perf_counter()
    st = stencil_mod.compile_stencil(go, dtype=f32, device=dev)
    torch.cuda.synchronize()
    comp_s = time.perf_counter() - t0
    if st is None or not qualifies(st):
        raise AssertionError("stencil did not compile or does not qualify for fused CG")
    # the first call pays torch.func's one-off imports; the second is the
    # compile's own cost
    t0 = time.perf_counter()
    stencil_mod.compile_stencil(go, dtype=f32, device=dev)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    log(f"[phase 3] compile_stencil (proxy branch): {comp_s:.2f} s first call, "
        f"{warm_s:.2f} s second call, centre tap {st.w27[1, 1, 1]:.6e}")

    solve = make_fused_cg(st, maxiter=iters, tol=0.0)
    solve(b)                                   # warm-up (allocator, caches)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    z, stats = solve(b)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    defect = float(stats.defect)
    if stats.iterations != iters:
        raise AssertionError(f"fused CG ran {stats.iterations} iterations, not {iters}")
    if not bool(torch.isfinite(z).all()) or not math.isfinite(defect):
        raise AssertionError("fused CG produced non-finite values")
    # CG minimises the energy 1/2 z.Az - b.z monotonically from 0 at z0 = 0;
    # the residual norm is not monotone (at 512^3 it is above |b| after 50
    # iterations, and the plain CG below shows the same)
    Az = st(z)
    energy = float(0.5 * torch.dot(z.double(), Az.double()) - torch.dot(b.double(), z.double()))
    if not energy < 0.0:
        raise AssertionError(f"CG energy {energy:.3e} did not fall below 0")
    true_res = float(torch.linalg.norm(b - Az))
    ratio = true_res / defect
    if not 0.1 <= ratio <= 10.0:
        raise AssertionError(f"true residual {true_res:.3e} vs recurrence {defect:.3e}")
    log(f"[phase 3] fused CG: {iters} iterations in {solve_s:.4f} s = "
        f"{1e3 * solve_s / iters:.4f} ms/iteration, {N * iters / solve_s:.6e} "
        f"dof-iterations/s; defect {bnorm:.4e} -> {defect:.4e}, true residual "
        f"{true_res:.4e}, energy {energy:.6e}")

    t0 = time.perf_counter()
    z_p, s_p = cg(lambda v: stencil27_reference(v, st.mask, st.w27, st.dims), b,
                  tol=0.0, atol=1e-30, maxiter=iters)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    rel = float(torch.linalg.norm(z - z_p) / torch.linalg.norm(z_p))
    d_rel = abs(float(s_p.defect) - defect) / float(s_p.defect)
    log(f"[phase 3] plain CG ({s_p.iterations} iterations, plain stencil) in "
        f"{plain_s:.2f} s, defect {float(s_p.defect):.4e}; fused vs plain: "
        f"solution rel L2 {rel:.3e}, defect rel {d_rel:.3e}")
    if not (rel <= 1e-3 and d_rel <= 1e-2):
        raise AssertionError("fused CG disagrees with the plain CG")


def phase_readme(torch, pt, cells, dev):
    """Phase 4: StationaryLinearProblemSolver + SEQ_CG_Jacobi (README)."""
    from dune_pdelab_tpu_torch.kernels import stencil27 as sk
    from dune_pdelab_tpu_torch.linalg import cg
    from dune_pdelab_tpu_torch.ops import ConvectionDiffusionFEM
    from dune_pdelab_tpu_torch.solvers import SEQ_CG_Jacobi

    for dtype, red in ((torch.float32, 1e-6), (torch.float64, 1e-10)):
        prob = unit_source_problem()
        mesh = pt.StructuredMesh([0, 0, 0], [1, 1, 1], (cells,) * 3)
        V = pt.FunctionSpace(mesh, pt.QkFEM(1, 3))
        cgm = pt.constraints(prob.dirichlet_bctype(), V, device=dev)
        go = pt.GridOperator(V, ConvectionDiffusionFEM(prob), constraints=cgm,
                             skip_boundary=True)
        x0 = V.zero(dtype, dev)
        ls = SEQ_CG_Jacobi()
        before = sk.launches
        t0 = time.perf_counter()
        x = pt.StationaryLinearProblemSolver(go, ls, reduction=red, verbose=0).apply(x0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rep = ls.report(go)
        its = ls.stats_history[-1].iterations
        log(f"[phase 4] {dtype} {V.ndofs} DOFs: {its} iterations, {wall:.2f} s\n{rep}")
        if "compiled stencil" not in rep or "stencil27 CUDA kernel" not in rep:
            raise AssertionError("README path did not take the compiled-stencil tier")
        if not sk.launches > before:
            raise AssertionError("README path launched no stencil27 kernel")
        if not bool(torch.isfinite(x).all()):
            raise AssertionError("README path produced non-finite values")
        if dtype == torch.float64:
            st = ls._stencil_for(go, x0, 0.0)
            r = go.residual(x0)
            diag = st.diagonal(dtype=dtype, device=dev)
            z_p, s_p = cg(lambda v: sk.stencil27_reference(v, st.mask, st.w27, st.dims),
                          r, M=lambda v: v / diag, tol=red, maxiter=5000)
            x_p = x0 - z_p
            rel = float(torch.linalg.norm(x - x_p) / torch.linalg.norm(x_p))
            log(f"[phase 4] fp64 plain CG: {s_p.iterations} iterations, rel L2 {rel:.3e}")
            if abs(its - s_p.iterations) > 1 or not rel <= 1e-9:
                raise AssertionError(f"fp64 README path vs plain CG: iterations "
                                     f"{its} vs {s_p.iterations}, rel {rel:.3e}")


def mg_solve_and_refine(torch, pt, cells, dev):
    """Phase 5 (a) and (b): LatticeGMG-CG at `cells`^3 in fp32 to 1e-8
    (bench.py:641-714), then fp64 defect correction around it to a true
    relative defect of 1e-8 (bench.py:478-560). One fine stencil, probed in
    fp64, serves both precisions, as in the reference."""
    from dune_pdelab_tpu_torch.assembly.slabbed import residual_slabbed
    from dune_pdelab_tpu_torch.assembly.stencil import compile_stencil
    from dune_pdelab_tpu_torch.kernels import stencil27 as sk
    from dune_pdelab_tpu_torch.linalg.gmg_lattice import LatticeGMG
    from dune_pdelab_tpu_torch.solvers.refinement import refine_solve

    V, cgm, lop, go = q1_operator(torch, pt, unit_source_problem(), (cells,) * 3, dev)
    N = V.ndofs
    nslabs = choose_nslabs(torch, pt, lop, cells, dev)
    t0 = time.perf_counter()
    b64 = -residual_slabbed(V, lop, cgm, V.zero(torch.float64, dev), nslabs=2 * nslabs)
    b = b64.to(torch.float32)
    torch.cuda.synchronize()
    rhs_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    st = compile_stencil(go, dtype=torch.float64, device=dev)
    gmg = LatticeGMG(V, lop, fine_stencil=st)
    before = sk.launches
    float(torch.sum(gmg.apply(b)))                 # warm the V-cycle
    setup_s = time.perf_counter() - t0
    per_cycle = sk.launches - before
    expected = (gmg.nlevels - 1) * (gmg.pre + gmg.post + 1)
    if not (gmg.nlevels >= 3 and all(s.uses_stencil27 for s in gmg.stencils[:-1])
            and per_cycle == expected):
        raise AssertionError(f"LatticeGMG levels {gmg.nlevels}: stencil27 launches per "
                             f"V-cycle {per_cycle}, expected {expected} (every level "
                             f"above the coarsest)")
    log(f"[phase 5a] LatticeGMG {cells}^3 cells (N = {N}): {gmg.nlevels} levels "
        f"{[d[0] for d in gmg.dims]}, RHS (fp64, slabbed) {rhs_s:.2f} s, setup "
        f"(compile_stencil + hierarchy + first V-cycle) {setup_s:.2f} s, stencil27 "
        f"launches per V-cycle {per_cycle} on {gmg.nlevels - 1} levels")

    gmg.solve_host(b, tol=1e-8, maxiter=100)       # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x, info = gmg.solve_host(b, tol=1e-8, maxiter=100)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    true_rel = info["true_defect"] / info["defect0"]
    log(f"[phase 5a] solve: {info['iterations']} iterations in {solve_s:.4f} s "
        f"({N / solve_s:.6e} DOFs/s, {1e3 * solve_s / max(1, info['iterations']):.3f} "
        f"ms/iteration), converged {info['converged']}, true rel defect {true_rel:.3e}")
    if not (info["converged"] and bool(torch.isfinite(x).all()) and true_rel < 1e-2):
        raise AssertionError(f"LatticeGMG solve failed: {info}")
    del x

    inner_its = []

    def inner(r32):
        z, inf = gmg.solve_host(r32, tol=1e-4, maxiter=30)
        inner_its.append(inf["iterations"])
        return z

    float(torch.sum(st(b64)))                      # warm the fp64 stencil
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x64, stats = refine_solve(st, inner, b64, tol=1e-8, max_outer=8)
    torch.cuda.synchronize()
    ref_s = time.perf_counter() - t0
    true64 = float(torch.linalg.norm(b64 - st(x64))) / float(torch.linalg.norm(b64))
    log(f"[phase 5b] refine: {stats.outer_iterations} outer sweeps "
        f"({'+'.join(map(str, inner_its))} = {sum(inner_its)} inner iterations) in "
        f"{ref_s:.4f} s ({ref_s / solve_s:.2f}x the fp32 solve), true fp64 rel "
        f"defect {true64:.3e}, converged {stats.converged}")
    if not (stats.converged and true64 <= 1e-8):
        raise AssertionError(f"fp64 refinement: rel defect {true64:.3e}, {stats}")


def mg_varsolve(torch, pt, sizes, dev):
    """Phase 5 (c): VarCoeffGMG-CG on the fused structured operator
    (bench.py:562-639), fp32, tol 1e-8; flat iteration counts."""
    from dune_pdelab_tpu_torch.assembly.structured_fused import make_fused_residual
    from dune_pdelab_tpu_torch.kernels import structured_fused as sfk
    from dune_pdelab_tpu_torch.linalg.gmg_varcoeff import VarCoeffGMG

    its = {}
    for n in sizes:
        before = sfk.launches
        V, _, _, go = q1_operator(torch, pt, field_a_problem(), (n,) * 3, dev)
        N = V.ndofs
        t0 = time.perf_counter()
        res = make_fused_residual(go)
        b = -res(V.zero(torch.float32, dev))
        del res
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        rhs_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        gmg = VarCoeffGMG(go, coarsest_cells=4)
        float(torch.sum(gmg.apply(b)))
        setup_s = time.perf_counter() - t0
        gmg.solve_host(b, tol=1e-8, maxiter=100)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x, info = gmg.solve_host(b, tol=1e-8, maxiter=100)
        torch.cuda.synchronize()
        solve_s = time.perf_counter() - t0
        its[n] = info["iterations"]
        true_rel = info["true_defect"] / info["defect0"]
        k3 = sfk.launches - before
        log(f"[phase 5c] varsolve {n}^3 cells (N = {N}): {gmg.nlevels} levels, lmax "
            f"{[round(v, 4) for v in gmg.lmax]}, RHS (fused residual) {rhs_s:.2f} s, setup "
            f"{setup_s:.2f} s, {info['iterations']} iterations in {solve_s:.4f} s "
            f"({N / solve_s:.6e} DOFs/s), converged {info['converged']}, true rel "
            f"defect {true_rel:.3e}; structured_fused launches {k3}")
        if not (info["converged"] and bool(torch.isfinite(x).all()) and k3 > 0):
            raise AssertionError(f"varsolve {n}^3 failed: {info}, K3 launches {k3}")
        del x, b, gmg, go, V
        torch.cuda.empty_cache()
    if len(sizes) > 1 and not its[sizes[-1]] <= its[sizes[0]] + 2:
        raise AssertionError(f"varsolve iterations not flat: {its}")


def mg_config13(torch, pt, cells, dev):
    """Phase 5 (d): config13_scale_lattice_gmg (models/configs.py:525-562,
    without the sharded cross-check) in fp64 on the card, held against
    tests/golden_parity.json."""
    from dune_pdelab_tpu_torch.assembly.stencil import compile_stencil
    from dune_pdelab_tpu_torch.linalg.gmg_lattice import LatticeGMG
    from dune_pdelab_tpu_torch.ops import ConvectionDiffusionProblem
    from dune_pdelab_tpu_torch.space.functions import l2_difference

    class Sine3D(ConvectionDiffusionProblem):
        def exact(self, p):
            return (torch.sin(math.pi * p[:, 0]) * torch.sin(math.pi * p[:, 1])
                    * torch.sin(math.pi * p[:, 2]))

        def f(self, x):
            return 3 * math.pi**2 * (torch.sin(math.pi * x[..., 0])
                                     * torch.sin(math.pi * x[..., 1])
                                     * torch.sin(math.pi * x[..., 2]))

        def g(self, x):
            return torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)

    golden = json.loads((ROOT / "tests" / "golden_parity.json").read_text())[
        "config13_scale_lattice_gmg"]
    p = Sine3D()
    t0 = time.perf_counter()
    V, cgm, lop, go = q1_operator(torch, pt, p, (cells,) * 3, dev)
    x0 = pt.interpolate_dirichlet(p.g, V, cgm, V.zero(torch.float64, dev))
    b = -go.residual(x0, 0.0)
    st = compile_stencil(go, dtype=torch.float64, device=dev)
    gmg = LatticeGMG(V, lop, fine_stencil=st)
    z, info = gmg.solve_host(b, tol=1e-10, maxiter=60)
    x = x0 + z
    l2 = float(l2_difference(V, x, p.exact))
    wall = time.perf_counter() - t0
    rel = abs(l2 - golden["l2_error"]) / golden["l2_error"]
    log(f"[phase 5d] config13 {cells}^3 fp64 (N = {V.ndofs}): {info['iterations']} "
        f"iterations, {gmg.nlevels} levels, L2 error {l2:.16e} (golden "
        f"{golden['l2_error']:.16e}, rel {rel:.2e}), true rel defect "
        f"{info['true_defect'] / info['defect0']:.3e}, {wall:.2f} s")
    if not (info["iterations"] == golden["iterations"] and gmg.nlevels == golden["levels"]
            and V.ndofs == golden["ndofs"] and rel <= 1e-6):
        raise AssertionError("config13 golden mismatch")


def phase_multigrid(torch, pt, dev):
    """Phase 5: the multigrid solve routes."""
    mg_solve_and_refine(torch, pt, MG_CELLS, dev)
    torch.cuda.empty_cache()
    mg_varsolve(torch, pt, VAR_CELLS, dev)
    mg_config13(torch, pt, C13_CELLS, dev)
    torch.cuda.empty_cache()


def main():
    if not (ROOT / "dune_pdelab_tpu_torch" / "csrc").is_dir():
        raise SystemExit("chip_smoke: run it from a checkout of the repository "
                         "(dune_pdelab_tpu_torch/ not found beside it)")
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (this script has no CPU path)")
    if torch.cuda.get_device_capability(0) != (9, 0):
        raise SystemExit(f"chip_smoke: needs a Hopper card (sm_90), found "
                         f"{torch.cuda.get_device_name(0)}")
    sys.path.insert(0, str(ROOT))
    import dune_pdelab_tpu_torch as pt
    from dune_pdelab_tpu_torch.kernels import _build
    from dune_pdelab_tpu_torch.kernels import fused_cg as fk
    from dune_pdelab_tpu_torch.kernels import stencil27 as sk
    from dune_pdelab_tpu_torch.kernels import structured_fused as sfk

    dev = torch.device("cuda")
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    _build.library()
    log(f"[phase 1] kernels built in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {_build.build_seconds} s) -> {_build.library_path().name}")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"  ptxas: {line.strip()}")

    n1 = MAIN_CELLS + 1
    main_dims = (n1, n1, n1)
    dims_list = [((128, 128, 128), torch.float32), ((128, 128, 128), torch.float64),
                 ((67, 45, 33), torch.float32), ((67, 45, 33), torch.float64),
                 (main_dims, torch.float32)]
    record = phase_kernels(torch, dims_list, main_dims, dev)
    record.update(phase_fused_kernel(torch, pt, dev))

    counters = {"stencil27": (sk, "launches"), "fused_cg_k1": (fk, "launches_k1"),
                "fused_cg_k2": (fk, "launches_k2"), "structured_fused": (sfk, "launches")}
    paths = [
        ("phase 3 (fused CG)", lambda: phase_main(torch, pt, MAIN_CELLS, MAIN_ITERS, dev),
         ("stencil27", "fused_cg_k1", "fused_cg_k2")),
        ("phase 4 (README)", lambda: phase_readme(torch, pt, README_CELLS, dev),
         ("stencil27",)),
        ("phase 5 (multigrid)", lambda: phase_multigrid(torch, pt, dev),
         ("stencil27", "structured_fused")),
    ]
    totals = dict.fromkeys(counters, 0)
    for name, run, needed in paths:
        for mod, attr in counters.values():
            setattr(mod, attr, 0)
        t0 = time.perf_counter()
        run()
        counts = {k: getattr(mod, attr) for k, (mod, attr) in counters.items()}
        log(f"{name}: {time.perf_counter() - t0:.2f} s, launch counts {counts}")
        missing = [k for k in needed if counts[k] == 0]
        if missing:
            raise AssertionError(f"{name} never launched {missing}: {counts}")
        for k in totals:
            totals[k] += counts[k]
    log(f"launch counts over phases 3-5: {totals}")

    meta = {
        "stencil27": ("dune_pdelab_tpu_torch/csrc/stencil27.cu",
                      "dune_pdelab_tpu/assembly/stencil_pallas_tile.py:65"),
        "fused_cg_k1": ("dune_pdelab_tpu_torch/csrc/fused_cg.cu",
                        "dune_pdelab_tpu/assembly/fused_cg_pallas.py:162"),
        "fused_cg_k2": ("dune_pdelab_tpu_torch/csrc/fused_cg.cu",
                        "dune_pdelab_tpu/assembly/fused_cg_pallas.py:222"),
        "structured_fused": ("dune_pdelab_tpu_torch/csrc/structured_fused.cu",
                             "dune_pdelab_tpu/assembly/structured_fused.py:256"),
    }
    kernels = [dict(name=k, route="cuda", source=src, replaces=rep,
                    launches=totals[k], **record[k])
               for k, (src, rep) in meta.items()]
    log(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
