#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (dune_pdelab_tpu_torch) on one H100.

Run from the repository root on a machine with a Hopper card:

    python3 chip_smoke.py

Phases (each passes or raises; there is no CPU path):
  1. build the hand-written CUDA kernels from dune_pdelab_tpu_torch/csrc;
  2. each kernel against its plain PyTorch version on the card, at 128^3,
     at an unaligned (67, 45, 33) grid (fp32 and fp64) and at the main
     path's 512^3 grid (fp32), with kernel and plain times;
  3. the main path at full size: 3D Poisson Q1, 511 cells per axis
     (N = 134,217,728 DOFs), fp32: mesh -> space -> constraints ->
     GridOperator -> slabbed RHS -> compile_stencil (proxy branch) ->
     make_fused_cg for 50 iterations, checked against the true residual and
     against a plain CG on the same operator;
  4. the README entry point, StationaryLinearProblemSolver + SEQ_CG_Jacobi at
     127 cells, in fp32 and fp64 (fp64 checked against a plain CG).

Prints phase results and times, the card's name and power limit, one JSON
line {"kernels": [...]} with each kernel's launches in phases 3-4, error
and times, and as its last line {"ok": true, "device": {...}}.
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

    sk.launches = fk.launches_k1 = fk.launches_k2 = 0
    phase_main(torch, pt, MAIN_CELLS, MAIN_ITERS, dev)
    phase_readme(torch, pt, README_CELLS, dev)
    counts = {"stencil27": sk.launches, "fused_cg_k1": fk.launches_k1,
              "fused_cg_k2": fk.launches_k2}
    log(f"launch counts over the main-path phases: {counts}")
    if not all(v > 0 for v in counts.values()):
        raise AssertionError(f"a kernel of the main path was never launched: {counts}")

    meta = {
        "stencil27": ("dune_pdelab_tpu_torch/csrc/stencil27.cu",
                      "dune_pdelab_tpu/assembly/stencil_pallas_tile.py:65"),
        "fused_cg_k1": ("dune_pdelab_tpu_torch/csrc/fused_cg.cu",
                        "dune_pdelab_tpu/assembly/fused_cg_pallas.py:162"),
        "fused_cg_k2": ("dune_pdelab_tpu_torch/csrc/fused_cg.cu",
                        "dune_pdelab_tpu/assembly/fused_cg_pallas.py:222"),
    }
    kernels = [dict(name=k, route="cuda", source=src, replaces=rep,
                    launches=counts[k], **record.get(k, {}))
               for k, (src, rep) in meta.items()]
    log(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
