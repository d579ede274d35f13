"""The port's examples 06, 10, 11 and 12 (adaptive loops, explicit time
stepping, optimization) against the JAX package at tiny sizes, live, in
fp64 on the CPU (tests/test_torch_examples.py says how they are held).
"""
import numpy as np
import pytest
import torch

from dune_pdelab_tpu_torch.utils.common import set_default_device
from torch_example_harness import F64, args, close, example, jax_refs_fixture, ref

pytestmark = pytest.mark.fast
torch.set_num_threads(1)
set_default_device("cpu")

# test -> (JAX half, its arguments); the port's run() takes the same sizes
SIZES = {
    "test_ex10_acoustics_explicit_rk_matches_jax": ("ex10", (12, 0.05)),
    "test_ex06_adaptive_lshape_matches_jax": ("ex06", (8, 2)),
    "test_ex12_goal_oriented_adaptivity_matches_jax": ("ex12", (8, 2)),
    "test_ex11_pde_constrained_optimization_matches_jax": (
        "ex11", (4, (1.0, 0.8, -0.4, 0.5), (0.5, 0.0, 0.0, 0.0))),
}
jax_refs = jax_refs_fixture(SIZES)


def test_ex10_acoustics_explicit_rk_matches_jax(jax_refs, request, tmp_path):
    nx, T = args(SIZES, request)
    r = example("ex10_acoustics_explicit_rk").run(nx=nx, T=T, check=False, device="cpu",
                                                  out_dir=str(tmp_path))
    j = ref(jax_refs, request)
    assert (r["steps"], r["t"], r["peak_x"]) == (j["steps"], j["t"], j["peak_x"])
    assert close(r["reflection"], j["reflection"]) and close(r["amplitude"], j["amplitude"])


def test_ex06_adaptive_lshape_matches_jax(jax_refs, request):
    start, cycles = args(SIZES, request)
    r = example("ex06_adaptive_lshape").run(start=start, cycles=cycles, device="cpu", dtype=F64)
    j = ref(jax_refs, request)
    assert r["ndofs"] == j["ndofs"] and close(r["l2_errors"], j["l2_errors"])


def test_ex12_goal_oriented_adaptivity_matches_jax(jax_refs, request):
    start, levels = args(SIZES, request)
    r = example("ex12_goal_oriented_adaptivity").run(start=start, levels=levels, check=False,
                                                     device="cpu")
    j = ref(jax_refs, request)
    assert close(r["J"], j["J"]) and r["ndofs"] == j["ndofs"]
    assert close(r["true_errors"], j["true_errors"]) and close(r["estimates"], j["estimates"])


def test_ex11_pde_constrained_optimization_matches_jax(jax_refs, request):
    cells, theta_true, theta_start = args(SIZES, request)
    ex = example("ex11_pde_constrained_optimization")
    assert (ex.THETA_TRUE, ex.THETA_START) == (theta_true, theta_start)
    r = ex.run(cells=cells, device="cpu")
    j = ref(jax_refs, request)
    assert close(r["misfit0"], j["misfit0"]) and close(r["grad0"], j["grad0"])
    assert r["misfit"] < 1e-6 * r["misfit0"]
    assert np.max(np.abs(r["theta"] - np.asarray(theta_true))) < 1e-6
