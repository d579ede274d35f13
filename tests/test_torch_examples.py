"""The port's example scripts (dune_pdelab_tpu_torch/examples/) against the
JAX package computing the same quantities at the same tiny sizes, live, in
fp64 on the CPU: 01-04 here; 05, 09, 13 and 15 in
tests/test_torch_examples_flow.py; 06, 10, 11 and 12 in
tests/test_torch_examples_loops.py; the command line in
tests/test_torch_examples_cli.py; the multi-rank 07, 08 and 14 in
tests/test_torch_examples_parallel.py (files of at most four tests:
tests/torch_example_harness.py says why).

Each test calls an example's run(); the JAX package's half rebuilds the
reference script's computation (examples/NN_*.py) at the same size
(tests/torch_example_refs.py), computed ahead by two spawned worker
processes started with the module while the tests run the port. Held:
iteration counts and the adaptive loops' N sequences exactly; errors,
orders and other printed numbers to 1e-10 relative (ex13's states and mass
changes and ex15's true defect to small multiples of their measured
agreement, for the reasons given beside them); ex11's gradient at theta_0
to 1e-10 and the recovered theta to 1e-6; ex09's RT0 faces equal to the
two-point fluxes recomputed in numpy from the JAX package's CCFV head with
harmonic means (the port's repaired reconstruction, not the reference's
face-center K).
"""
from pathlib import Path

import pytest
import torch

from dune_pdelab_tpu_torch.utils.common import set_default_device
from torch_example_harness import F64, args, close, example, jax_refs_fixture, ref

pytestmark = pytest.mark.fast
torch.set_num_threads(1)
set_default_device("cpu")

# test -> (JAX half, its arguments); the port's run() takes the same sizes
SIZES = {
    "test_ex01_poisson_matches_jax": ("ex01", (4,)),
    "test_ex02_convectiondiffusion_dg_matches_jax": ("ex02", ((4, 8),)),
    "test_ex03_nonlinear_newton_matches_jax": ("ex03", (4,)),
    "test_ex04_instationary_heat_matches_jax": ("ex04", (4, 0.005)),
}
jax_refs = jax_refs_fixture(SIZES)


def test_ex01_poisson_matches_jax(jax_refs, request, tmp_path):
    (cells,) = args(SIZES, request)
    r = example("ex01_poisson").run(cells=cells, device="cpu", dtype=F64, out_dir=str(tmp_path))
    j = ref(jax_refs, request)
    assert (r["ndofs"], r["iterations"]) == (j["ndofs"], j["iterations"])
    assert close(r["l2_error"], j["l2_error"])
    assert Path(r["vtu"]).parent == tmp_path and Path(r["vtu"]).is_file()


def test_ex02_convectiondiffusion_dg_matches_jax(jax_refs, request):
    (sizes,) = args(SIZES, request)
    r = example("ex02_convectiondiffusion_dg").run(sizes=sizes, device="cpu", dtype=F64)
    j = ref(jax_refs, request)
    assert r["iterations"] == j["iterations"]
    assert close(r["l2_errors"], j["l2_errors"]) and close(r["order"], j["order"])
    assert "element-major" in r["solve_path"]


def test_ex03_nonlinear_newton_matches_jax(jax_refs, request):
    (cells,) = args(SIZES, request)
    r = example("ex03_nonlinear_newton").run(cells=cells, device="cpu")
    j = ref(jax_refs, request)
    assert r["newton_iterations"] == j["newton_iterations"] and r["converged"]
    assert close(r["l2_error"], j["l2_error"])


def test_ex04_instationary_heat_matches_jax(jax_refs, request):
    cells, T = args(SIZES, request)
    r = example("ex04_instationary_heat").run(cells=cells, T=T, device="cpu", dtype=F64)
    j = ref(jax_refs, request)
    assert (r["steps"], r["t"]) == (j["steps"], j["t"])
    assert close(r["l2_error"], j["l2_error"]) and close(r["max_u"], j["max_u"])
