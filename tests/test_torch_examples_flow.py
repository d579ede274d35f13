"""The port's examples 05, 09, 13 and 15 against the JAX package at tiny
sizes, live, in fp64 on the CPU (tests/test_torch_examples.py says how they
are held).
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
    "test_ex05_stokes_taylor_hood_matches_jax": ("ex05", (4,)),
    "test_ex15_north_star_scaling_matches_jax": ("ex15", (8,)),
    "test_ex09_darcy_porous_media_matches_jax": ("ex09", (16, 4)),
    "test_ex13_twophase_flow_matches_jax": ("ex13", (4, 0.004)),
}
jax_refs = jax_refs_fixture(SIZES)


def _two_point_faces(head, cells, A):
    """RT0 face velocities of a CCFV head from the solver's two-point
    fluxes, in numpy: harmonic means of K at the cell centers inside,
    K at the inside center and the ghost at h/2 on the Dirichlet x faces,
    zero flux on the Neumann y faces (examples/09's problem)."""
    n = cells
    h = 1.0 / n
    c = (np.arange(n) + 0.5) * h
    X, Y = np.meshgrid(c, c, indexing="xy")             # lattice (y, x)
    K = A(X, Y)
    U = head.reshape(n, n)
    vx = np.zeros((n, n + 1))
    kh = 2 * K[:, :-1] * K[:, 1:] / (K[:, :-1] + K[:, 1:] + 1e-300)
    vx[:, 1:-1] = -kh * (U[:, 1:] - U[:, :-1]) / h
    vx[:, 0] = -K[:, 0] * (U[:, 0] - 1.0) / (h / 2)        # g = 1 - x = 1 at x = 0
    vx[:, -1] = -K[:, -1] * (0.0 - U[:, -1]) / (h / 2)     # g = 0 at x = 1
    vy = np.zeros((n + 1, n))
    kh = 2 * K[:-1, :] * K[1:, :] / (K[:-1, :] + K[1:, :] + 1e-300)
    vy[1:-1, :] = -kh * (U[1:, :] - U[:-1, :]) / h
    return vx, vy

def test_ex05_stokes_taylor_hood_matches_jax(jax_refs, request):
    (cells,) = args(SIZES, request)
    r = example("ex05_stokes_taylor_hood").run(cells=cells, device="cpu", dtype=F64)
    j = ref(jax_refs, request)
    assert (r["ndofs_u"], r["ndofs_p"], r["iterations"]) == (
        j["ndofs_u"], j["ndofs_p"], j["iterations"])
    assert close(r["max_u"], j["max_u"]) and close(r["mean_p"], j["mean_p"])


def test_ex15_north_star_scaling_matches_jax(jax_refs, request):
    (cells,) = args(SIZES, request)
    r = example("ex15_north_star_scaling").run(cells=cells, refine=True, device="cpu", dtype=F64)
    j = ref(jax_refs, request)
    assert (r["levels"], r["iterations"]) == (j["levels"], j["iterations"])
    # the true defect ||b - A x|| / ||b|| ~5e-9, recomputed from x: its
    # rounding (~1e-16 of ||b||) is ~2e-8 of it (measured 1.8e-8)
    assert close(r["true_rel"], j["true_rel"], 1e-7)
    assert r["refine_sweeps"] == j["refine_sweeps"] and r["refine_rel"] <= 1e-8


def test_ex09_darcy_porous_media_matches_jax(jax_refs, request, tmp_path):
    n, m = args(SIZES, request)
    r = example("ex09_darcy_porous_media").run(darcy_cells=n, pme_cells=m, check=False,
                                               device="cpu", out_dir=str(tmp_path))
    j = ref(jax_refs, request)
    d = r["darcy"]
    assert d["iterations"] == j["iterations"] and close(d["head"], j["head"])

    def K(x, y):
        inside = (np.abs(x - 0.5) < 0.15) & (np.abs(y - 0.5) < 0.15)
        return np.where(inside, 1e-3, 1.0)

    vx, vy = _two_point_faces(j["head"], n, K)
    assert close(d["faces"][0], vx, 1e-8) and close(d["faces"][1], vy, 1e-8)
    assert d["max_div"] < 1e-7 and abs(d["inflow"] - d["outflow"]) < 1e-10 * d["inflow"]
    assert r["pme"]["newton_iterations"] == j["pme_newton_iterations"]
    assert close(r["pme"]["l2_error"], j["pme_l2_error"])


def test_ex13_twophase_flow_matches_jax(jax_refs, request, tmp_path):
    n, tend = args(SIZES, request)
    r = example("ex13_twophase_flow").run(cells=n, tend=tend, device="cpu",
                                          out_dir=str(tmp_path))
    j = ref(jax_refs, request)
    assert (r["failed_steps"], r["t"], r["newton_iterations"]) == (
        j["failed_steps"], j["t"], j["newton_iterations"])
    # Newton stops at a 1e-7 reduction on BiCGStab solves to 1e-4, so the
    # two packages' rounding differences are not damped to the last bits
    # (measured 1.3e-10 on the states); the mass changes (~1e-4) are
    # differences of masses ~10^3 times larger, which raises that to
    # 5.4e-9 of them
    assert close(r["x"], j["x"], 1e-9)
    assert close(r["liquid_gain"], j["liquid_gain"], 5e-8)
    assert close(r["gas_change"], j["gas_change"], 5e-8)
