"""The port's multi-rank example scripts (ex07, ex08 and ex14's sharded
AMG; dune_pdelab_tpu_torch/examples/) on 8 CPU ranks against the JAX
package's sequential computation of the same quantities at the same tiny
sizes, live, in fp64.

One RankPool of 8 gloo ranks serves the module (each run() takes it as
`pool`); the JAX halves (tests/torch_example_refs.py) are computed ahead by
two spawned worker processes while the pool starts. The reference scripts
set XLA_FLAGS at import, so their problems are copied there. Held: the
sharded solves equal the sequential ones (iterations, solutions to 1e-12)
as run() itself checks, and the JAX package's sequential iteration counts
exactly, its errors to 1e-10 relative (ex08's max |vx - exact| to 1e-6:
its GMRES stops at a 1e-7 reduction, where the two packages' rounding
leaves 8.2e-7 of it).
"""
import multiprocessing
import sys
import xml.etree.ElementTree as ET
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_example_refs as refs
from dune_pdelab_tpu_torch.examples import ex07_parallel_poisson as ex07
from dune_pdelab_tpu_torch.examples import ex08_windowed_stokes_parallel as ex08
from dune_pdelab_tpu_torch.examples import ex14_unstructured_amg as ex14
from dune_pdelab_tpu_torch.parallel.launch import RankPool
from dune_pdelab_tpu_torch.utils.common import set_default_device

pytestmark = pytest.mark.fast
torch.set_num_threads(1)
set_default_device("cpu")
F64 = torch.float64
REL = 1e-10
SIZES = {"test_ex07_parallel_poisson_matches_jax": ("ex07", 16),
         "test_ex08_windowed_stokes_parallel_matches_jax": ("ex08", 4),
         "test_ex14_unstructured_amg_matches_jax": ("ex14", 16)}


@pytest.fixture(scope="module")
def jax_refs(request):
    selected = {i.name for i in request.session.items if i.module is sys.modules[__name__]}
    jobs = ProcessPoolExecutor(2, mp_context=multiprocessing.get_context("spawn"),
                               initializer=refs.init)
    futures = {n: jobs.submit(getattr(refs, SIZES[n][0]), SIZES[n][1])
               for n in SIZES if n in selected}
    yield futures
    jobs.shutdown(wait=True, cancel_futures=True)


@pytest.fixture(scope="module")
def pool(jax_refs):
    with RankPool(8, backend="gloo", device="cpu", timeout=600) as p:
        yield p


def close(a, b, rel=REL):
    a, b = np.asarray(a, dtype=float), np.asarray(b, dtype=float)
    return float(np.max(np.abs(a - b))) <= rel * max(float(np.max(np.abs(b))), 1e-300)


def test_ex07_parallel_poisson_matches_jax(pool, jax_refs, request):
    cells = SIZES[request.node.name][1]
    r = ex07.run(cells=cells, pool=pool, device="cpu")
    j = jax_refs[request.node.name].result()
    assert r["ranks"] == 8 and r["ndofs"] == j["ndofs"]
    assert r["iterations"] == r["iterations_seq"] == j["iterations"]
    assert r["max_diff"] <= 1e-12 and close(r["l2_error"], j["l2_error"])


def test_ex08_windowed_stokes_parallel_matches_jax(pool, jax_refs, request, tmp_path):
    cells = SIZES[request.node.name][1]
    r = ex08.run(cells=cells, check=False, pool=pool, device="cpu", out_dir=str(tmp_path))
    j = jax_refs[request.node.name].result()
    assert (r["ranks"], r["ndofs"]) == (8, j["ndofs"])
    assert (r["iterations"], r["converged"]) == (j["iterations"], j["converged"])
    assert close(r["vx_error"], j["vx_error"], 1e-6)
    pieces = ET.parse(r["pvtu"]).getroot().findall(".//Piece")
    assert r["pieces"] == len(pieces) == 8
    assert all((Path(r["pvtu"]).parent / p.get("Source")).is_file() for p in pieces)


def test_ex14_unstructured_amg_matches_jax(pool, jax_refs, request, tmp_path):
    cells = SIZES[request.node.name][1]
    r = ex14.run(cells=cells, pool=pool, device="cpu", out_dir=str(tmp_path))
    j = jax_refs[request.node.name].result()
    assert r["msh_roundtrip"] in ("native", "python")
    for k in ("p1", "p2"):
        assert {q: r[k][q] for q in ("ndofs", "amg", "jacobi")} == j[k]
    assert r["dg"] == j["dg"]
    s = r["sharded"]
    assert (s["ranks"], s["iterations"], s["iterations_seq"]) == (8, j["amg_cg"], j["amg_cg"])
    assert s["diff"] <= 1e-12
    assert Path(r["vtu"]).is_file() and Path(r["vtu"]).parent == tmp_path
