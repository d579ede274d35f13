"""What the single-process example tests share (tests/test_torch_examples*.py):
the port's example modules, the agreement measure and a module-scoped
fixture that computes the selected tests' JAX halves
(tests/torch_example_refs.py) ahead, in spawned worker processes, while
the tests run the port.

The tests are spread over files of at most four, each with its own
fixture: xdist's `--dist loadfile` hands out files with more tests first,
so these start once the files with five or more tests are handed out.
"""
import importlib
import multiprocessing
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_example_refs as refs

F64 = torch.float64
ROOT = Path(__file__).resolve().parents[1]
REL = 1e-10

# the JAX halves' order of submission: the longest first (seconds on one
# CPU core: ex12 ~30, ex02 ~22, ex06 ~14, ex15 ~12, ...)
LONGEST_FIRST = ("ex12", "ex02", "ex06", "ex15", "ex10", "ex11", "ex01", "ex05", "ex13",
                 "ex09", "ex04", "ex03")


def example(name):
    return importlib.import_module(f"dune_pdelab_tpu_torch.examples.{name}")


def close(a, b, rel=REL):
    a, b = np.asarray(a, dtype=float), np.asarray(b, dtype=float)
    return float(np.max(np.abs(a - b))) <= rel * max(float(np.max(np.abs(b))), 1e-300)


def jax_refs_fixture(sizes):
    """A module-scoped fixture over `sizes` (test name -> (JAX half, its
    arguments); the port's run() takes the same sizes): futures of the
    module's selected tests' JAX halves, computed longest first by two
    spawned worker processes."""
    @pytest.fixture(scope="module")
    def jax_refs(request):
        selected = {i.name for i in request.session.items if i.module is request.module}
        todo = sorted((n for n in selected if n in sizes),
                      key=lambda n: LONGEST_FIRST.index(sizes[n][0]))
        pool = ProcessPoolExecutor(2, mp_context=multiprocessing.get_context("spawn"),
                                   initializer=refs.init)
        futures = {name: pool.submit(getattr(refs, sizes[name][0]), *sizes[name][1])
                   for name in todo}
        yield futures
        pool.shutdown(wait=True, cancel_futures=True)
    return jax_refs


def args(sizes, request):
    """The test's sizes, as its JAX half takes them."""
    return sizes[request.node.name][1]


def ref(jax_refs, request):
    """The test's JAX half (waits for its worker)."""
    return jax_refs[request.node.name].result()
