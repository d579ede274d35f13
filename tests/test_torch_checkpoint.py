"""Checkpoints, logging and timing of the port (utils/), fp64.

  * the three tests of tests/test_checkpoint.py on the port: round trip,
    retention of a CheckpointManager, and a time integration restarted
    from a checkpoint that ends bit-equal to the uninterrupted run;
  * the shared file format: a checkpoint written by the JAX package's
    save_checkpoint restores in the port, and one written by the port
    restores in the JAX package, bit-equal (fp64, fp32 and int arrays,
    and the manifest);
  * Logger (rank 0 without a process group, verbosity levels, phase
    timing) and TimingReport.
"""
import io

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import dune_pdelab_tpu_torch as tpt
from dune_pdelab_tpu.utils import checkpoint as jck
from dune_pdelab_tpu_torch.fe import QkFEM
from dune_pdelab_tpu_torch.instationary import OneStepMethod, implicit_euler
from dune_pdelab_tpu_torch.ops import L2, ConvectionDiffusionFEM, ConvectionDiffusionProblem
from dune_pdelab_tpu_torch.solvers import SEQ_CG_Jacobi
from dune_pdelab_tpu_torch.utils import (
    CheckpointManager, Logger, TimingReport, load_checkpoint, save_checkpoint,
)
from dune_pdelab_tpu_torch.utils.common import set_default_device

pytestmark = pytest.mark.fast
torch.set_num_threads(1)
set_default_device("cpu")


def test_roundtrip(tmp_path):
    p = str(tmp_path / "state")
    save_checkpoint(p, {"x": torch.arange(10.0, dtype=torch.float64)}, {"t": 0.25})
    arrays, meta = load_checkpoint(p)
    assert arrays["x"].dtype == torch.float64 and arrays["x"].device.type == "cpu"
    assert np.allclose(arrays["x"].numpy(), np.arange(10.0))
    assert meta["t"] == 0.25
    arrays32, _ = load_checkpoint(p, dtype=torch.float32, device="cpu")
    assert arrays32["x"].dtype == torch.float32


def test_manager_retention(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, {"x": torch.ones(3) * s})
    assert mgr.steps() == [3, 4]
    arrays, meta = mgr.restore()
    assert meta["step"] == 4
    assert float(arrays["x"][0]) == 4.0
    assert CheckpointManager(str(tmp_path / "empty")).restore() == (None, None)


def test_restart_identical(tmp_path):
    class HP(ConvectionDiffusionProblem):
        def f(self, x):
            return torch.sin(3 * x[..., 0])

    mesh = tpt.StructuredMesh([0, 0], [1, 1], (8, 8))
    V = tpt.FunctionSpace(mesh, QkFEM(1, 2))
    cg_ = tpt.constraints(True, V)
    go0 = tpt.GridOperator(V, ConvectionDiffusionFEM(HP()), constraints=cg_)
    go1 = tpt.GridOperator(V, L2(), constraints=cg_)

    def run(x, t0, nsteps):
        osm = OneStepMethod(implicit_euler(), go0, go1, SEQ_CG_Jacobi(),
                            pdesolver="linear", reduction=1e-13)
        t = t0
        for _ in range(nsteps):
            x = osm.apply(t, 0.01, x)
            t += 0.01
        return t, x

    x0 = V.zero(dtype=torch.float64)
    t_all, x_all = run(x0, 0.0, 6)
    t3, x3 = run(x0, 0.0, 3)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, {"x": x3}, {"t": t3})
    arrays, meta = mgr.restore()
    t_res, x_res = run(arrays["x"], meta["t"], 3)
    assert t_res == t_all
    assert torch.equal(x_res, x_all)


def _payload(rng):
    return {"x64": rng.standard_normal(17), "x32": rng.standard_normal(5).astype(np.float32),
            "idx": rng.integers(0, 100, (3, 4))}


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    ref = _payload(np.random.default_rng(1))
    path = jck.save_checkpoint(str(tmp_path / "jax"),
                               {k: jnp.asarray(v) for k, v in ref.items()},
                               {"t": 0.125, "step": 7})
    arrays, meta = load_checkpoint(path, device="cpu")
    assert meta == {"t": 0.125, "step": 7}
    for k, v in ref.items():
        assert arrays[k].numpy().dtype == v.dtype and np.array_equal(arrays[k].numpy(), v)


def test_port_checkpoint_restores_in_jax(tmp_path):
    ref = _payload(np.random.default_rng(2))
    mgr = CheckpointManager(str(tmp_path), prefix="run")
    mgr.save(5, {k: torch.as_tensor(v) for k, v in ref.items()}, {"t": 0.5})
    arrays, meta = jck.CheckpointManager(str(tmp_path), prefix="run").restore()
    assert meta == {"t": 0.5, "step": 5}
    for k, v in ref.items():
        a = np.asarray(arrays[k])
        assert a.dtype == v.dtype and np.array_equal(a, v)


def test_logger_and_timing_report():
    buf = io.StringIO()
    log = Logger(verbosity=2, stream=buf)
    assert log.tag.endswith(":0")           # rank 0 without a process group
    log.info("one")
    log.detail("two")
    log.debug("three")                      # above the verbosity: dropped
    with log.phase("assemble"):
        pass
    lines = buf.getvalue().splitlines()
    assert len(lines) == 3 and lines[0].endswith("] one") and "assemble: " in lines[2]
    rep = TimingReport()
    for _ in range(2):
        rep.start("solve")
        rep.stop("solve")
    s = rep.summary()["solve"]
    assert s["n"] == 2 and s["total"] == rep.total("solve") >= s["max"] >= s["min"] >= 0
