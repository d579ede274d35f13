"""The port's models/ (boilerplate entry points and ALL_CONFIGS) against the JAX
package, fp64 on the CPU.

  * ALL_CONFIGS has the reference's keys, and every entry takes device=;
  * config1-5 at the sizes of tests/test_models.py: the port's dict and
    the JAX package's have the same keys, equal iteration counts, DOF and
    level counts, and errors within 1e-8 relative, and the reference
    test's quality oracles hold. config2 at its size (8^3) is held so in
    tests/test_torch_multigrid.py (test_config2_3d_q2_matches_jax_run, to
    1e-10), so its JAX run is not repeated here. config3's BiCGStab count is set by
    rounding (tests/test_torch_dg.py): it is held to the band of 20 steps
    there, and both packages are solved to 1e-13 so that their errors
    agree to 1e-8;
  * linear_solver_from_config builds the JAX package's backend settings
    from the same keys;
  * solve_stationary's result bundle (iterations, solution, its .vtu
    byte-equal to the JAX package's) and adaptive_solve's (ndofs, eta)
    history over two uniform refinements;
  * solve_instationary from the INI of tests/test_boilerplate_config.py:
    t = 0.2, the .pvd and eight checkpoints written, the L2 error below
    that test's 0.01 and equal to the JAX package's run to 1e-10, the
    final vectors to 1e-10; the latest checkpoint restores the final
    vector and time.
"""
import inspect
import os

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from dune_pdelab_tpu import QkFEM as JQk
from dune_pdelab_tpu.models import ALL_CONFIGS as J_ALL
from dune_pdelab_tpu.models import CGSpace as JCGSpace
from dune_pdelab_tpu.models import StructuredGrid as JGrid
from dune_pdelab_tpu.models import solve_stationary as j_solve
from dune_pdelab_tpu.models.boilerplate import adaptive_solve as j_adaptive
from dune_pdelab_tpu.models.boilerplate import linear_solver_from_config as j_lsfc
from dune_pdelab_tpu.models.boilerplate import solve_instationary as j_solve_inst
from dune_pdelab_tpu.ops import ConvectionDiffusionFEM as JFEM
from dune_pdelab_tpu.ops import ConvectionDiffusionProblem as JProblem
from dune_pdelab_tpu.space.functions import l2_difference as j_l2
from dune_pdelab_tpu.utils import ParameterTree as JTree
from dune_pdelab_tpu_torch import QkFEM
from dune_pdelab_tpu_torch.models import ALL_CONFIGS, CGSpace, StructuredGrid
from dune_pdelab_tpu_torch.models import (
    adaptive_solve, linear_solver_from_config, solve_instationary, solve_stationary,
)
from dune_pdelab_tpu_torch.ops import ConvectionDiffusionFEM as TFEM
from dune_pdelab_tpu_torch.ops import ConvectionDiffusionProblem as TProblem
from dune_pdelab_tpu_torch.space.functions import l2_difference
from dune_pdelab_tpu_torch.utils import CheckpointManager, ParameterTree
from dune_pdelab_tpu_torch.utils.common import set_default_device

pytestmark = pytest.mark.fast
torch.set_num_threads(1)
set_default_device("cpu")
F64 = torch.float64
PI = np.pi

# (name, sizes of tests/test_models.py, the reference test's oracle)
CASES = [
    ("config1", dict(cells=24), lambda r: r["converged"] and r["l2_error"] < 5e-3),
    ("config3", dict(cells=16, reduction=1e-13),
     lambda r: r["converged"] and r["l2_error"] < 2e-3),
    ("config4", dict(cells=12, nsteps=5), lambda r: r["l2_error"] < 0.02),
    ("config5", dict(cells=6),
     lambda r: r["converged"] and r["velocity_l2_error"] < 5e-4),
]
CONFIG3_STEPS_BAND = 20


def test_all_configs_keys():
    assert list(ALL_CONFIGS) == list(J_ALL)
    for name, fn in ALL_CONFIGS.items():
        params = inspect.signature(fn).parameters
        assert "device" in params and params["device"].default is None, name
        assert set(inspect.signature(J_ALL[name]).parameters) <= set(params), name


@pytest.mark.parametrize("name,kw,oracle", CASES, ids=[c[0] for c in CASES])
def test_config_matches_jax(name, kw, oracle):
    got = ALL_CONFIGS[name](**kw)
    want = J_ALL[name](**kw)
    assert set(got) == set(want)
    assert oracle(got) and oracle(want)
    for key, v in want.items():
        if isinstance(v, float):
            assert got[key] == pytest.approx(v, rel=1e-8, abs=1e-300), key
        elif key == "iterations" and name == "config3":
            assert abs(got[key] - v) <= CONFIG3_STEPS_BAND
        else:
            assert got[key] == v, key


def test_linear_solver_from_config():
    for cfg in (None, {"type": "gmres", "preconditioner": "none", "maxiter": "77",
                       "restart": "12", "verbose": "1"}):
        t = linear_solver_from_config(cfg)
        j = j_lsfc(cfg)
        assert (t.solver, t.precond, t.maxiter, t.restart) == (
            j.solver, j.precond, j.maxiter, j.restart)
    t = linear_solver_from_config(ParameterTree({"type": "bicgstab"}), precond="jacobi")
    assert (t.solver, t.precond) == ("bicgstab", "jacobi")


INI = """
[time]
scheme = crank_nicolson
dt = 0.025
tend = 0.2

[linear_solver]
type = cg
preconditioner = jacobi
maxiter = 4000
"""
LAM = 2 * PI**2


class JHP(JProblem):
    def u_exact(self, t):
        return lambda p: np.exp(-t) * np.sin(PI * p[:, 0]) * np.sin(PI * p[:, 1])

    def f(self, x):
        return (LAM - 1.0) * jnp.exp(-self.time) * jnp.sin(PI * x[..., 0]) * jnp.sin(
            PI * x[..., 1])


class THP(TProblem):
    def u_exact(self, t):
        return lambda p: np.exp(-t) * torch.sin(PI * p[:, 0]) * torch.sin(PI * p[:, 1])

    def f(self, x):
        return (LAM - 1.0) * np.exp(-self.time) * torch.sin(PI * x[..., 0]) * torch.sin(
            PI * x[..., 1])


def test_instationary_from_ini(tmp_path):
    p = THP()
    V = CGSpace(StructuredGrid(2, 16), 1)
    x0 = V.interpolate(p.u_exact(0.0), dtype=F64)
    t, x, osm = solve_instationary(
        V, TFEM(p), bctype=p.dirichlet_bctype(), x0=x0, ptree=ParameterTree.from_ini(INI),
        vtk_basename=str(tmp_path / "heat"), checkpoint_dir=str(tmp_path / "ck"))
    assert abs(t - 0.2) < 1e-12
    err = float(l2_difference(V, x, p.u_exact(t)))
    assert err < 0.01
    assert os.path.exists(str(tmp_path / "heat.pvd"))
    assert os.path.exists(str(tmp_path / "heat-00008.vtu"))
    mgr = CheckpointManager(str(tmp_path / "ck"))
    assert mgr.latest_step() == 8

    jp = JHP()
    jV = JCGSpace(JGrid(2, 16), 1)
    jt, jx, _ = j_solve_inst(jV, JFEM(jp), bctype=jp.dirichlet_bctype(),
                             x0=jV.interpolate(jp.u_exact(0.0)),
                             ptree=JTree.from_ini(INI))
    assert t == jt
    jerr = float(j_l2(jV, jx, jp.u_exact(jt)))
    assert err == pytest.approx(jerr, rel=1e-10)
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=0,
                               atol=1e-10 * float(np.abs(np.asarray(jx)).max()))
    arrays, meta = mgr.restore()
    np.testing.assert_array_equal(np.asarray(arrays["x"]), x.numpy())
    assert meta["t"] == pytest.approx(0.2, abs=1e-12)


class JSource(JProblem):
    def f(self, x):
        return jnp.sin(3 * x[..., 0]) + 1.0


class TSource(TProblem):
    def f(self, x):
        return torch.sin(3 * x[..., 0]) + 1.0


def test_stationary_bundle_and_adaptive_solve(tmp_path):
    """solve_stationary's bundle (iterations, solution, its .vtu byte-equal
    to the JAX package's) and adaptive_solve's (ndofs, eta) history over
    two uniform refinements, against the JAX package."""
    jres = j_solve(JCGSpace(JGrid(2, 6), 1), JFEM(JSource()), bctype=True)
    res = solve_stationary(CGSpace(StructuredGrid(2, 6), 1), TFEM(TSource()), bctype=True,
                           dtype=F64)
    assert res.iterations == jres.iterations
    np.testing.assert_allclose(res.x.numpy(), np.asarray(jres.x), rtol=0, atol=1e-12)
    assert (open(res.vtk(str(tmp_path / "t")), "rb").read()
            == open(jres.vtk(str(tmp_path / "j")), "rb").read())
    jh = j_adaptive(lambda: (JSource(), JFEM(JSource())), JGrid(2, 4), JQk(1, 2), bctype=True,
                    tol=1e-9, max_levels=2)[2]
    _, x, th = adaptive_solve(lambda: (TSource(), TFEM(TSource())), StructuredGrid(2, 4),
                              QkFEM(1, 2), bctype=True, tol=1e-9, max_levels=2, dtype=F64)
    assert [n for n, _ in th] == [n for n, _ in jh] and x.dtype == F64
    np.testing.assert_allclose([e for _, e in th], [e for _, e in jh], rtol=1e-10)
