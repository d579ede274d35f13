"""The JAX package's whole solves that tests/test_torch_stokes.py holds the
port's to: computed ahead, in spawned worker processes started with that
module, while its tests run the port (each result as picklable values)."""


def init():
    """Worker start: JAX on the CPU in fp64, as tests/conftest.py sets it."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)


def solve3d(cells):
    """tests/test_stokes3d.py _solve3d: iterations, converged, velocity L2
    and whether StokesGMGSchur built its velocity GMG."""
    from test_stokes3d import _solve3d
    its, conv, l2, pre = _solve3d(cells)
    return its, bool(conv), float(l2), pre._vgmg is not None


def run_cc(n, T):
    """tests/test_stokes3d.py _run_cc: velocity L2 error and GMRES
    iterations per step."""
    from test_stokes3d import _run_cc
    err, its, _ = _run_cc(n=n, T=T)
    return float(err), float(its)


def config5():
    """The JAX package's models/configs.py config5 run."""
    from dune_pdelab_tpu.models.configs import config5_stokes_taylor_hood
    return {k: (v.item() if hasattr(v, "item") else v)
            for k, v in config5_stokes_taylor_hood().items()}
