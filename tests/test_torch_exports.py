"""The port's public names against the reference package's `__init__`s.

Each `__init__.py` of dune_pdelab_tpu is read as text and parsed (AST); no
module of the JAX package is imported. For every name it exports from one
of its modules (`from dune_pdelab_tpu.X.Y import a` or a submodule
`from dune_pdelab_tpu.X import Y`), the test asks whether the port has the
counterpart module (dune_pdelab_tpu_torch/X/Y.py). If it has, the name
must import from the port's counterpart of the same subpackage; if it has
not, the name must be in EXPECTED_MISSING, the names of the modules still
to port (ROADMAP Queue 1: slices 12 and 13d). Every name in
EXPECTED_MISSING must still be missing, so the list shrinks with each
ported module.
"""
import ast
import importlib
from pathlib import Path

import pytest

pytestmark = pytest.mark.fast

ROOT = Path(__file__).resolve().parent.parent
REF, PORT = "dune_pdelab_tpu", "dune_pdelab_tpu_torch"

# (reference subpackage, name): modules not ported yet
EXPECTED_MISSING = {
    # 12: parallel
    *{("dune_pdelab_tpu.parallel", n) for n in (
        "ShardedGridOperator", "ShardedContextMixin", "WindowShardedGridOperator",
        "block_partition", "pad_partition", "DofShardedStencil", "sharded_cg_solve",
        "NonoverlappingShardedGridOperator", "ShardedGeometricMultigrid",
        "ShardedAMG", "allreduce", "exchange_planes", "masked_dot",
        "partition_weighted", "imbalance", "rebalance", "redistribute")},
    # 13d: models and io
    *{("dune_pdelab_tpu.models", n) for n in (
        "StructuredGrid", "CGSpace", "DGSpace", "P0Space", "GalerkinGlobalAssembler",
        "solve_stationary", "linear_solver_from_config", "config1_poisson_2d_mf",
        "config2_poisson_3d_gmg", "config3_convdiff_sipg",
        "config4_heat_theta_newton", "config5_stokes_taylor_hood", "ALL_CONFIGS")},
    *{("dune_pdelab_tpu.io", n) for n in (
        "VTKWriter", "VTKSequenceWriter", "ParallelVTKWriter", "read_dgf")},
}


def _inits():
    return sorted(p.parent.relative_to(ROOT) for p in (ROOT / REF).rglob("__init__.py"))


def _exports(init_dir):
    """(name, defining reference module) of every from-import of the
    reference package in init_dir/__init__.py."""
    tree = ast.parse((ROOT / init_dir / "__init__.py").read_text())
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module and (
                node.module == REF or node.module.startswith(REF + ".")):
            for alias in node.names:
                mod = node.module
                if (ROOT / mod.replace(".", "/") / f"{alias.name}.py").exists():
                    mod = f"{mod}.{alias.name}"          # a submodule import
                out.append((alias.asname or alias.name, mod))
    return out


def _ported(ref_module):
    rel = Path(PORT + ref_module[len(REF):].replace(".", "/"))
    return (ROOT / rel.with_suffix(".py")).exists() or (ROOT / rel / "__init__.py").exists()


@pytest.mark.parametrize("init_dir", [str(d) for d in _inits()])
def test_exports_of_ported_modules(init_dir):
    ref_pkg = init_dir.replace("/", ".")
    port_name = PORT + ref_pkg[len(REF):]
    port_pkg = (importlib.import_module(port_name) if _ported(ref_pkg) else None)
    absent, unexpected, stale = [], [], []
    for name, mod in _exports(init_dir):
        listed = (ref_pkg, name) in EXPECTED_MISSING
        if _ported(mod):
            if not hasattr(port_pkg, name):
                absent.append(f"{name} (from {mod})")
            if listed:
                stale.append(name)
        elif not listed:
            unexpected.append(f"{name} (from {mod})")
    assert not absent, f"{port_name} lacks {absent}"
    assert not unexpected, f"unported names not in EXPECTED_MISSING: {unexpected}"
    assert not stale, f"ported now, remove from EXPECTED_MISSING: {stale}"


def test_expected_missing_names_exist_in_the_reference():
    """Every listed name is still exported by the reference."""
    exported = {(d.replace("/", "."), n) for d in map(str, _inits())
                for n, _ in _exports(d)}
    assert EXPECTED_MISSING <= exported, EXPECTED_MISSING - exported
