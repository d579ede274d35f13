"""The port's public names against the reference package's `__init__`s.

Each `__init__.py` of dune_pdelab_tpu is read as text and parsed (AST); no
module of the JAX package is imported. For every name it exports from one
of its modules (`from dune_pdelab_tpu.X.Y import a` or a submodule
`from dune_pdelab_tpu.X import Y`), the test asks whether the port has the
counterpart module (dune_pdelab_tpu_torch/X/Y.py). If it has, the name
must import from the port's counterpart of the same subpackage; if it has
not, the name must be in EXPECTED_MISSING, the names of the modules still
to port. Every module is ported, so EXPECTED_MISSING is empty: every name
the reference's `__init__`s export, io and models included, must import
from the port.
"""
import ast
import importlib
from pathlib import Path

import pytest

pytestmark = pytest.mark.fast

ROOT = Path(__file__).resolve().parent.parent
REF, PORT = "dune_pdelab_tpu", "dune_pdelab_tpu_torch"

# (reference subpackage, name): modules not ported yet. Every module of
# the reference is ported, so the list is empty and stays so: a module the
# reference gains must be ported with its exports.
EXPECTED_MISSING: set[tuple[str, str]] = set()


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
