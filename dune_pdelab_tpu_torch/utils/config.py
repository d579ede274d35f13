"""Hierarchical runtime configuration (Dune::ParameterTree analog).

PyTorch port of dune_pdelab_tpu/utils/config.py (pure Python, no tensors;
a copy of its own so the port imports nothing of the JAX package). The
reference configures its solvers from INI files via Dune::ParameterTree
(reference: dune-common; used at dune/pdelab/stationary/linearproblem.hh:98-138
and solver/newton.hh setParameters). This is a minimal dotted-key tree with an
INI reader so solver classes stay configurable at run time.
"""
from __future__ import annotations

from typing import Any, Iterator


class ParameterTree:
    """Dotted-key hierarchical string store with typed getters."""

    def __init__(self, data: dict | None = None):
        self._data: dict[str, Any] = {}
        if data:
            for k, v in data.items():
                self[k] = v

    # -- mapping interface over dotted keys ---------------------------------
    def __setitem__(self, key: str, value: Any) -> None:
        self._data[key] = value

    def __getitem__(self, key: str) -> Any:
        return self._data[key]

    def __contains__(self, key: str) -> bool:
        return key in self._data

    def __iter__(self) -> Iterator[str]:
        return iter(self._data)

    def get(self, key: str, default: Any = None, type: type | None = None):
        if key not in self._data:
            return default
        v = self._data[key]
        if type is None and default is not None:
            type = default.__class__
        if type is None or isinstance(v, type):
            return v
        if type is bool and isinstance(v, str):
            return v.strip().lower() in ("1", "true", "yes", "on")
        return type(v)

    def sub(self, prefix: str) -> "ParameterTree":
        """Subtree view: keys under `prefix.` with the prefix stripped."""
        p = prefix + "."
        return ParameterTree(
            {k[len(p):]: v for k, v in self._data.items() if k.startswith(p)}
        )

    def to_dict(self) -> dict:
        return dict(self._data)

    # -- INI I/O -------------------------------------------------------------
    @classmethod
    def from_ini(cls, text: str) -> "ParameterTree":
        """Parse DUNE-style INI: `[section]` headers + `key = value` lines."""
        tree = cls()
        section = ""
        for raw in text.splitlines():
            line = raw.split("#", 1)[0].strip()
            if not line:
                continue
            if line.startswith("[") and line.endswith("]"):
                section = line[1:-1].strip()
                continue
            if "=" in line:
                k, v = line.split("=", 1)
                key = f"{section}.{k.strip()}" if section else k.strip()
                tree[key] = v.strip()
        return tree

    @classmethod
    def from_ini_file(cls, path) -> "ParameterTree":
        with open(path) as f:
            return cls.from_ini(f.read())
