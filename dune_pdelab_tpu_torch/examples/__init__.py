"""Runnable end-to-end scripts, one per script of the JAX package's
examples/ (examples/README.md): the port's user entry points.

Each module `exNN_<name>` has `run(..., device=None, dtype=..., out_dir=None)
-> dict`, which builds and solves its problem at the reference script's
sizes, makes the reference script's checks and returns every number the
reference prints, and `main(argv)`:

    python -m dune_pdelab_tpu_torch.examples.ex01_poisson [--device cpu] [--out DIR]

`--device` defaults to the card (`utils/common.default_device()`); the CPU
runs only when asked for. Files go under `--out` (default: a fresh
temporary directory), never into the repository. The scripts print the
reference's lines and end with `OK`.
"""
