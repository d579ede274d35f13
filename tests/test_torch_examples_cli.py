"""The port's example scripts as a user runs them: one example's main() in
a subprocess writes only under --out, and each script of examples/ has its
module (tests/test_torch_examples.py holds their numbers)."""
import os
import subprocess
import sys

import pytest

from torch_example_harness import ROOT, example

pytestmark = pytest.mark.fast


def test_example_main_writes_only_under_out(tmp_path):
    """`python -m ...ex01_poisson --device cpu --out DIR` in a subprocess
    with an empty working directory, HOME and TMPDIR: it exits 0, prints
    OK, and every file it made is under DIR."""
    out, work = tmp_path / "out", tmp_path / "work"
    home, tmp = tmp_path / "home", tmp_path / "tmp"
    for d in (work, home, tmp):
        d.mkdir()
    watch = [ROOT, ROOT / "examples", ROOT / "dune_pdelab_tpu_torch" / "examples"]
    before = {d: set(os.listdir(d)) for d in watch}
    env = dict(os.environ, HOME=str(home), TMPDIR=str(tmp),
               PYTHONPATH=os.pathsep.join([str(ROOT)] + sys.path))
    proc = subprocess.run(
        [sys.executable, "-m", "dune_pdelab_tpu_torch.examples.ex01_poisson", "--device", "cpu",
         "--out", str(out), "--cells", "4"],
        cwd=str(work), env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "OK"
    assert sorted(os.listdir(out)) == ["poisson.vtu"]
    assert os.listdir(work) == [] and os.listdir(home) == [] and os.listdir(tmp) == []
    assert {d: set(os.listdir(d)) - before[d] for d in watch} == {d: set() for d in watch}


def test_one_example_per_reference_script():
    """Each script of examples/ has its module exNN_<same name> with run()
    and main() (tests/test_torch_slice.py scans every module of the port,
    these included, for JAX imports)."""
    scripts = sorted(p.stem for p in (ROOT / "examples").glob("[0-9][0-9]_*.py"))
    assert len(scripts) == 15
    for stem in scripts:
        mod = example(f"ex{stem}")
        assert callable(mod.run) and callable(mod.main), stem
