"""The port and its chip smoke script import no jax: the machine with the
card has none."""

import ast
import os
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_PACKAGE = """
import importlib, pkgutil
import orbslam2_dualcam_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for n in names:
    importlib.import_module(n)
assert len(names) >= 15, names
"""

_CHECK = """
import sys
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib")))
assert not bad, bad
"""


@pytest.mark.parametrize("what", ["every_port_module", "chip_smoke"])
def test_imports_without_jax(what):
    code = _IMPORT_PACKAGE if what == "every_port_module" else "import chip_smoke"
    proc = subprocess.run([sys.executable, "-c", code + _CHECK], cwd=ROOT,
                          env=dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1"),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    if what == "chip_smoke":
        # the script reaches the config dataclasses through the port's
        # re-export only, never through the JAX package itself
        with open(os.path.join(ROOT, "chip_smoke.py")) as fh:
            tree = ast.parse(fh.read())
        imported = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
                    for a in n.names]
        imported += [n.module for n in ast.walk(tree)
                     if isinstance(n, ast.ImportFrom) and n.module]
        bad = [m for m in imported if m.split(".")[0] in ("jax", "orbslam2_dualcam_tpu")]
        assert not bad, bad
