"""The port and its chip smoke script import neither jax nor the JAX
package (not even one of its jax-free modules): the machine with the card
has no jax, and importing any submodule of the JAX package runs its
`__init__`."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "orbslam2_dualcam_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "orbslam2_dualcam_tpu")

_IMPORT_PACKAGE = """
import importlib, pkgutil
import orbslam2_dualcam_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for n in names:
    importlib.import_module(n)
assert len(names) >= 18, names
"""

_CHECK = """
import sys
bad = sorted(m for m in sys.modules if m.split(".")[0] in %r)
assert not bad, bad
""" % (FORBIDDEN,)


def _sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path: pathlib.Path) -> list[str]:
    """Every module named by an import statement anywhere in the file,
    function bodies included."""
    tree = ast.parse(path.read_text())
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            out.append(node.module)
    return out


@pytest.mark.parametrize("what", ["every_port_module", "chip_smoke"])
def test_imports_without_jax(what):
    """After importing every module of the port, and the smoke script,
    sys.modules holds no jax, no jaxlib and nothing of the JAX package."""
    code = _IMPORT_PACKAGE if what == "every_port_module" else "import chip_smoke"
    proc = subprocess.run([sys.executable, "-c", code + _CHECK], cwd=ROOT,
                          env=dict(os.environ, PYTHONPATH=str(ROOT),
                                   OMP_NUM_THREADS="1"),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_no_source_imports_jax_or_the_jax_package():
    """No import statement in the port or in chip_smoke.py, at module level
    or inside a function, names jax or the JAX package."""
    files = _sources()
    assert len(files) >= 20
    bad = [(str(p.relative_to(ROOT)), m) for p in files
           for m in _imported_modules(p) if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_source_scan_sees_function_level_imports(tmp_path):
    """The scan finds an import inside a function body, which the
    sys.modules check alone would miss."""
    f = tmp_path / "m.py"
    f.write_text("def g():\n    from orbslam2_dualcam_tpu.ops.orb_pattern import x\n"
                 "    import jax.numpy as jnp\n")
    assert _imported_modules(f) == ["orbslam2_dualcam_tpu.ops.orb_pattern",
                                    "jax.numpy"]
