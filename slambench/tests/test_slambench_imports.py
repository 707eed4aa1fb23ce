"""Nothing that the benchmark runs loads JAX or the JAX package: the
top-level name of every loaded module, compared whole (the port's own
name, orbslam2_dualcam_tpu_torch, begins with the JAX package's)."""

import ast
import subprocess
import sys
from pathlib import Path

from slambench import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "slambench"


def test_forbidden_modules_compare_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "orbslam2_dualcam_tpu_torch_x", sys)
    assert "orbslam2_dualcam_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.fake", sys)
    assert "jaxlib" in harness.forbidden_modules()


def test_sources_import_no_forbidden_module():
    for path in BENCH.rglob("*.py"):
        if "tests" in path.parts:
            continue
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in harness.FORBIDDEN, (path, n)


def test_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").rglob("*.py"):
        text = path.read_text()
        for node in ast.walk(ast.parse(text)):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                mods = ([a.name for a in node.names] if isinstance(node, ast.Import)
                        else [node.module or ""])
                for m in mods:
                    assert not m.startswith("orbslam2_dualcam_tpu"), (path, m)


def test_loaded_modules_of_a_run_path():
    """Import everything a run imports, the port's System and the
    harness's lazy imports included, in a fresh interpreter."""
    code = (
        "import sys, pathlib; sys.path.insert(0, %r)\n"
        "import slambench.run, slambench.calibrate, slambench.harness\n"
        "from slambench.reference import orb, geometry, k1_roofline, trajectory\n"
        "import slambench.controls, slambench.traffic_plan as tp\n"
        "for folder in ('paths', 'steps'):\n"
        "    for p in (pathlib.Path(%r) / folder).glob('*.py'):\n"
        "        tp.load_kind(folder, p.stem)\n"
        "from orbslam2_dualcam_tpu_torch.pipeline.system import System\n"
        "from orbslam2_dualcam_tpu_torch.utils.yaml_config import load_rig_yaml\n"
        "from orbslam2_dualcam_tpu_torch.ops import orb as porb\n"
        "from orbslam2_dualcam_tpu_torch.vocab import bow\n"
        "import torch.profiler\n"
        "for p in pathlib.Path(%r).glob('*.py'):\n"
        "    import importlib.util as u\n"
        "    s = u.spec_from_file_location('m_' + p.stem.replace('.', '_'), p)\n"
        "    s.loader.exec_module(u.module_from_spec(s))\n"
        "print(','.join(slambench.harness.forbidden_modules()))\n"
    ) % (str(ROOT), str(BENCH), str(BENCH / "metrics"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""
