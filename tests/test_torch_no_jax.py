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
for n in %r:
    assert pkg.__name__ + "." + n in names, n
assert len(names) >= 54, names
import sys
lazy = sorted(m for m in sys.modules if m.split(".")[0] in ("cv2", "matplotlib"))
assert not lazy, lazy
"""

# the modules of the mono SLAM slice, of the vocabulary / dual-bootstrap
# slice, of loop closing, of the user's surface, of the deployment
# configuration (the C++ postings index, the readback handle) and of
# distributed BA with its examples must be among those imported (the
# surface and the examples keep cv2 and matplotlib inside their functions)
_SLAM_MODULES = ("models.map", "ops.epipolar", "ops.ransac", "optim.ba",
                 "optim.factors", "pipeline.ba_pack", "pipeline.local_mapping",
                 "pipeline.tracking", "pipeline.system", "utils.metrics",
                 "utils.profiling", "models.kfdb", "vocab.orbvoc",
                 "optim.scale_opt", "optim.pose_graph",
                 "pipeline.loop_closing", "optim.sim3_opt",
                 "utils.yaml_config", "utils.checkpoint", "utils.datasets",
                 "viz.viewer", "viz.live", "tools", "run", "native",
                 "native.invfile", "utils.device", "parallel",
                 "parallel.runtime", "parallel.dist_ba", "examples",
                 "examples.bench_dist_ba", "examples.eval_tum")
_IMPORT_PACKAGE = _IMPORT_PACKAGE % (_SLAM_MODULES,)

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
    sys.modules holds no jax, no jaxlib and nothing of the JAX package;
    after the port's modules, no cv2 and no matplotlib either (the card's
    machine may lack them, so they are imported inside the functions)."""
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
    assert len(files) >= 56
    assert {"tracking.py", "system.py", "local_mapping.py", "ba.py", "ransac.py",
            "epipolar.py", "ba_pack.py", "map.py", "kfdb.py", "orbvoc.py",
            "scale_opt.py", "pose_graph.py", "loop_closing.py",
            "sim3_opt.py", "yaml_config.py", "checkpoint.py", "datasets.py",
            "viewer.py", "live.py", "tools.py", "run.py", "invfile.py",
            "device.py", "runtime.py", "dist_ba.py", "bench_dist_ba.py",
            "eval_tum.py"} <= \
        {p.name for p in files}
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


def test_system_entry_point_runs_without_jax():
    """The system's entry point, driven for five frames on the CPU in a
    fresh interpreter, synchronously (its map's global BA then solved on a
    2-shard mesh) and then deferred (lag 1, so frames are dispatched and
    read back a frame behind) with a flush(), pulls in neither jax nor the
    JAX package (a lazy import inside a method would show here and in the
    scan, not at import time)."""
    code = """
import dataclasses, sys
import numpy as np, torch
torch.set_num_threads(1)
from orbslam2_dualcam_tpu_torch import CameraConfig, OrbConfig, SystemConfig
from orbslam2_dualcam_tpu_torch.pipeline.system import System
from orbslam2_dualcam_tpu_torch.utils import synthetic
cfg = SystemConfig(cameras=(CameraConfig(width=320, height=240, fx=260, fy=260,
                                         cx=160, cy=120),),
                   orb=OrbConfig(n_features=400, n_levels=4))
s = System(cfg, voc=None, enable_loop_closing=False, device="cpu")
world = synthetic.make_box_world(np.random.default_rng(42), half=6.0, tex_size=256)
poses = synthetic.orbit_trajectory(45, radius=1.5, total_angle=0.8 * np.pi)
K, T_sc = s.rig.K.numpy(), s.rig.T_sc.numpy()
states = [s.track(synthetic.render_rig(world, K, T_sc, T, H=240, W=320), k / 30.0)
          for k, T in enumerate(poses[:5])]
assert states[-1] == "OK", (states, s.tracker.events)
assert s.map.n_keyframes >= 2 and s.mapper.timer.samples["triangulate"]
from orbslam2_dualcam_tpu_torch.parallel import runtime
from orbslam2_dualcam_tpu_torch.pipeline import ba_pack
prob = ba_pack.pack_problem(s.map, sorted(s.map.keyframes), {s.map.origin_kid},
                            np.asarray(cfg.orb.level_sigma2, np.float32), 1,
                            device="cpu")[0]
r = runtime.solve_ba_auto(prob, s.rig.T_sc, s.rig.adj_sc, s.rig.K, iters=2,
                          mesh=runtime.Mesh(("cpu",) * 2), dist_edge_threshold=1)
assert bool(torch.isfinite(r.cost)) and r.edge_chi2.shape == prob.edges.kf.shape
assert "orbslam2_dualcam_tpu_torch.parallel.dist_ba" in sys.modules
cfg1 = dataclasses.replace(cfg, tracker=dataclasses.replace(cfg.tracker, pipeline_depth=1))
d = System(cfg1, voc=None, enable_loop_closing=False, deferred_tracking=True,
           device="cpu")
for k, T in enumerate(poses[:5]):
    d.track(synthetic.render_rig(world, K, T_sc, T, H=240, W=320), k / 30.0)
assert d.tracker.deferred and d.tracker.timer.samples["fused_dispatch"]
assert d.tracker.flush() == "OK", d.tracker.events
assert max(t[0] for t in d.tracker.trajectory) == 4
"""
    proc = subprocess.run([sys.executable, "-c", code + _CHECK], cwd=ROOT,
                          env=dict(os.environ, PYTHONPATH=str(ROOT),
                                   OMP_NUM_THREADS="1"),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_system_with_a_vocabulary_runs_without_jax():
    """`System(cfg, voc).track`, loop closing on, on a small dual rig for
    five frames on the CPU in a fresh interpreter, the vocabulary trained
    there by the port: keyframes reach the database and the loop closer,
    the first cross-camera relocalization is attempted, and neither jax nor
    the JAX package is pulled in."""
    code = """
import numpy as np, torch
torch.set_num_threads(1)
from orbslam2_dualcam_tpu_torch import CameraConfig, OrbConfig, SystemConfig
from orbslam2_dualcam_tpu_torch.ops import orb
from orbslam2_dualcam_tpu_torch.pipeline.system import System
from orbslam2_dualcam_tpu_torch.utils import synthetic
from orbslam2_dualcam_tpu_torch.utils.config import VocabConfig
from orbslam2_dualcam_tpu_torch.vocab import bow
cam = dict(width=320, height=240, fx=260, fy=260, cx=160, cy=120)
cfg = SystemConfig(cameras=(CameraConfig(**cam),
                            CameraConfig(**cam, q_sc=(0.0, 0.0, 1.0, 0.0),
                                         t_sc=(0.0, 0.0, 0.5))),
                   orb=OrbConfig(n_features=400, n_levels=4),
                   vocab=VocabConfig(branching=6, depth=2))
world = synthetic.make_box_world(np.random.default_rng(42), half=6.0, tex_size=256)
poses = synthetic.orbit_trajectory(45, radius=1.5, total_angle=0.8 * np.pi)
K = np.array([[260.0, 0, 160], [0, 260, 120], [0, 0, 1]])
descs = []
for T in poses[::15]:
    f = orb.extract_orb(torch.as_tensor(synthetic.render(world, K, T, H=240, W=320)),
                        cfg.orb, 400)
    descs.append(f.desc.numpy().view(np.uint32)[f.valid.numpy()])
voc = bow.train_vocabulary(np.concatenate(descs), branching=6, depth=2, seed=1,
                           weight_docs=descs, device="cpu")
s = System(cfg, voc=voc, enable_loop_closing=True, device="cpu")
K, T_sc = s.rig.K.numpy(), s.rig.T_sc.numpy()
states = [s.track(synthetic.render_rig(world, K, T_sc, T, H=240, W=320), k / 30.0)
          for k, T in enumerate(poses[:5])]
assert states[-1] == "OK", (states, s.tracker.events)
assert s.map.n_keyframes >= 2
assert set(s.kfdb.bow[0]) == set(s.kfdb.bow[1]) == set(s.map.keyframes)
assert any(e.startswith("XTRY@") for e in s.tracker.events), s.tracker.events
assert s.tracker.timer.samples["xreloc"]
assert len(s.loop_closer.timer.samples["detect"]) >= 2
s.set_compulsory_lost()
state = s.track(synthetic.render_rig(world, K, T_sc, poses[5], H=240, W=320), 5 / 30.0)
assert any(e.startswith("FORCED_LOST@") for e in s.tracker.events)
assert s.tracker.timer.samples["relocalize"]
"""
    proc = subprocess.run([sys.executable, "-c", code + _CHECK], cwd=ROOT,
                          env=dict(os.environ, PYTHONPATH=str(ROOT),
                                   OMP_NUM_THREADS="1"),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
