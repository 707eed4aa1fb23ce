"""The port's monocular SLAM system on the CPU, alone, at the size of
tests/test_mono_slam.py::small_cfg (one 320x240 camera, 400 features, 4
levels) and on that file's sequences, held to that file's gates:
initialization, tracking, keyframes, local mapping, local BA, the savers,
`async_mapping=True`, and the branches that are not ported yet (with
those that have been since).  The
abrupt turn, the host-stepped path, `reset()` and the localization mode are
in tests/test_torch_system_modes.py.

The images are the reference's renderer's (the fixture's own); nothing else
of the JAX package runs here.  The RANSAC seed is cfg.vocab.seed = 0, not
the fixture's 42: the port draws its minimal sets from a torch.Generator,
whose stream is not JAX's, and the run is sensitive to the draw (see
ROADMAP.md, Queue 3)."""

import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

from orbslam2_dualcam_tpu.utils import config as ref_config
from orbslam2_dualcam_tpu.utils import synthetic as ref_synthetic
from orbslam2_dualcam_tpu_torch.models.map import Map
from orbslam2_dualcam_tpu_torch.ops.camera import make_rig
from orbslam2_dualcam_tpu_torch.pipeline.system import System
from orbslam2_dualcam_tpu_torch.pipeline.tracking import Tracker
from orbslam2_dualcam_tpu_torch.utils import metrics
from orbslam2_dualcam_tpu_torch.utils.convert import config_from_reference

from torch_parity import scripted_cfg


def small_cfg(seed: int = 0):
    cfg = config_from_reference(scripted_cfg(ref_config))
    return dataclasses.replace(cfg, vocab=dataclasses.replace(cfg.vocab, seed=seed))


def _drive(sys_, world, poses, wait_for_mapper=False):
    K, T_sc = sys_.rig.K.numpy(), sys_.rig.T_sc.numpy()
    states = []
    for k, T_cw in enumerate(poses):
        imgs = ref_synthetic.render_rig(world, K, T_sc, T_cw, H=240, W=320)
        states.append(sys_.track(imgs, k / 30.0))
        if wait_for_mapper:
            # a camera's pace: the next frame comes when the mapping thread
            # has taken the queued keyframes
            t0 = time.monotonic()
            while not sys_._kf_queue.empty() and time.monotonic() - t0 < 10:
                time.sleep(0.005)
    return states


def _orbit(async_mapping=False):
    world = ref_synthetic.make_box_world(np.random.default_rng(42),
                                         n_points=2500, half=6.0)
    sys_ = System(small_cfg(), voc=None, enable_loop_closing=False,
                  async_mapping=async_mapping, device="cpu")
    poses = ref_synthetic.orbit_trajectory(45, radius=1.5,
                                           total_angle=0.8 * np.pi)
    states = _drive(sys_, world, poses, wait_for_mapper=async_mapping)
    sys_.shutdown()
    return sys_, poses, states


@pytest.fixture(scope="module")
def mono_run():
    return _orbit()


def _check_map_gates(sys_, poses, states):
    """The gates of tests/test_mono_slam.py."""
    ev = sys_.tracker.events
    assert states[-1] == "OK", (states, ev)
    assert "OK" in states[:12], ev
    assert sum(1 for s in states if s == "LOST") <= 3, (states, ev)
    assert sys_.map.n_keyframes >= 4, ev
    assert sys_.map.n_points > 150
    assert sys_.mapper.n_triangulated > 50
    traj = sys_.tracker.composed_trajectory()
    assert len(traj) > 30
    est = metrics.trajectory_positions(traj)
    gt = np.asarray([-poses[f][:3, :3].T @ poses[f][:3, 3]
                     for f in [t[0] for t in traj]])
    ate = metrics.ate_rmse(est, gt, with_scale=True)
    assert ate < 0.30, f"ATE {ate:.4f} m; events={ev}"


def test_orbit_meets_the_mono_slam_gates(mono_run):
    sys_, poses, states = mono_run
    _check_map_gates(sys_, poses, states)
    tr = sys_.tracker
    assert tr.n_fused_frames >= 1
    assert tr.n_fused_frames + tr.n_stepped_frames == \
        sum(1 for s in states[states.index("OK") + 1:] if s == "OK")
    # at least one local BA ran, on a window of several keyframes
    assert sys_.mapper.ba_log and max(b[1] for b in sys_.mapper.ba_log) >= 4
    assert all(np.isfinite(b[4]) for b in sys_.mapper.ba_log)
    assert len(tr.two_view_ms) >= 1
    assert {"fused", "extract", "initialize", "track", "store_refresh"} <= \
        set(tr.timer.samples)
    assert {"triangulate", "fuse", "local_ba"} <= set(sys_.mapper.timer.samples)


def test_savers(mono_run, tmp_path):
    sys_, _, _ = mono_run
    fp, kp, mp = (tmp_path / n for n in ("frames.txt", "kfs.txt", "map.txt"))
    sys_.save_frame_trajectory(str(fp))
    sys_.save_keyframe_trajectory(str(kp))
    sys_.save_map_points(str(mp))
    lines = fp.read_text().strip().splitlines()
    assert len(lines) == len(sys_.tracker.trajectory)
    assert len(lines[0].split()) == 8      # x y z qx qy qz qw id
    q = np.asarray(lines[5].split()[3:7], float)
    assert abs(np.linalg.norm(q) - 1.0) < 1e-4
    klines = kp.read_text().strip().splitlines()
    assert len(klines) == sys_.map.n_keyframes
    assert len(klines[0].split()) == 8
    mlines = mp.read_text().strip().splitlines()
    assert len(mlines) == sys_.map.n_points and len(mlines[0].split()) == 4


def test_async_mapping_meets_the_map_gates():
    before = threading.active_count()
    sys_, poses, states = _orbit(async_mapping=True)
    assert not sys_._mapper_thread.is_alive()
    assert threading.active_count() == before
    assert sys_._kf_queue.empty()
    _check_map_gates(sys_, poses, states)
    assert sys_.mapper.ba_log


def _tiny_voc():
    from orbslam2_dualcam_tpu_torch.vocab import bow
    desc = np.random.default_rng(0).integers(
        0, 2 ** 32, (200, 8), dtype=np.uint64).astype(np.uint32)
    return bow.train_vocabulary(desc, branching=4, depth=2, device="cpu")


@pytest.mark.parametrize("what,kwargs,names", [
    ("vocabulary", dict(voc="tiny", enable_loop_closing=False), None),
    ("loop closing", dict(voc="tiny", enable_loop_closing=True), None),
    ("deferred", dict(deferred_tracking=True), "deferred-tracking slice"),
    ("viewer", dict(viewer=True), "surface"),
    ("mesh", dict(mesh=object()), "distributed-BA slice"),
])
def test_system_stubs_raise_and_name_their_slice(what, kwargs, names):
    """What is not ported raises and names its slice; a vocabulary, with
    loop closing or without, is ported, and builds the keyframe database
    (and the loop closer, which the mapper calls)."""
    kw = dict(voc=None, enable_loop_closing=False, device="cpu")
    kw.update(kwargs)
    if kw["voc"] == "tiny":
        kw["voc"] = _tiny_voc()
    if names is None:
        sys_ = System(small_cfg(), **kw)
        assert sys_.kfdb is not None and sys_.tracker.kfdb is sys_.kfdb
        assert sys_.mapper.kfdb is sys_.kfdb
        assert sys_.kfdb.erase in sys_.map.on_erase_keyframe
        if kw["enable_loop_closing"]:
            lc = sys_.loop_closer
            assert sys_.mapper.loop_closer is lc and lc is not None
            assert (lc.map, lc.kfdb, lc.voc) == (sys_.map, sys_.kfdb, kw["voc"])
        else:
            assert sys_.loop_closer is None
        return
    with pytest.raises(NotImplementedError, match=names):
        System(small_cfg(), **kw)


@pytest.mark.parametrize("what,kwargs,names", [
    ("vocabulary", dict(voc="tiny"), None),
    ("keyframe database", dict(kfdb="db"), None),
    ("deferred", dict(deferred=True), "deferred-tracking slice"),
    ("mesh", dict(mesh=object()), "distributed-BA slice"),
])
def test_tracker_stubs_raise_and_name_their_slice(what, kwargs, names):
    from orbslam2_dualcam_tpu_torch.models.kfdb import KeyFrameDatabase
    cfg = small_cfg()
    kwargs = dict(kwargs)
    if kwargs.get("voc") == "tiny":
        kwargs["voc"] = _tiny_voc()
    if kwargs.get("kfdb") == "db":
        kwargs["kfdb"] = KeyFrameDatabase(cfg.n_cameras, 16)
    if names is None:
        tr = Tracker(cfg, make_rig(cfg, device="cpu"), **kwargs)
        assert tr.voc is kwargs.get("voc") and tr.kfdb is kwargs.get("kfdb")
        return
    with pytest.raises(NotImplementedError, match=names):
        Tracker(cfg, make_rig(cfg, device="cpu"), **kwargs)


def test_loop_closer_is_a_stub():
    """The loop closer builds (it raised before loop closing was ported) and
    skips detection while the map holds fewer than `loop_kf_gap`
    keyframes."""
    from orbslam2_dualcam_tpu_torch.models.kfdb import KeyFrameDatabase
    from orbslam2_dualcam_tpu_torch.pipeline.loop_closing import LoopCloser
    cfg = small_cfg()
    voc = _tiny_voc()
    m = Map()
    lc = LoopCloser(cfg, make_rig(cfg, device="cpu"), m,
                    KeyFrameDatabase(cfg.n_cameras, voc.n_words), voc)
    assert lc.device.type == "cpu" and lc.sim3_sampler is not None
    assert lc._detect(type("KF", (), {"kid": 0})()) == []
    assert (lc.n_loops_closed, lc.n_loop_fused, lc.debug_log) == (0, 0, [])


def test_metric_map_state_is_a_stub():
    """On a metric map `_update_full_state` counts the keyframes tied to
    the second map: with none it stays where it is (it raised before the
    dual bootstrap was ported)."""
    cfg = small_cfg()
    m = Map()
    tr = Tracker(cfg, make_rig(cfg, device="cpu"), slam_map=m)
    assert tr._update_full_state(None) is None      # not scaled: returns
    assert tr.flush() == "NOT_INITIALIZED"
    m.map_scaled = True
    assert tr._update_full_state(None) is None
    assert tr.state == "NOT_INITIALIZED" and not tr.events


def test_default_device_is_the_card():
    """device=None means the current CUDA device: where there is none, the
    system raises instead of running on the CPU."""
    if torch.cuda.is_available():
        sys_ = System(small_cfg(), voc=None, enable_loop_closing=False)
        assert sys_.rig.K.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            System(small_cfg(), voc=None, enable_loop_closing=False)
