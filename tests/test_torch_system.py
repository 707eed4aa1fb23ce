"""The port's monocular SLAM system on the CPU, alone, at the size of
tests/test_mono_slam.py::small_cfg (one 320x240 camera, 400 features, 4
levels): the configuration and the frame loop of the system tests, and the
branches that are not ported yet (with those that have been since).  The
orbit runs under that file's gates (initialization, tracking, keyframes,
local mapping, local BA, the savers, `async_mapping=True`) are in
tests/test_torch_system_orbit.py; the abrupt turn and the host-stepped path
in tests/test_torch_system_modes.py; `reset()` and the localization mode in
tests/test_torch_system_reset.py.

The images are the reference's renderer's (the fixture's own); nothing else
of the JAX package runs here.  The RANSAC seed is cfg.vocab.seed = 0, not
the fixture's 42: the port draws its minimal sets from a torch.Generator,
whose stream is not JAX's, and the run is sensitive to the draw (see
ROADMAP.md, Queue 3)."""

import dataclasses
import time

import numpy as np
import pytest
import torch

from orbslam2_dualcam_tpu.utils import config as ref_config
from orbslam2_dualcam_tpu.utils import synthetic as ref_synthetic
from orbslam2_dualcam_tpu_torch.models.map import Map
from orbslam2_dualcam_tpu_torch.ops.camera import make_rig
from orbslam2_dualcam_tpu_torch.parallel.runtime import Mesh
from orbslam2_dualcam_tpu_torch.pipeline.system import System
from orbslam2_dualcam_tpu_torch.pipeline.tracking import Tracker
from orbslam2_dualcam_tpu_torch.utils.convert import config_from_reference

from torch_parity import scripted_cfg

torch.set_num_threads(1)


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


def _tiny_voc():
    from orbslam2_dualcam_tpu_torch.vocab import bow
    desc = np.random.default_rng(0).integers(
        0, 2 ** 32, (200, 8), dtype=np.uint64).astype(np.uint32)
    return bow.train_vocabulary(desc, branching=4, depth=2, device="cpu")


@pytest.mark.parametrize("what,kwargs,names", [
    ("vocabulary", dict(voc="tiny", enable_loop_closing=False), None),
    ("loop closing", dict(voc="tiny", enable_loop_closing=True), None),
    # ported with the deployment configuration: builds (the id keeps the
    # slice's name)
    pytest.param("deferred", dict(deferred_tracking=True), None,
                 id="deferred-kwargs2-deferred-tracking slice"),
    # ported with the surface: builds (the id keeps the slice's name)
    pytest.param("viewer", dict(viewer=True), None,
                 id="viewer-kwargs3-surface"),
    # ported with distributed BA: builds (the id keeps the slice's name)
    pytest.param("mesh", dict(mesh="cpu mesh"), None,
                 id="mesh-kwargs4-distributed-BA slice"),
])
def test_system_stubs_raise_and_name_their_slice(what, kwargs, names):
    """What is not ported raises and names its slice; a vocabulary, with
    loop closing or without, is ported, and builds the keyframe database
    (and the loop closer, which the mapper calls); the viewer is ported, and
    serves until shutdown; deferred tracking is ported, and builds the
    pipelined tracker at the configured depth; a mesh is ported, and is
    handed to the tracker."""
    kw = dict(voc=None, enable_loop_closing=False, device="cpu")
    kw.update(kwargs)
    if kw["voc"] == "tiny":
        kw["voc"] = _tiny_voc()
    if kw.get("mesh") == "cpu mesh":
        kw["mesh"] = Mesh(("cpu", "cpu"))
    if names is None:
        sys_ = System(small_cfg(), **kw)
        if kw.get("mesh") is not None:
            assert sys_.mesh is sys_.tracker.mesh is kw["mesh"]
            assert sys_.mesh.size == 2
            return
        if kw.get("deferred_tracking"):
            tr = sys_.tracker
            assert tr.deferred and tr.map_lock is None
            assert tr._depth == small_cfg().tracker.pipeline_depth == 3
            assert tr._track_batch is not None
            assert sys_.shutdown() is None and tr._pending is None
            return
        if kw.get("viewer"):
            try:
                assert sys_.viewer is not None and sys_.viewer.port > 0
            finally:
                sys_.shutdown()
            assert sys_.viewer is None
            return
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
    # ported with the deployment configuration: builds (the id keeps the
    # slice's name)
    pytest.param("deferred", dict(deferred=True), None,
                 id="deferred-kwargs2-deferred-tracking slice"),
    # ported with distributed BA: builds (the id keeps the slice's name)
    pytest.param("mesh", dict(mesh="cpu mesh"), None,
                 id="mesh-kwargs3-distributed-BA slice"),
])
def test_tracker_stubs_raise_and_name_their_slice(what, kwargs, names):
    from orbslam2_dualcam_tpu_torch.models.kfdb import KeyFrameDatabase
    cfg = small_cfg()
    kwargs = dict(kwargs)
    if kwargs.get("voc") == "tiny":
        kwargs["voc"] = _tiny_voc()
    if kwargs.get("kfdb") == "db":
        kwargs["kfdb"] = KeyFrameDatabase(cfg.n_cameras, 16)
    if kwargs.get("mesh") == "cpu mesh":
        kwargs["mesh"] = Mesh(("cpu",) * 4)
    if names is None:
        tr = Tracker(cfg, make_rig(cfg, device="cpu"), **kwargs)
        assert tr.voc is kwargs.get("voc") and tr.kfdb is kwargs.get("kfdb")
        assert tr.mesh is kwargs.get("mesh")
        depth = cfg.tracker.pipeline_depth
        assert tr.deferred == bool(kwargs.get("deferred"))
        assert tr._depth == (depth if tr.deferred else 1)
        assert (tr._track_batch is not None) == tr.deferred
        if tr.deferred:
            # lag 1 builds no batched step; without the fused step there is
            # nothing to defer
            for d, fused, want in ((1, True, True), (3, False, False)):
                c = dataclasses.replace(cfg, tracker=dataclasses.replace(
                    cfg.tracker, pipeline_depth=d, fused_tracking=fused))
                t = Tracker(c, make_rig(c, device="cpu"), deferred=True)
                assert t.deferred == want and t._depth == (d if want else 1)
                assert t._track_batch is None
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
