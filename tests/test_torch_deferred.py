"""The port's deferred tracker (`System(deferred_tracking=True)`) on the CPU,
at the size of the system tests (one 320x240 camera, 400 features, 4
levels), on the orbit of tests/test_mono_slam.py.

(a) Side by side with the reference's deferred System at pipeline_depth 3
    on the same frames, the port's two-view RANSAC fed the reference's
    draws: the same state from every call (both lag by the same frames),
    the same frame ids in the trajectory after shutdown(), the same event
    trail, and camera centres within the system parity test's bands (5 mm
    up to frame 7, 10 cm after).
(b) Lag 1 (pipeline_depth 1) against the port's own synchronous run over
    the first 25 frames: no DROPFRAME, THIN or LOST, the trajectory
    complete after shutdown(), the ATE under the mono SLAM gate, and
    flush() idempotent.
(c) Depth 3 with async_mapping=True: no deadlock, no LOST, the trajectory
    complete after shutdown() and the mapping thread stopped.  Its ATE is
    not gated at this size: there the dispatch against a store one batch
    old, with keyframes mapped on the other thread, thins stage 1 (THIN@12,
    THIN@15 and later) in both packages, and the composed Sim3 ATE lands at
    0.41-0.56 m for the reference and 0.26-0.67 m for the port over
    RANSAC seeds 0-2 (CPU runs when this was written); chip_smoke.py's
    phase 11 gates the mode at full width.
(d) With the mapping thread, the deferred tracker's wait before it
    re-packs its store (`Tracker.mapper_sync`) returns once the mapper has
    put the handed-over keyframes' points into the map, while their local
    BA still runs, and at once when nothing is pending.

The deferred mode does not compute what the synchronous mode computes (it
dispatches against a store one batch old), so (b) and (c) hold it to the
gates, not to the synchronous run's numbers."""

import dataclasses
import threading

import numpy as np
import torch

from orbslam2_dualcam_tpu.pipeline.system import System as RefSystem
from orbslam2_dualcam_tpu.utils import config as ref_config
from orbslam2_dualcam_tpu.utils import synthetic as ref_synthetic
from orbslam2_dualcam_tpu_torch.pipeline.system import System
from orbslam2_dualcam_tpu_torch.utils import metrics
from orbslam2_dualcam_tpu_torch.utils.convert import config_from_reference

from test_torch_system import _drive, small_cfg
from test_torch_system_parity import _centre, _reference_sampler
from torch_parity import scripted_cfg

torch.set_num_threads(1)

N_FRAMES = 45
MONO_MAX_ATE_M = 0.30        # tests/test_mono_slam.py's gate


def _world_and_poses():
    world = ref_synthetic.make_box_world(np.random.default_rng(42),
                                         n_points=2500, half=6.0)
    poses = ref_synthetic.orbit_trajectory(N_FRAMES, radius=1.5,
                                           total_angle=0.8 * np.pi)
    return world, poses


def _with_depth(cfg, depth):
    return dataclasses.replace(
        cfg, tracker=dataclasses.replace(cfg.tracker, pipeline_depth=depth))


def _ate(sys_, poses):
    traj = sys_.tracker.composed_trajectory()
    est = metrics.trajectory_positions(traj)
    gt = np.asarray([_centre(poses[t[0]]) for t in traj])
    return metrics.ate_rmse(est, gt, with_scale=True)


def _check_pipeline(sys_, poses, states):
    ev = sys_.tracker.events
    for kind in ("DROPFRAME", "THIN", "LOST"):
        assert not any(e.startswith(kind) for e in ev), (kind, ev)
    fids = {t[0] for t in sys_.tracker.trajectory}
    assert len(fids) >= len(poses) - 5, (sorted(fids), ev)
    assert states[-1] == "OK", (states, ev)
    assert _ate(sys_, poses) < MONO_MAX_ATE_M


def test_deferred_tracks_the_reference_side_by_side():
    n = 21
    rcfg = _with_depth(scripted_cfg(ref_config), 3)
    world, poses = _world_and_poses()
    ref = RefSystem(rcfg, voc=None, enable_loop_closing=False,
                    deferred_tracking=True)
    port = System(config_from_reference(rcfg), voc=None,
                  enable_loop_closing=False, deferred_tracking=True,
                  device="cpu")
    port.tracker.two_view_sampler = _reference_sampler(rcfg.vocab.seed)
    assert ref.tracker.deferred and port.tracker.deferred
    assert port.tracker._depth == ref.tracker._depth == 3
    K, T_sc = np.asarray(ref.rig.K), np.asarray(ref.rig.T_sc)
    for k, T_cw in enumerate(poses[:n]):
        img = ref_synthetic.render_rig(world, K, T_sc, T_cw, H=240, W=320)
        a, b = ref.track(img, k / 30.0), port.track(img, k / 30.0)
        assert a == b, (k, a, b, ref.tracker.events, port.tracker.events)
    ref.shutdown()
    port.shutdown()
    ev_r, ev_p = ref.tracker.events, port.tracker.events
    assert [e.split(" pts=")[0] for e in ev_p] == [e.split(" pts=")[0] for e in ev_r]
    assert not any(e.startswith(("DROPFRAME", "THIN", "LOST")) for e in ev_p)
    est_r = {t[0]: t[4] for t in ref.tracker.trajectory}
    est_p = {t[0]: t[4] for t in port.tracker.trajectory}
    assert set(est_p) == set(est_r) and len(est_p) >= n - 3
    # both pipelines went through the batched dispatch and read each
    # batch back once
    for tr in (ref.tracker, port.tracker):
        assert len(tr.timer.samples["fused_dispatch"]) >= 4
    assert len(port.tracker.timer.samples["fused_get"]) == \
        len(port.tracker.timer.samples["fused_dispatch"])
    gaps = {f: float(np.linalg.norm(_centre(est_p[f]) - _centre(est_r[f])))
            for f in est_r}
    assert max(g for f, g in gaps.items() if f <= 7) < 0.005, gaps
    assert max(gaps.values()) < 0.10, gaps


def test_lag1_meets_the_gates_of_the_synchronous_run():
    world, poses = _world_and_poses()
    poses = poses[:25]
    runs = {}
    for name, deferred in (("sync", False), ("lag1", True)):
        sys_ = System(_with_depth(small_cfg(), 1), voc=None,
                      enable_loop_closing=False, deferred_tracking=deferred,
                      device="cpu")
        states = _drive(sys_, world, poses)
        sys_.shutdown()
        runs[name] = (sys_, states)
    sync, lag1 = runs["sync"][0].tracker, runs["lag1"][0].tracker
    assert not sync.deferred and lag1.deferred and lag1._depth == 1
    assert lag1._track_batch is None and lag1.timer.samples["fused_dispatch"]
    for sys_, states in runs.values():
        _check_pipeline(sys_, poses, states)
    # every frame the synchronous run recorded, the lag-1 run recorded
    assert {t[0] for t in sync.trajectory} <= {t[0] for t in lag1.trajectory}
    st1 = lag1.flush()
    n_traj = len(lag1.trajectory)
    assert lag1.flush() == st1 == runs["lag1"][1][-1]
    assert len(lag1.trajectory) == n_traj


def test_deferred_with_async_mapping():
    world, poses = _world_and_poses()
    before = threading.active_count()
    sys_ = System(small_cfg(), voc=None, enable_loop_closing=False,
                  deferred_tracking=True, async_mapping=True, device="cpu")
    assert sys_.tracker.map_lock is sys_.map_lock and sys_.tracker._depth == 3
    out = {}

    def run():
        out["states"] = _drive(sys_, world, poses, wait_for_mapper=True)
        sys_.shutdown()

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout=600)
    assert not t.is_alive(), "deadlock: the run did not finish"
    assert not sys_._mapper_thread.is_alive()
    assert threading.active_count() <= before
    ev = sys_.tracker.events
    assert not any(e.startswith("LOST") for e in ev), ev
    fids = {f for f, *_ in sys_.tracker.trajectory}
    assert len(fids) >= len(poses) - 5, (sorted(fids), ev)
    assert sys_.map.n_keyframes >= 4 and sys_.mapper.timer.samples["local_ba"]
    assert sys_.tracker.timer.samples["fused_dispatch"]


def test_deferred_tracker_waits_for_the_map_not_for_local_ba():
    sys_ = System(small_cfg(), voc=None, enable_loop_closing=False,
                  deferred_tracking=True, async_mapping=True, device="cpu")
    tr = sys_.tracker
    assert tr.mapper_sync is not None
    extended, ba_done, release = threading.Event(), threading.Event(), \
        threading.Event()

    def on_new_keyframe(kf, run_ba=True):
        # the mapper's keyframe: its points go into the map, then local BA
        # runs until the test releases it
        sys_.mapper.extended()
        extended.set()
        release.wait(30)
        ba_done.set()

    sys_.mapper.on_new_keyframe = on_new_keyframe
    tr.mapper_sync()                   # nothing handed over: no wait
    tr.local_mapper.on_new_keyframe(object())
    tr.mapper_sync()
    assert extended.is_set() and not ba_done.is_set()
    tr.local_mapper.on_new_keyframe(object())
    waiter = threading.Thread(target=tr.mapper_sync, daemon=True)
    waiter.start()
    waiter.join(0.3)
    # the second keyframe waits in the queue behind the first one's BA
    assert waiter.is_alive() and not ba_done.is_set()
    release.set()
    waiter.join(30)
    assert not waiter.is_alive() and ba_done.is_set()
    sys_.shutdown()
    assert not sys_._mapper_thread.is_alive()
