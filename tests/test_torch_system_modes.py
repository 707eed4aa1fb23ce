"""More of the port's monocular SLAM system on the CPU, at the size and on
the sequences of tests/test_mono_slam.py: the abrupt turn (no LOST), the
host-stepped path (`fused_tracking=False`) against the fused one, `reset()`
followed by a second run, the localization mode and a forced LOST with the
no-vocabulary relocalization.  See tests/test_torch_system.py for the
configuration and the choice of seed."""

import dataclasses

import numpy as np

from orbslam2_dualcam_tpu.utils import synthetic as ref_synthetic
from orbslam2_dualcam_tpu_torch.pipeline.system import System
from orbslam2_dualcam_tpu_torch.utils import metrics

from test_torch_system import _drive, small_cfg


def test_host_stepped_path_tracks_the_orbit():
    """fused_tracking=False: every frame through the host-stepped cascade;
    its camera centres stay within 5 cm of the fused run's over 14 frames
    (the two paths run the same stages; the fused one always computes the
    wide stage and selects)."""
    world = ref_synthetic.make_box_world(np.random.default_rng(42),
                                         n_points=2500, half=6.0)
    poses = ref_synthetic.orbit_trajectory(45, radius=1.5,
                                           total_angle=0.8 * np.pi)[:14]
    runs = []
    for fused in (False, True):
        cfg = small_cfg()
        cfg = dataclasses.replace(cfg, tracker=dataclasses.replace(
            cfg.tracker, fused_tracking=fused))
        sys_ = System(cfg, voc=None, enable_loop_closing=False, device="cpu")
        states = _drive(sys_, world, poses)
        assert states[-1] == "OK" and "LOST" not in states, sys_.tracker.events
        runs.append(sys_)
    stepped, fused = runs
    assert stepped.tracker.n_fused_frames == 0 and fused.tracker.n_stepped_frames == 0
    assert stepped.tracker.n_stepped_frames >= 10
    # a healthy host-stepped frame makes 2 match + pose stages
    assert stepped.tracker.n_pose_opt_calls >= 2 * stepped.tracker.n_stepped_frames
    a = metrics.trajectory_positions(stepped.tracker.composed_trajectory())
    b = metrics.trajectory_positions(fused.tracker.composed_trajectory())
    assert a.shape == b.shape and np.abs(a - b).max() < 0.05


def test_abrupt_turn_recovery():
    """The 9 deg/frame turn of tests/test_mono_slam.py: the optical flow
    exceeds the motion-model window and its widened retry, so tracking
    survives only through the windowless reference-keyframe fallback of the
    host-stepped cascade."""
    world = ref_synthetic.make_box_world(np.random.default_rng(3),
                                         n_points=2500, half=6.0)
    sys_ = System(small_cfg(), voc=None, enable_loop_closing=False, device="cpu")
    poses = ref_synthetic.out_and_back_trajectory(n_out=12, n_turn=20, n_back=8,
                                                  turn_radius=1.0)
    states = _drive(sys_, world, poses)
    assert sum(1 for s in states if s == "LOST") == 0, (states, sys_.tracker.events)
    assert states[-1] == "OK", (states, sys_.tracker.events)
    assert sys_.tracker.n_stepped_frames >= 1       # the fused step declined


def _rebased(events, fid0):
    out = []
    for e in events:
        kind, rest = e.split("@", 1)
        fid, *tail = rest.split(" ")
        out.append(" ".join([f"{kind}@{int(fid) - fid0}"] + tail))
    return out


def test_reset_then_second_run_equals_a_fresh_system():
    """reset() clears the map and the tracker's run state; a second run in
    the same process gives the events of a fresh System (frame ids go on
    counting, so they are compared relative to the run's first frame)."""
    world = ref_synthetic.make_box_world(np.random.default_rng(42),
                                         n_points=2500, half=6.0)
    poses = ref_synthetic.orbit_trajectory(45, radius=1.5,
                                           total_angle=0.8 * np.pi)[:10]
    sys_ = System(small_cfg(), voc=None, enable_loop_closing=False, device="cpu")
    first = _drive(sys_, world, poses)
    ev_first = list(sys_.tracker.events)
    n_kf, n_pts = sys_.map.n_keyframes, sys_.map.n_points
    assert n_kf >= 3 and first[-1] == "OK"
    sys_.reset()
    assert sys_.map.n_keyframes == 0 and sys_.map.n_points == 0
    assert sys_.tracker.state == "NOT_INITIALIZED" and not sys_.tracker.trajectory
    assert sys_.tracker.last is None and sys_.tracker._store is None
    sys_.tracker.events.clear()
    # the generator's stream goes on across a reset, as the reference's key
    # does; reseeded so that both runs draw the same minimal sets
    sys_.tracker.gen.manual_seed(int(sys_.cfg.vocab.seed))
    second = _drive(sys_, world, poses)
    assert second == first
    assert _rebased(sys_.tracker.events, len(poses)) == _rebased(ev_first, 0)
    assert (sys_.map.n_keyframes, sys_.map.n_points) == (n_kf, n_pts)
    assert min(sys_.map.keyframes) == 0            # ids restart


def test_localization_mode_and_forced_lost():
    world = ref_synthetic.make_box_world(np.random.default_rng(42),
                                         n_points=2500, half=6.0)
    poses = ref_synthetic.orbit_trajectory(45, radius=1.5,
                                           total_angle=0.8 * np.pi)[:12]
    sys_ = System(small_cfg(), voc=None, enable_loop_closing=False, device="cpu")
    _drive(sys_, world, poses[:8])
    n_kf = sys_.map.n_keyframes
    sys_.activate_localization_mode()
    assert _drive(sys_, world, poses[8:10]) == ["OK", "OK"]
    assert sys_.map.n_keyframes == n_kf            # no keyframe inserted
    sys_.deactivate_localization_mode()
    sys_.set_compulsory_lost()
    K, T_sc = sys_.rig.K.numpy(), sys_.rig.T_sc.numpy()
    img = ref_synthetic.render_rig(world, K, T_sc, poses[10], H=240, W=320)
    state = sys_.track(img, 10 / 30.0)
    ev = sys_.tracker.events
    assert any(e.startswith("FORCED_LOST@") for e in ev)
    # the no-vocabulary relocalization brings it back in the same call
    assert state == "OK" and any(e.startswith("RELOC@") for e in ev), ev


