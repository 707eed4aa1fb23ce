"""More of the port's monocular SLAM system on the CPU, at the size and on
the sequences of tests/test_mono_slam.py: the abrupt turn (no LOST) and the
host-stepped path (`fused_tracking=False`) against the fused one.  See
tests/test_torch_system.py for the configuration and the choice of seed;
`reset()` and the localization mode are in tests/test_torch_system_reset.py."""

import dataclasses

import numpy as np
import torch

from orbslam2_dualcam_tpu.utils import synthetic as ref_synthetic
from orbslam2_dualcam_tpu_torch.pipeline.system import System
from orbslam2_dualcam_tpu_torch.utils import metrics

from test_torch_system import _drive, small_cfg

torch.set_num_threads(1)


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
