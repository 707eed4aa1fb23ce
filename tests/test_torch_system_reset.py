"""More of the port's monocular SLAM system on the CPU, at the size and on
the sequences of tests/test_mono_slam.py: `reset()` followed by a second
run, the localization mode and a forced LOST with the no-vocabulary
relocalization.  See tests/test_torch_system.py for the configuration and
the choice of seed."""

import numpy as np
import torch

from orbslam2_dualcam_tpu.utils import synthetic as ref_synthetic
from orbslam2_dualcam_tpu_torch.pipeline.system import System

from test_torch_system import _drive, small_cfg

torch.set_num_threads(1)


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
