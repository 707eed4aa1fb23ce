"""Capacity enforcement in the port (tests/test_capacity.py run through
orbslam2_dualcam_tpu_torch): a long run must keep the map within
CapacityConfig bounds, with keyframe eviction
(Tracker._evict_for_capacity, KFEVICT events) recycling slots."""

import numpy as np
import pytest
import torch

from orbslam2_dualcam_tpu_torch import (CameraConfig, CapacityConfig,
                                        MappingConfig, OrbConfig, SystemConfig)
from orbslam2_dualcam_tpu_torch.pipeline.system import System
from orbslam2_dualcam_tpu_torch.utils import synthetic

pytestmark = pytest.mark.slow

torch.set_num_threads(1)


def test_long_run_bounded():
    """The reference test's run and gates: 180 frames over two laps of an
    orbit against a 30-keyframe cap; the caps hold after every frame, fewer
    than 12 LOST in the first 120 frames, and eviction visible."""
    rng = np.random.default_rng(2)
    cap = CapacityConfig(max_keyframes=30, max_mappoints=4000,
                         max_local_mp=2048)
    cfg = SystemConfig(
        cameras=(CameraConfig(width=320, height=240, fx=260, fy=260,
                              cx=160, cy=120),),
        orb=OrbConfig(n_features=400, n_levels=4),
        mapping=MappingConfig(cull_found_ratio=0.1),
        capacity=cap,
    )
    world = synthetic.make_box_world(rng, half=6.0)
    sys_ = System(cfg, voc=None, enable_loop_closing=False, device="cpu")
    K, T_sc = sys_.rig.K.numpy(), sys_.rig.T_sc.numpy()
    poses = synthetic.orbit_trajectory(180, radius=1.5,
                                       total_angle=4.0 * np.pi)
    states = []
    for k, T_cw in enumerate(poses):
        imgs = synthetic.render_rig(world, K, T_sc, T_cw, H=240, W=320)
        states.append(sys_.track(imgs, k / 30.0))
        assert sys_.map.n_keyframes <= cap.max_keyframes
        assert sys_.map.n_points <= cap.max_mappoints
    n_lost_early = sum(1 for s in states[:120] if s == "LOST")
    assert n_lost_early < 12, (n_lost_early, sys_.tracker.events[:40])
    n_evict = sum(1 for e in sys_.tracker.events if e.startswith("KFEVICT"))
    assert n_evict >= 10 or sys_.map.n_keyframes < cap.max_keyframes, \
        sys_.tracker.events[-10:]
