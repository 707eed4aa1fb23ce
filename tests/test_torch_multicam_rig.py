"""A 3-camera rig (front, back, side) through the port's System
(tests/test_multicam_rig.py run through orbslam2_dualcam_tpu_torch): the
rig, extraction, matching and tracking carry an ncam axis throughout."""

import numpy as np
import pytest
import torch

from orbslam2_dualcam_tpu_torch import (CameraConfig, CapacityConfig,
                                        MappingConfig, OrbConfig, SystemConfig)
from orbslam2_dualcam_tpu_torch.ops import camera
from orbslam2_dualcam_tpu_torch.pipeline.system import System
from orbslam2_dualcam_tpu_torch.utils import synthetic

pytestmark = pytest.mark.slow

torch.set_num_threads(1)


def test_three_camera_rig_tracks():
    """The reference test's rig, run and gates: 12 frames out, the last
    state OK or FULL, more than 50 features in each of the three cameras,
    at least two keyframes."""
    cam0 = CameraConfig(width=320, height=240, fx=260, fy=260, cx=160,
                        cy=120)
    cam_back = CameraConfig(width=320, height=240, fx=260, fy=260, cx=160,
                            cy=120, q_sc=(0.0, 0.0, 1.0, 0.0),
                            t_sc=(0.0, 0.0, 0.10))
    # side camera: 90 deg yaw (quaternion (x,y,z,w) about +y)
    s = np.sin(np.pi / 4)
    cam_side = CameraConfig(width=320, height=240, fx=260, fy=260, cx=160,
                            cy=120, q_sc=(0.0, float(s), 0.0, float(s)),
                            t_sc=(0.05, 0.0, 0.0))
    cfg = SystemConfig(
        cameras=(cam0, cam_back, cam_side),
        orb=OrbConfig(n_features=300, n_levels=4),
        mapping=MappingConfig(cull_found_ratio=0.1),
        capacity=CapacityConfig(max_local_mp=2048))
    rig = camera.make_rig(cfg, device="cpu")
    assert rig.K.shape[0] == 3 and rig.T_sc.shape[0] == 3

    rng = np.random.default_rng(11)
    world = synthetic.make_box_world(rng, half=6.0)
    sys_ = System(cfg, voc=None, enable_loop_closing=False, device="cpu")
    poses = synthetic.out_and_back_trajectory(n_out=12, n_turn=0, n_back=0)
    K, T_sc = rig.K.numpy(), rig.T_sc.numpy()
    states = []
    for k, T in enumerate(poses):
        imgs = synthetic.render_rig(world, K, T_sc, T, H=240, W=320)
        assert imgs.shape == (3, 240, 320)
        states.append(sys_.track(imgs, k / 30.0))
    assert states[-1] in ("OK", "FULL"), states
    f = sys_.tracker.last
    assert f.valid.shape[0] == 3
    assert all(int(f.valid[c].sum()) > 50 for c in range(3))
    assert sys_.map.n_keyframes >= 2
