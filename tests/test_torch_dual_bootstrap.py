"""The port's dual-camera bootstrap on the CPU, alone: the fixture of
tests/test_dual_wide_baseline.py (two back-to-back 320x240 cameras 0.50 m
apart, 400 features, 4 levels, a vocabulary trained on the scene's own
descriptors, world seed 3, vocabulary seed 9, RANSAC seed
cfg.vocab.seed = 42) driven through the port's `System(cfg, voc,
enable_loop_closing=False, device="cpu")`, and held to the integration
gates of tests/test_dual_slam.py: mono init on the front camera ->
cross-camera relocalization by the back camera -> metric re-scaling by the
known baseline -> second map -> FULL.

The short run stops a few frames into the way back, after `SCALED@` and
`FULL@` have landed; the whole 82-frame out-and-back run is kept beside it,
marked slow.  Nothing of the JAX package runs here: images, features and
the vocabulary are the port's own.
"""

import numpy as np
import pytest
import torch

from orbslam2_dualcam_tpu_torch.ops import orb
from orbslam2_dualcam_tpu_torch.pipeline.system import System
from orbslam2_dualcam_tpu_torch.utils import metrics, synthetic
from orbslam2_dualcam_tpu_torch.utils.config import (CameraConfig,
                                                     CapacityConfig,
                                                     MappingConfig, OrbConfig,
                                                     SystemConfig,
                                                     TrackerConfig,
                                                     VocabConfig)
from orbslam2_dualcam_tpu_torch.vocab import bow

N_SHORT = 64     # frames of the tier-1 run (of 82)


def wide_cfg():
    cam0 = CameraConfig(width=320, height=240, fx=260, fy=260, cx=160,
                        cy=120)
    cam1 = CameraConfig(width=320, height=240, fx=260, fy=260, cx=160,
                        cy=120, q_sc=(0.0, 0.0, 1.0, 0.0),
                        t_sc=(0.0, 0.0, 0.50))
    return SystemConfig(
        cameras=(cam0, cam1),
        orb=OrbConfig(n_features=400, n_levels=4),
        mapping=MappingConfig(cull_found_ratio=0.1),
        vocab=VocabConfig(branching=8, depth=3),
        tracker=TrackerConfig(reloc_gap_try=4, reloc_gap_fail=4,
                              num_frame_in_secondmap=3),
        capacity=CapacityConfig(max_local_mp=2048),
    )


def run_wide(n_frames: int):
    torch.set_num_threads(1)
    cfg = wide_cfg()
    world = synthetic.make_box_world(np.random.default_rng(3), half=6.0)
    K = np.array([[260.0, 0, 160], [0, 260, 120], [0, 0, 1]])
    descs = []
    for T in synthetic.orbit_trajectory(10, radius=1.0):
        img = synthetic.render(world, K, T, H=240, W=320)
        f = orb.extract_orb(torch.as_tensor(img), cfg.orb, 400)
        descs.append(f.desc.numpy().view(np.uint32)[f.valid.numpy()])
    voc = bow.train_vocabulary(np.concatenate(descs), branching=8, depth=3,
                               seed=9, weight_docs=descs, device="cpu")
    sys_ = System(cfg, voc=voc, enable_loop_closing=False, device="cpu")
    poses = synthetic.out_and_back_trajectory(n_out=26, n_turn=30, n_back=26)
    Ks, T_sc = sys_.rig.K.numpy(), sys_.rig.T_sc.numpy()
    states = []
    for k, T_cw in enumerate(poses[:n_frames]):
        imgs = synthetic.render_rig(world, Ks, T_sc, T_cw, H=240, W=320)
        states.append(sys_.track(imgs, k / 30.0))
    sys_.shutdown()
    return sys_, poses, states


def kf_positions(sys_, poses):
    est, gt = [], []
    for kid in sorted(sys_.map.keyframes):
        kf = sys_.map.keyframes[kid]
        est.append(kf.center())
        Tg = poses[kf.frame_id]
        gt.append(-Tg[:3, :3].T @ Tg[:3, 3])
    return np.asarray(est), np.asarray(gt)


@pytest.fixture(scope="module")
def short_run():
    return run_wide(N_SHORT)


def test_tracks_through_turn(short_run):
    sys_, poses, states = short_run
    n_lost = sum(1 for s in states if s == "LOST")
    assert states[-1] in ("OK", "FULL"), (states[-20:], sys_.tracker.events)
    assert n_lost <= 5, sys_.tracker.events


def test_cross_camera_reloc_and_scaling(short_run):
    sys_, poses, states = short_run
    ev = sys_.tracker.events
    assert any(e.startswith("XRELOC@") for e in ev), ev
    assert any(e.startswith("XANCHOR@") for e in ev), ev
    assert any(e.startswith("SCALED@") for e in ev), ev
    assert any(e.startswith("FULL@") for e in ev), ev
    assert sys_.map.map_scaled
    assert sys_.map.first_scale_kid >= 0
    assert "FULL" in states
    # every keyframe is in the database, per camera
    assert set(sys_.kfdb.bow[0]) == set(sys_.map.keyframes)
    assert {"xreloc", "second_map", "refine_scale", "metric_gba"} <= \
        set(sys_.tracker.timer.samples)


def test_scale_and_shape_at_the_integration_floor(short_run):
    """tests/test_dual_slam.py::test_metric_scale_recovered's bands: the
    Umeyama scale in (0.2, 4.0) and the Sim3-aligned ATE under 10% of the
    trajectory's span."""
    sys_, poses, states = short_run
    est, gt = kf_positions(sys_, poses)
    _, _, s = metrics.align_umeyama(est, gt, with_scale=True)
    assert 0.2 < s < 4.0, (s, sys_.tracker.events)
    ate_sim3 = metrics.ate_rmse(est, gt, with_scale=True)
    span = np.linalg.norm(gt.max(0) - gt.min(0))
    assert ate_sim3 < 0.10 * span, (ate_sim3, span, sys_.tracker.events)


def test_second_camera_contributes(short_run):
    sys_, poses, states = short_run
    n_cam1 = sum(1 for mp in sys_.map.points.values()
                 if any(c == 1 for c in mp.obs_cam.values()))
    assert n_cam1 > 20, (n_cam1, sys_.tracker.events)
    assert sys_.tracker._count_cross_edges() > 0


@pytest.mark.slow
def test_whole_out_and_back_run():
    """All 82 frames, with the bands of tests/test_dual_wide_baseline.py
    reported by the assertion messages and the integration gates held."""
    sys_, poses, states = run_wide(82)
    ev = sys_.tracker.events
    assert states[-1] in ("OK", "FULL"), (states[-20:], ev)
    assert sum(1 for s in states if s == "LOST") <= 5, ev
    assert sys_.map.map_scaled and any(e.startswith("FULL@") for e in ev), ev
    est, gt = kf_positions(sys_, poses)
    _, _, s = metrics.align_umeyama(est, gt, with_scale=True)
    assert 0.2 < s < 4.0, (s, ev)
    span = np.linalg.norm(gt.max(0) - gt.min(0))
    assert metrics.ate_rmse(est, gt, with_scale=True) < 0.10 * span, ev
