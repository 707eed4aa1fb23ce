"""The port's System side by side with the reference's on the orbit of
tests/test_mono_slam.py (one 320x240 camera, 400 features, 4 levels), frame
by frame on the same images, the port's two-view RANSAC fed the minimal
sets the reference draws (`Tracker.two_view_sampler`).

What is held: INIT at the same frame with the same number of map points
(within 5%), the same event trail (keyframe insertions, frame by frame),
and camera centres within 5 mm over the first 5 tracked frames and within
10 cm after (the path is 3.7 m long; the ATE gate of the system tests is
30 cm).  Measured when this was written: the
event trails are equal over all 45 frames; the centres agree to 3.3 mm up
to frame 7, then wander apart and together again within 0.5-4.5 cm, from
the first local-BA results that differ (ROADMAP.md, Queue 3).  The gap
depends on the number of torch threads (the order of its sums)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam2_dualcam_tpu.ops import ransac as ref_ransac
from orbslam2_dualcam_tpu.pipeline.system import System as RefSystem
from orbslam2_dualcam_tpu.utils import config as ref_config
from orbslam2_dualcam_tpu.utils import synthetic as ref_synthetic
from orbslam2_dualcam_tpu_torch.pipeline.system import System
from orbslam2_dualcam_tpu_torch.utils.convert import config_from_reference

from torch_parity import scripted_cfg

torch.set_num_threads(1)


def _reference_sampler(seed: int):
    """A `two_view_sampler` that draws what the reference's Tracker draws:
    its key chain (`_next_key`, then the split inside two_view_init) and
    its `_sample_indices`."""
    key = [jax.random.PRNGKey(seed)]

    def sampler(n_hyp, valid):
        key[0], k = jax.random.split(key[0])
        kh, kf2 = jax.random.split(k)
        n = valid.shape[0]
        w = jnp.ones(n, jnp.float32)
        idx = [np.asarray(ref_ransac._sample_indices(kk, n_hyp, m, n, w))
               for kk, m in ((kh, 4), (kf2, 8))]
        return tuple(torch.as_tensor(i.astype(np.int64)) for i in idx)

    return sampler


def _centre(T):
    return -T[:3, :3].T @ T[:3, 3]


def _side_by_side(n_frames):
    rcfg = scripted_cfg(ref_config)
    world = ref_synthetic.make_box_world(np.random.default_rng(42),
                                         n_points=2500, half=6.0)
    ref = RefSystem(rcfg, voc=None, enable_loop_closing=False)
    port = System(config_from_reference(rcfg), voc=None,
                  enable_loop_closing=False, device="cpu")
    port.tracker.two_view_sampler = _reference_sampler(rcfg.vocab.seed)
    poses = ref_synthetic.orbit_trajectory(45, radius=1.5,
                                           total_angle=0.8 * np.pi)[:n_frames]
    K, T_sc = np.asarray(ref.rig.K), np.asarray(ref.rig.T_sc)
    gaps = []
    for k, T_cw in enumerate(poses):
        img = ref_synthetic.render_rig(world, K, T_sc, T_cw, H=240, W=320)
        a, b = ref.track(img, k / 30.0), port.track(img, k / 30.0)
        assert a == b, (k, a, b, ref.tracker.events, port.tracker.events)
        fa, fb = ref.tracker.last, port.tracker.last
        if fa.T_cw is not None:
            gaps.append((k, float(np.linalg.norm(_centre(fa.T_cw) - _centre(fb.T_cw)))))
    return ref, port, gaps


def _check(ref, port, gaps, n_frames):
    ev_r, ev_p = ref.tracker.events, port.tracker.events
    assert ev_r[0].split()[0] == ev_p[0].split()[0] == "INIT@2"
    n_r, n_p = (int(e[0].split("pts=")[1]) for e in (ev_r, ev_p))
    assert abs(n_r - n_p) <= 0.05 * n_r
    # the keyframe trail: the same insertions at the same frames
    assert [e.split(" pts=")[0] for e in ev_p] == [e.split(" pts=")[0] for e in ev_r]
    assert len(gaps) == n_frames - 2
    assert max(g for k, g in gaps if k <= 7) < 0.005, gaps
    assert max(g for _, g in gaps) < 0.10, gaps
    assert port.map.n_keyframes == ref.map.n_keyframes
    assert abs(port.map.n_points - ref.map.n_points) <= 0.1 * ref.map.n_points
    # local mapping did the same work up to the first window that differs
    assert port.mapper.kf_log[:3] == ref.mapper.kf_log[:3]
    for (gk, g_nkf, *_), (wk, w_nkf, *_) in zip(port.mapper.ba_log[:6],
                                                ref.mapper.ba_log[:6]):
        assert (gk, g_nkf) == (wk, w_nkf)


def test_system_tracks_the_reference_for_20_frames():
    ref, port, gaps = _side_by_side(20)
    _check(ref, port, gaps, 20)


@pytest.mark.slow
def test_system_tracks_the_reference_for_45_frames():
    ref, port, gaps = _side_by_side(45)
    _check(ref, port, gaps, 45)
