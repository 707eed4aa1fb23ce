"""The metric-scale solvers of the port against the reference on equal
numpy inputs: `bootstrap_scale` (numpy, float64: equal to 1e-12),
`optimal_map_scale` on a scripted map with cross-camera edges (alpha within
1e-4, the cost curve within 1e-3 relative), `apply_map_scale` (exact)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam2_dualcam_tpu.models import map as ref_map
from orbslam2_dualcam_tpu.ops import camera as ref_camera
from orbslam2_dualcam_tpu.optim import scale_opt as ref_scale_opt
from orbslam2_dualcam_tpu.utils import config as ref_config
from orbslam2_dualcam_tpu_torch.models import map as port_map
from orbslam2_dualcam_tpu_torch.ops import camera
from orbslam2_dualcam_tpu_torch.optim import scale_opt
from orbslam2_dualcam_tpu_torch.utils.convert import config_from_reference

from torch_parity import (assert_snapshots_equal, map_snapshot, scripted_cfg,
                          scripted_map, small_K, t)

TRUE_ALPHA = 1.7


def dual_cfg():
    """The scripted mono configuration with a second camera 0.5 to the
    right, looking the same way (so that the scripted cloud is in front of
    both)."""
    cfg = scripted_cfg(ref_config)
    cam1 = dataclasses.replace(cfg.cameras[0], t_sc=(-0.5, 0.0, 0.0))
    return dataclasses.replace(cfg, cameras=(cfg.cameras[0], cam1))


def cross_edge_map(map_mod, T_sc1: np.ndarray, seed: int = 0):
    """`scripted_map` grown to two cameras' rows per keyframe, with a
    camera-1 observation (0.5 px noise) for every map point in every
    keyframe that does not observe it yet, then shrunk by 1/TRUE_ALPHA: the
    cross edges are strained exactly by that factor."""
    m, kf_new, sf = scripted_map(map_mod, seed=seed)
    rng = np.random.default_rng(seed + 100)
    K = small_K()
    n = 400
    for kf in m.keyframes.values():
        kf.uv = np.concatenate([kf.uv, np.zeros((n, 2))])
        kf.kp_cam = np.concatenate([kf.kp_cam, np.ones(n, np.int64)])
        kf.level = np.concatenate([kf.level, np.zeros(n, np.int32)])
        kf.angle = np.concatenate([kf.angle, np.zeros(n, np.float32)])
        kf.desc = np.concatenate([kf.desc, np.zeros((n, 8), np.uint32)])
        kf.kp_valid = np.concatenate([kf.kp_valid, np.zeros(n, bool)])
        kf.mp_idx = np.concatenate([kf.mp_idx, np.full(n, -1, np.int64)])
        kf.word = np.concatenate([kf.word, np.full(n, -1, np.int64)])
        kf.node = np.concatenate([kf.node, np.full(n, -1, np.int64)])
    free = {kid: n for kid in m.keyframes}
    for mid in sorted(m.points):
        mp = m.points[mid]
        for kid, kf in m.keyframes.items():
            if kid in mp.obs or free[kid] >= 2 * n:
                continue
            x = (T_sc1 @ kf.T_cw @ np.append(mp.pos, 1.0))[:3]
            uv = x[:2] / x[2] * [K[0, 0], K[1, 1]] + [K[0, 2], K[1, 2]]
            if not (0 < uv[0] < 320 and 0 < uv[1] < 240):
                continue
            g = free[kid]
            free[kid] += 1
            kf.uv[g] = uv + rng.normal(0, 0.5, 2)
            kf.level[g] = rng.integers(0, 3)
            kf.kp_valid[g] = True
            m.add_observation(mp, kf, g, 1)
    map_mod_scale = 1.0 / TRUE_ALPHA
    for kf in m.keyframes.values():
        kf.T_cw = kf.T_cw.copy()
        kf.T_cw[:3, 3] *= map_mod_scale
    for mp in m.points.values():
        mp.pos = mp.pos * map_mod_scale
    return m, sf


@pytest.fixture(scope="module")
def setup():
    torch.set_num_threads(1)
    rcfg = dual_cfg()
    rrig = ref_camera.make_rig(rcfg)
    rig = camera.make_rig(config_from_reference(rcfg), device="cpu")
    T_sc1 = np.asarray(rrig.T_sc)[1].astype(np.float64)
    rm, sf = cross_edge_map(ref_map, T_sc1)
    pm, _ = cross_edge_map(port_map, T_sc1)
    assert_snapshots_equal(map_snapshot(rm), map_snapshot(pm))
    return rrig, rig, rm, pm, sf


def test_optimal_map_scale_equals_reference(setup):
    """alpha within 1e-4 of the reference's, the edge counts equal, and
    both find the strain the map was given (within 2%)."""
    rrig, rig, rm, pm, sf = setup
    for kw in (dict(), dict(alpha_lo=0.15, alpha_hi=8.0, n_grid=129)):
        want = ref_scale_opt.optimal_map_scale(rm, rrig, sf ** 2, **kw)
        got = scale_opt.optimal_map_scale(pm, rig, sf ** 2, **kw)
        assert got[1] == want[1] > 300, want
        assert got[0] == pytest.approx(want[0], abs=1e-4)
        assert got[0] == pytest.approx(TRUE_ALPHA, rel=0.02)
    assert scale_opt.optimal_map_scale(pm, rig, sf ** 2, min_edges=10 ** 6) is None
    assert ref_scale_opt.optimal_map_scale(rm, rrig, sf ** 2,
                                           min_edges=10 ** 6) is None


def test_scale_cost_curve_equals_reference():
    """The [A, E] cost curve on random edges, some behind the camera, some
    invalid: within 1e-3 relative at every alpha; and it does not depend on
    padding (the reference pads E to a x4 bucket, the port does not)."""
    rng = np.random.default_rng(2)
    E, A = 700, 129
    a = rng.normal(0, 1, (E, 3)).astype(np.float32)
    a[:, 2] = rng.uniform(2, 8, E)
    a[::50, 2] = -1.0
    b = np.tile(np.float32([0.5, 0.0, 0.0]), (E, 1))
    fxy = np.full((E, 2), 260.0, np.float32)
    cxy = np.tile(np.float32([160.0, 120.0]), (E, 1))
    uv = (a[:, :2] * 1.3 + b[:, :2]) / (a[:, 2:] * 1.3) * fxy + cxy
    uv = (uv + rng.normal(0, 1.0, (E, 2))).astype(np.float32)
    is2 = rng.choice([1.0, 0.694, 0.482], E).astype(np.float32)
    valid = rng.random(E) < 0.9
    alphas = np.geomspace(0.15, 8.0, A).astype(np.float32)
    want = np.asarray(ref_scale_opt._scale_cost_curve(
        *(jnp.asarray(x) for x in (a, b, uv, fxy, cxy, is2, valid, alphas)),
        jnp.float32(5.991)))
    got = scale_opt._scale_cost_curve(
        *(t(x) for x in (a, b, uv, fxy, cxy, is2, valid, alphas)), 5.991)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3)
    assert int(np.argmin(want)) == int(got.argmin())
    pad = lambda x: np.concatenate([x, np.zeros((324,) + x.shape[1:], x.dtype)])
    padded = scale_opt._scale_cost_curve(
        *(t(pad(x)) for x in (a, b, uv, fxy, cxy, is2, valid)), t(alphas), 5.991)
    np.testing.assert_allclose(padded.numpy(), got.numpy(), rtol=1e-5)


@pytest.mark.parametrize("n_anchors,noise", [(2, 0.0), (3, 0.002), (6, 0.004),
                                             (1, 0.0)])
def test_bootstrap_scale_equals_reference(n_anchors, noise):
    """numpy float64 on both sides: equal to 1e-12."""
    rng = np.random.default_rng(n_anchors)
    T_sc1 = np.eye(4)
    T_sc1[:3, :3] = np.diag([-1.0, 1.0, -1.0])
    T_sc1[:3, 3] = [0.0, 0.0, 0.5]
    alpha = 4.2
    anchors = []
    for i in range(n_anchors):
        yaw = 0.5 * i
        R = np.array([[np.cos(yaw), 0, np.sin(yaw)], [0, 1, 0],
                      [-np.sin(yaw), 0, np.cos(yaw)]])
        Tt = np.eye(4)
        Tt[:3, :3] = R
        Tt[:3, 3] = rng.normal(0, 0.3, 3)
        # camera 1 of a rig whose baseline is 1/alpha in map units
        T_small = T_sc1.copy()
        T_small[:3, 3] /= alpha
        T1 = T_small @ Tt
        T1[:3, 3] += rng.normal(0, noise, 3)
        anchors.append(dict(T1w=T1, T_track=Tt, frame_id=40 + 4 * i))
    want = ref_scale_opt.bootstrap_scale(anchors, T_sc1)
    got = scale_opt.bootstrap_scale(anchors, T_sc1)
    if n_anchors < 2:
        assert want is None and got is None
        return
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    assert got[2] == n_anchors * (n_anchors - 1) // 2
    if noise == 0.0:
        assert got[0] == pytest.approx(alpha, rel=1e-9)


def test_apply_map_scale_equals_reference(setup):
    rrig, rig, _, _, _ = setup
    T_sc1 = np.asarray(rrig.T_sc)[1].astype(np.float64)
    rm, _ = cross_edge_map(ref_map, T_sc1, seed=1)
    pm, _ = cross_edge_map(port_map, T_sc1, seed=1)
    ref_scale_opt.apply_map_scale(rm, 1.37)
    scale_opt.apply_map_scale(pm, 1.37)
    assert_snapshots_equal(map_snapshot(rm), map_snapshot(pm))
    assert not pm.map_scaled
