"""Geometry core and the motion-only pose optimizer against the JAX
reference."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam2_dualcam_tpu.ops import camera as jcam
from orbslam2_dualcam_tpu.ops import lie as jlie
from orbslam2_dualcam_tpu.optim import pose_opt as jpo
from orbslam2_dualcam_tpu.utils.config import (BAConfig, CameraConfig,
                                               SystemConfig)
from orbslam2_dualcam_tpu_torch.ops import camera as tcam
from orbslam2_dualcam_tpu_torch.ops import lie as tlie
from orbslam2_dualcam_tpu_torch.optim import pose_opt as tpo

from torch_parity import t

torch.set_num_threads(1)

# a dual rig with lens distortion on the back camera, so the undistortion
# fixed point and the undistorted bounds are exercised
CFG = SystemConfig(cameras=(
    CameraConfig(),
    CameraConfig(q_sc=(0.0, 0.0, 1.0, 0.0), t_sc=(0.05, 0.0, 0.10),
                 dist=(-0.12, 0.03, 1e-3, -5e-4, 0.0))))


def test_make_rig_matches_reference():
    """All leaves to 1e-5 (bounds are pixels: 1e-3)."""
    jr, tr = jcam.make_rig(CFG), tcam.make_rig(CFG, "cpu")
    for name in tr._fields:
        atol = 1e-3 if name == "bounds" else 1e-5
        np.testing.assert_allclose(getattr(tr, name).numpy(),
                                   np.asarray(getattr(jr, name)), rtol=0,
                                   atol=atol, err_msg=name)


def test_lie_and_projection_match_reference():
    """se3_exp, se3_adjoint, project_rig and undistort_pixels to 1e-5.
    Pixels are compared in normalized image coordinates ((u - cx) / fx):
    near the principal point u = fx x / z + cx cancels, so the f32 rounding
    of the ~300 px terms (ulp 3e-5 px) is the floor of a pixel-unit check."""
    rng = np.random.default_rng(3)
    for xi in rng.normal(0, 0.5, (6, 6)).astype(np.float32):
        T = tlie.se3_exp(t(xi))
        np.testing.assert_allclose(T.numpy(), np.asarray(jlie.se3_exp(jnp.asarray(xi))),
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(tlie.se3_adjoint(T).numpy(),
                                   np.asarray(jlie.se3_adjoint(jnp.asarray(T.numpy()))),
                                   rtol=0, atol=1e-5)
    jr, tr = jcam.make_rig(CFG), tcam.make_rig(CFG, "cpu")
    X = rng.uniform(-3, 3, (64, 3)).astype(np.float32)
    X[:, 2] = np.where(rng.uniform(size=64) > 0.5, 1, -1) * rng.uniform(2, 8, 64)
    cam = (X[:, 2] < 0).astype(np.int64)
    T = rng.normal(0, 0.1, 6).astype(np.float32)
    Tj = jlie.se3_exp(jnp.asarray(T))
    uv_j, z_j = jcam.project_rig(jr, jnp.asarray(cam), Tj, jnp.asarray(X))
    uv_t, z_t = tcam.project_rig(tr, t(cam), t(np.asarray(Tj)), t(X))
    K = np.asarray(jr.K, np.float64)[cam]

    def norm(p, K=K):
        return (p - K[..., :2, 2]) / np.stack([K[..., 0, 0], K[..., 1, 1]], -1)

    np.testing.assert_allclose(norm(uv_t.numpy()), norm(np.asarray(uv_j)),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(z_t.numpy(), np.asarray(z_j), rtol=0, atol=1e-5)
    uv = rng.uniform([0, 0], [640, 480], (64, 2)).astype(np.float32)
    und_j = jcam.undistort_pixels(jnp.asarray(uv), jr.K[1], jr.K_inv[1], jr.dist[1])
    und_t = tcam.undistort_pixels(t(uv), tr.K[1], tr.K_inv[1], tr.dist[1])
    np.testing.assert_allclose(norm(und_t.numpy(), K[1]), norm(np.asarray(und_j), K[1]),
                               rtol=0, atol=1e-5)


def _pose_problem(n=150, outliers=30, seed=4):
    """The reference suite's dual-rig pose fixture (tests/test_optim.py)
    with outliers, per-level weights and some masked edges."""
    rng = np.random.default_rng(seed)
    jr = jcam.make_rig(CFG)
    X = rng.uniform([-2, -2, 4], [2, 2, 10], size=(n, 3)).astype(np.float32)
    cam = rng.integers(0, 2, size=n).astype(np.int32)
    X[cam == 1, 2] *= -1
    T_true = jlie.se3_exp(jnp.asarray([0.1, -0.05, 0.02, 0.03, -0.02, 0.01],
                                      jnp.float32))
    uv, _ = jcam.project_rig(jr, jnp.asarray(cam), T_true, jnp.asarray(X))
    uv = np.array(uv) + rng.normal(0, 0.5, (n, 2)).astype(np.float32)
    idx = rng.choice(n, size=outliers, replace=False)
    uv[idx] += (rng.uniform(30, 80, size=(outliers, 2)) *
                rng.choice([-1, 1], size=(outliers, 2)))
    inv_sigma2 = (1.0 / 1.2 ** (2 * rng.integers(0, 4, n))).astype(np.float32)
    valid = rng.uniform(size=n) > 0.05
    T0 = np.asarray(jlie.se3_exp(jnp.asarray([0.03, -0.03, 0.03, 0.01, 0.01, 0.01],
                                             jnp.float32)) @ T_true)
    return jr, T_true, T0, X, uv.astype(np.float32), cam, inv_sigma2, valid


@pytest.mark.parametrize("ba", [BAConfig(), BAConfig(pose_rounds=2, pose_iters=3)])
def test_optimize_pose_matches_reference(ba):
    """Pose to 1e-4 and the inlier mask exactly: the same deferred-
    acceptance LM on the same edges; only float summation order differs."""
    jr, T_true, T0, X, uv, cam, isg, valid = _pose_problem()
    Tj, inl_j, n_j = jpo.optimize_pose(
        jnp.asarray(T0), jnp.asarray(X), jnp.asarray(uv), jnp.asarray(cam),
        jnp.asarray(isg), jnp.asarray(valid), jr.T_sc, jr.adj_sc, jr.K, cfg=ba)
    tr = tcam.make_rig(CFG, "cpu")
    Tt, inl_t, n_t = tpo.optimize_pose(
        t(T0), t(X), t(uv), t(cam).long(), t(isg), t(valid), tr.T_sc,
        tr.adj_sc, tr.K, cfg=ba)
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(inl_t.numpy(), np.asarray(inl_j))
    assert int(n_t) == int(n_j) and 100 <= int(n_t) <= 125


def test_chol_solve6_matches_numpy():
    rng = np.random.default_rng(6)
    A = rng.normal(size=(6, 6))
    H = (A @ A.T + 6 * np.eye(6)).astype(np.float32)
    b = rng.normal(size=6).astype(np.float32)
    np.testing.assert_allclose(tpo.chol_solve6(t(H), t(b)).numpy(),
                               np.linalg.solve(H.astype(np.float64), b),
                               rtol=1e-4, atol=1e-5)
