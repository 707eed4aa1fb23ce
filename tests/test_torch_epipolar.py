"""ops/epipolar.py of the port against the JAX reference on the same seeded
inputs (CPU, float32).  Tolerance 1e-5, relative to the magnitude of each
quantity (F entries are ~1e-6, points are metres)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam2_dualcam_tpu.ops import epipolar as ref_epi
from orbslam2_dualcam_tpu_torch.ops import epipolar as epi
from orbslam2_dualcam_tpu_torch.utils import synthetic

from torch_parity import small_K, t

torch.set_num_threads(1)

TOL = 1e-5


def _scene(seed, n=300):
    """Two poses a short baseline apart, n points in front of both, and
    their exact projections."""
    rng = np.random.default_rng(seed)
    K = small_K().astype(np.float32)
    T1 = np.eye(4, dtype=np.float32)
    T2 = np.eye(4, dtype=np.float32)
    T2[:3, :3] = synthetic.so3_exp(rng.normal(0, 0.05, 3))
    T2[:3, 3] = rng.normal(0, 0.3, 3)
    X = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                  rng.uniform(3, 8, n)], 1).astype(np.float32)

    def proj(T):
        x = X @ T[:3, :3].T + T[:3, 3]
        return (x[:, :2] / x[:, 2:]) * [K[0, 0], K[1, 1]] + [K[0, 2], K[1, 2]]

    return K, T1, T2, X, proj(T1).astype(np.float32), proj(T2).astype(np.float32)


def _close(a, b, tol=TOL):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = max(np.abs(b).max(), 1e-30)
    assert np.abs(a - b).max() <= tol * scale, np.abs(a - b).max() / scale


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_triangulate_dlt(seed):
    K, T1, T2, X, uv1, uv2 = _scene(seed)
    rng = np.random.default_rng(seed + 10)
    uv2n = uv2 + rng.normal(0, 0.5, uv2.shape).astype(np.float32)
    P1, P2 = K @ T1[:3], K @ T2[:3]
    want = ref_epi.triangulate_dlt(jnp.asarray(P1), jnp.asarray(P2),
                                   jnp.asarray(uv1), jnp.asarray(uv2n))
    got = epi.triangulate_dlt(t(P1), t(P2), t(uv1), t(uv2n))
    # a DLT point is the null vector of a float32 4x4 system: two SVD
    # implementations agree to ~1e-4 of the depth on noisy pixels
    _close(got, want, 2e-4)
    # and on exact pixels both recover the scene
    exact = epi.triangulate_dlt(t(P1), t(P2), t(uv1), t(uv2))
    assert np.abs(exact.numpy() - X).max() < 2e-2


@pytest.mark.parametrize("seed", [0, 1])
def test_fundamental_projection_and_distance(seed):
    K, T1, T2, X, uv1, uv2 = _scene(seed)
    want_P = ref_epi.projection_matrix(jnp.asarray(K), jnp.asarray(T2))
    _close(epi.projection_matrix(t(K), t(T2)), want_P)
    want_F = ref_epi.fundamental_from_poses(jnp.asarray(K), jnp.asarray(T1),
                                            jnp.asarray(K), jnp.asarray(T2))
    got_F = epi.fundamental_from_poses(t(K), t(T1), t(K), t(T2))
    _close(got_F, want_F)
    rng = np.random.default_rng(seed)
    uv2n = uv2 + rng.normal(0, 2.0, uv2.shape).astype(np.float32)
    want_d = ref_epi.epipolar_dist2(want_F, jnp.asarray(uv1), jnp.asarray(uv2n))
    got_d = epi.epipolar_dist2(t(np.asarray(want_F)), t(uv1), t(uv2n))
    _close(got_d, want_d)
    # true correspondences lie on their epipolar lines
    assert float(epi.epipolar_dist2(got_F, t(uv1), t(uv2)).max()) < 1e-2


@pytest.mark.parametrize("seed", [0, 1])
def test_triangulation_checks(seed):
    K, T1, T2, X, uv1, uv2 = _scene(seed)
    rng = np.random.default_rng(seed + 5)
    # move a third of the points: behind the camera, off their pixels
    Xb = X.copy()
    Xb[::5, 2] *= -1
    Xb[1::7] += rng.normal(0, 0.2, Xb[1::7].shape).astype(np.float32)
    s1 = rng.choice([1.0, 1.44, 2.07], len(X)).astype(np.float32)
    s2 = rng.choice([1.0, 1.44, 2.07], len(X)).astype(np.float32)
    want = ref_epi.triangulation_checks(
        jnp.asarray(T1), jnp.asarray(T2), jnp.asarray(Xb), jnp.asarray(K),
        jnp.asarray(K), jnp.asarray(uv1), jnp.asarray(uv2), jnp.asarray(s1),
        jnp.asarray(s2))
    got = epi.triangulation_checks(t(T1), t(T2), t(Xb), t(K), t(K), t(uv1),
                                   t(uv2), t(s1), t(s2))
    assert got.dtype == torch.bool
    assert 0 < int(got.sum()) < len(X)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
