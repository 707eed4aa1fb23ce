"""ops/ransac.py of the port (two-view initialization) against the JAX
reference, fed the minimal sets the reference draws.

The null vectors behind H and F come from `eigh`/`svd`, whose sign (and, for
a degenerate sample, whose choice inside the null space) differs between
LAPACK front ends; H and F are compared up to scale and sign, scores, masks
and the reconstruction directly.  Tolerances are stated per assert."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam2_dualcam_tpu.ops import ransac as ref_ransac
from orbslam2_dualcam_tpu_torch.ops import ransac
from orbslam2_dualcam_tpu_torch.utils import synthetic

from torch_parity import small_K, t

torch.set_num_threads(1)


def _two_views(seed, planar, n=260, outliers=0.1):
    rng = np.random.default_rng(seed)
    K = small_K().astype(np.float32)
    if planar:
        X = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n),
                      np.full(n, 6.0)], 1)
        X[:, 2] += 0.15 * X[:, 0]            # a tilted wall
    else:
        X = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n),
                      rng.uniform(3, 10, n)], 1)
    T = np.eye(4)
    T[:3, :3] = synthetic.so3_exp(np.array([0.02, -0.06, 0.01]))
    T[:3, 3] = [-0.5, 0.05, 0.1]

    def proj(Xc):
        return (Xc[:, :2] / Xc[:, 2:]) * [K[0, 0], K[1, 1]] + [K[0, 2], K[1, 2]]

    uv1 = proj(X) + rng.normal(0, 0.3, (n, 2))
    uv2 = proj(X @ T[:3, :3].T + T[:3, 3]) + rng.normal(0, 0.3, (n, 2))
    bad = rng.random(n) < outliers
    uv2[bad] = rng.uniform(0, 240, (int(bad.sum()), 2))
    valid = np.ones(n, bool)
    valid[-10:] = False
    return (K, uv1.astype(np.float32), uv2.astype(np.float32), valid, T)


def _ref_samples(seed, n_hyp, valid):
    """The minimal sets `ref_ransac.two_view_init(PRNGKey(seed), ...)`
    draws, by the same calls."""
    kh, kf2 = jax.random.split(jax.random.PRNGKey(seed))
    w = jnp.asarray(valid).astype(jnp.float32)
    N = len(valid)
    return (np.asarray(ref_ransac._sample_indices(kh, n_hyp, 4, N, w)),
            np.asarray(ref_ransac._sample_indices(kf2, n_hyp, 8, N, w)))


def _unit(M):
    M = np.asarray(M, np.float64).reshape(-1)
    M = M / np.linalg.norm(M)
    return M * np.sign(M[np.argmax(np.abs(M))])


@pytest.mark.parametrize("planar,seed", [(True, 0), (True, 1), (False, 0),
                                         (False, 1)])
def test_two_view_init_matches_reference(planar, seed):
    K, uv1, uv2, valid, T_true = _two_views(seed, planar)
    n_hyp = 128
    want = ref_ransac.two_view_init(
        jax.random.PRNGKey(seed), jnp.asarray(uv1), jnp.asarray(uv2),
        jnp.asarray(valid), jnp.asarray(K), n_hyp=n_hyp)
    idx_h, idx_f = _ref_samples(seed, n_hyp, valid)
    got = ransac.two_view_solve(t(idx_h), t(idx_f), t(uv1), t(uv2), t(valid),
                                t(K))
    assert bool(got.is_h) == bool(want.is_h) == planar
    assert bool(got.success) and bool(want.success)
    # scores are sums of ~250 terms below 5.991: the chosen model's within
    # 1e-3 relative; the other's within 2e-2 (on a plane F is not unique,
    # so its refit depends on which null vector the eigensolver returns)
    tol_h, tol_f = (1e-3, 2e-2) if planar else (2e-2, 1e-3)
    np.testing.assert_allclose(float(got.score_h), float(want.score_h), rtol=tol_h)
    np.testing.assert_allclose(float(got.score_f), float(want.score_f), rtol=tol_f)
    # pose: 1e-3 absolute on a unit-translation transform
    np.testing.assert_allclose(got.T_21.numpy(), np.asarray(want.T_21), atol=1e-3)
    # the recovered motion is the scene's (translation up to scale)
    t_true = T_true[:3, 3] / np.linalg.norm(T_true[:3, 3])
    assert np.abs(got.T_21.numpy()[:3, 3] - t_true).max() < 0.05
    # >= 99% of the inlier flags equal
    gi, wi = got.inliers.numpy(), np.asarray(want.inliers)
    assert (gi == wi).mean() >= 0.99
    assert gi.sum() >= 150
    both = gi & wi
    # points within 1e-3 relative to the scene depth
    gp, wp = got.points.numpy()[both], np.asarray(want.points)[both]
    assert np.abs(gp - wp).max() <= 1e-3 * np.abs(wp).max()


def _normalized(uv1, uv2, valid):
    a, _ = ransac._normalize_2d(t(uv1), t(valid))
    b, _ = ransac._normalize_2d(t(uv2), t(valid))
    return a.numpy(), b.numpy()


def test_minimal_solvers_up_to_scale_and_sign():
    """_h_from_4pts / _f_from_8pts / refits on Hartley-normalized samples
    agree with the reference up to scale and sign.  Each is the float32
    null vector of a 9x9 A^T A (condition number squared), so two
    eigensolvers agree to TOL_MIN of the unit-norm matrix on a minimal set
    and to TOL_FIT on a refit over all points."""
    TOL_MIN, TOL_FIT = 2e-2, 2e-3
    K, uv1, uv2, valid, _ = _two_views(3, planar=True, outliers=0.0)
    a, b = _normalized(uv1, uv2, valid)
    rng = np.random.default_rng(0)
    for _ in range(4):
        i4 = rng.choice(200, 4, replace=False)
        got = ransac._h_from_4pts(t(a[i4]), t(b[i4]))
        want = ref_ransac._h_from_4pts(jnp.asarray(a[i4]), jnp.asarray(b[i4]))
        np.testing.assert_allclose(_unit(got), _unit(want), atol=TOL_MIN)
    w = valid.astype(np.float32)
    got = ransac._h_refit(t(a), t(b), t(w))
    want = ref_ransac._h_refit(jnp.asarray(a), jnp.asarray(b), jnp.asarray(w))
    np.testing.assert_allclose(_unit(got), _unit(want), atol=TOL_FIT)
    K, uv1, uv2, valid, _ = _two_views(3, planar=False, outliers=0.0)
    a, b = _normalized(uv1, uv2, valid)
    for _ in range(4):
        i8 = rng.choice(200, 8, replace=False)
        got = ransac._f_from_8pts(t(a[i8]), t(b[i8]))
        want = ref_ransac._f_from_8pts(jnp.asarray(a[i8]), jnp.asarray(b[i8]))
        np.testing.assert_allclose(_unit(got), _unit(want), atol=TOL_MIN)
        # rank 2
        assert abs(np.linalg.det(got.numpy().astype(np.float64))) < 1e-6
    got = ransac._f_refit(t(a), t(b), t(w))
    want = ref_ransac._f_refit(jnp.asarray(a), jnp.asarray(b), jnp.asarray(w))
    np.testing.assert_allclose(_unit(got), _unit(want), atol=TOL_FIT)


def test_batched_solvers_equal_per_sample():
    """The leading hypothesis axis gives what one sample at a time gives."""
    K, uv1, uv2, valid, _ = _two_views(4, planar=False)
    rng = np.random.default_rng(1)
    idx = rng.integers(0, 200, (6, 8))
    a, b = t(uv1) / 100, t(uv2) / 100
    Fb = ransac._f_from_8pts(a[t(idx)], b[t(idx)])
    Hb = ransac._h_from_4pts(a[t(idx[:, :4])], b[t(idx[:, :4])])
    for i in range(6):
        np.testing.assert_allclose(
            _unit(Fb[i]), _unit(ransac._f_from_8pts(a[t(idx[i])], b[t(idx[i])])),
            atol=1e-4)
        np.testing.assert_allclose(
            _unit(Hb[i]), _unit(ransac._h_from_4pts(a[t(idx[i, :4])],
                                                    b[t(idx[i, :4])])),
            atol=1e-4)


def test_errors_and_score_match_reference():
    """_h_transfer_err2, _f_epipolar_err2, _normalize_2d and _score on given
    models: 1e-4 relative."""
    K, uv1, uv2, valid, _ = _two_views(5, planar=True)
    rng = np.random.default_rng(2)
    H = (np.eye(3) + rng.normal(0, 0.01, (3, 3))).astype(np.float32)
    F = rng.normal(0, 1e-3, (3, 3)).astype(np.float32)
    for fn, rfn, M in ((ransac._h_transfer_err2, ref_ransac._h_transfer_err2, H),
                       (ransac._f_epipolar_err2, ref_ransac._f_epipolar_err2, F)):
        g1, g2 = fn(t(M), t(uv1), t(uv2))
        w1, w2 = rfn(jnp.asarray(M), jnp.asarray(uv1), jnp.asarray(uv2))
        np.testing.assert_allclose(g1.numpy(), np.asarray(w1), rtol=2e-4, atol=1e-4)
        np.testing.assert_allclose(g2.numpy(), np.asarray(w2), rtol=2e-4, atol=1e-4)
    gs, gg = ransac._score(g1, g2, t(valid), 1.0, 3.841, 5.991)
    ws, wg = ref_ransac._score(w1, w2, jnp.asarray(valid), 1.0, 3.841, 5.991)
    np.testing.assert_allclose(float(gs), float(ws), rtol=1e-4)
    assert (gg.numpy() == np.asarray(wg)).mean() >= 0.99
    gn, gT = ransac._normalize_2d(t(uv1), t(valid))
    wn, wT = ref_ransac._normalize_2d(jnp.asarray(uv1), jnp.asarray(valid))
    np.testing.assert_allclose(gn.numpy(), np.asarray(wn), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(gT.numpy(), np.asarray(wT), rtol=1e-5, atol=1e-5)


def test_sampling_is_seeded_and_on_the_cpu():
    valid = torch.ones(100, dtype=torch.bool)
    valid[50:] = False
    a = ransac.two_view_samples(torch.Generator().manual_seed(7), 64, valid)
    b = ransac.two_view_samples(torch.Generator().manual_seed(7), 64, valid)
    assert a[0].shape == (64, 4) and a[1].shape == (64, 8)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert int(a[0].max()) < 50 and int(a[1].max()) < 50   # valid rows only
    c = ransac.two_view_samples(torch.Generator().manual_seed(8), 64, valid)
    assert not torch.equal(a[1], c[1])


def test_two_view_init_own_samples_recovers_motion():
    K, uv1, uv2, valid, T_true = _two_views(6, planar=False)
    tv = ransac.two_view_init(torch.Generator().manual_seed(0), t(uv1), t(uv2),
                              t(valid), t(K), n_hyp=128)
    assert bool(tv.success) and not bool(tv.is_h)
    t_true = T_true[:3, 3] / np.linalg.norm(T_true[:3, 3])
    assert np.abs(tv.T_21.numpy()[:3, 3] - t_true).max() < 0.05
    assert np.abs(tv.T_21.numpy()[:3, :3] - T_true[:3, :3]).max() < 0.01
