"""The port's Sim3 solvers against the reference's: Horn's closed form,
the 3-point Sim3 RANSAC (fed the minimal sets the reference draws from its
key) and the two-stage Sim3 optimizer, on the same seeded numpy inputs.

Tolerances: Horn's (R, t, s) within 1e-5 (rotations compared by angle, the
quaternion's sign being free); RANSAC's inlier mask and count equal and
(R, t, s) within 1e-4; the optimizer's inlier mask equal and S12 within
1e-4; a degenerate triple scores 0 inliers on both sides."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam2_dualcam_tpu.ops import lie as ref_lie
from orbslam2_dualcam_tpu.ops import ransac as ref_ransac
from orbslam2_dualcam_tpu.optim import sim3_opt as ref_sim3_opt
from orbslam2_dualcam_tpu_torch.ops import lie, ransac
from orbslam2_dualcam_tpu_torch.optim import sim3_opt

from torch_parity import t

torch.set_num_threads(1)

K = np.array([[300.0, 0, 160], [0, 300, 120], [0, 0, 1]], np.float32)


def _rot_angle(Ra, Rb) -> float:
    """The angle between two rotations, in radians: ||Ra - Rb||_F is
    2 sqrt(2) sin(angle / 2), which unlike the trace stays exact near 0."""
    d = np.linalg.norm(np.asarray(Ra, np.float64) - np.asarray(Rb, np.float64))
    return float(2.0 * np.arcsin(min(d / (2.0 * np.sqrt(2.0)), 1.0)))


def _proj(X):
    return X[:, :2] / X[:, 2:] * [K[0, 0], K[1, 1]] + [K[0, 2], K[1, 2]]


def _true_sim3(xi, s):
    R = np.asarray(ref_lie.so3_exp(jnp.asarray(xi[:3], jnp.float32)), np.float64)
    return R, np.asarray(xi[3:], np.float64), s


def _pairs(seed, n, outlier_share, s=1.3, noise=0.3):
    """Matched points in two camera frames (P1 = s R P2 + t), their pixels
    with noise, a share of the pairs corrupted, and per-pair level sigma2."""
    rng = np.random.default_rng(seed)
    R, tt, s = _true_sim3([0.1, -0.2, 0.05, 0.3, -0.1, 0.4], s)
    P2 = rng.uniform([-2, -2, 4], [2, 2, 9], (n, 3))
    P1 = s * P2 @ R.T + tt
    uv1 = _proj(P1) + rng.normal(0, noise, (n, 2))
    uv2 = _proj(P2) + rng.normal(0, noise, (n, 2))
    bad = rng.choice(n, int(outlier_share * n), replace=False)
    P2[bad] += rng.uniform(0.5, 1.5, (len(bad), 3))
    sig2 = (1.2 ** (2 * rng.integers(0, 3, (2, n)))).astype(np.float32)
    return (P1.astype(np.float32), P2.astype(np.float32), uv1.astype(np.float32),
            uv2.astype(np.float32), sig2[0], sig2[1], (R, tt, s))


@pytest.mark.parametrize("fix_scale", [False, True])
def test_horn_sim3_equals_reference(fix_scale):
    """One set and a batch of 16 sets in one call (the reference vmaps)."""
    rng = np.random.default_rng(3)
    R, tt, s = _true_sim3([0.3, 0.1, -0.2, 0.5, -0.2, 0.1], 0.8)
    P2 = rng.uniform(-2, 2, (16, 5, 3)).astype(np.float32)
    P1 = (s * P2 @ R.T + tt).astype(np.float32)
    Rb, tb, sb = ransac.horn_sim3(t(P1), t(P2), fix_scale)
    Rr, tr, sr = jax.vmap(lambda a, b: ref_ransac.horn_sim3(a, b, fix_scale))(
        jnp.asarray(P1), jnp.asarray(P2))
    R1, t1, s1 = ransac.horn_sim3(t(P1[0]), t(P2[0]), fix_scale)
    for i in range(16):
        assert _rot_angle(Rb[i].numpy(), np.asarray(Rr[i])) < 1e-5
        np.testing.assert_allclose(tb[i].numpy(), np.asarray(tr[i]), atol=1e-5)
        assert abs(float(sb[i]) - float(sr[i])) < 1e-5
    assert _rot_angle(R1.numpy(), Rb[0].numpy()) < 1e-6
    assert abs(float(s1) - float(sb[0])) < 1e-6
    # exact data: the truth itself
    assert _rot_angle(R1.numpy(), R) < 1e-5
    if fix_scale:
        assert float(s1) == 1.0
    else:
        assert abs(float(s1) - s) < 1e-5
        np.testing.assert_allclose(t1.numpy(), tt, atol=1e-5)


def _reference_idx(key, n_hyp, valid):
    return np.asarray(ref_ransac._sample_indices(
        key, n_hyp, 3, len(valid), jnp.asarray(valid, jnp.float32)))


@pytest.mark.parametrize("case", ["outliers", "degenerate_rows", "fix_scale"])
def test_sim3_solve_equals_reference(case, monkeypatch):
    """30% outliers; the port is fed `_sample_indices(key, 128, 3, N, valid)`
    of the reference; with degenerate_rows a third of the sets repeat one
    point three times (fed to both through the reference's sampler)."""
    fix_scale = case == "fix_scale"
    P1, P2, uv1, uv2, s1, s2, truth = _pairs(5, 100, 0.3,
                                             s=1.0 if fix_scale else 1.3)
    valid = np.ones(100, bool)
    valid[[3, 17, 41]] = False
    key = jax.random.PRNGKey(11)
    idx = _reference_idx(key, 128, valid)
    if case == "degenerate_rows":
        idx = idx.copy()
        idx[::3] = idx[::3, :1]
        monkeypatch.setattr(ref_ransac, "_sample_indices",
                            lambda *a, **k: jnp.asarray(idx))
    want = ref_ransac.sim3_ransac(
        key, *map(jnp.asarray, (P1, P2, valid, uv1, uv2, K, K, s1, s2)),
        fix_scale=fix_scale)
    got = ransac.sim3_solve(t(idx), t(P1), t(P2), t(valid), t(uv1), t(uv2),
                            t(K), t(K), t(s1), t(s2), fix_scale=fix_scale)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    assert int(got[4]) == int(want[4]) > 50
    assert bool(got[5]) and bool(want[5])
    assert _rot_angle(got[0].numpy(), np.asarray(want[0])) < 1e-4
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=1e-4)
    assert abs(float(got[2]) - float(want[2])) < 1e-4
    assert abs(float(got[2]) - truth[2]) < 0.05


def test_sim3_degenerate_triples_count_zero(monkeypatch):
    """Every set one point three times: Horn's scale is 0, the inverse is
    inf/nan, and no pair is an inlier on either side; nothing raises.  The
    points lie on a 1/64 grid, where the reference's float32 centroid
    (sum * (1/3)) is exact; the port's (summed in float64) is exact for any
    point, so off the grid it still counts 0, where the reference's can
    miss the point by an ulp and then count the triple's own point."""
    P1, P2, uv1, uv2, s1, s2, _ = _pairs(6, 40, 0.0)
    idx = np.repeat(np.arange(32)[:, None], 3, 1)
    args = (np.ones(40, bool), uv1, uv2, K, K, s1, s2)
    got = ransac.sim3_solve(t(idx), t(P1), t(P2), *map(t, args))
    assert int(got[4]) == 0 and not bool(got[5])
    P1, P2 = np.round(P1 * 64) / 64, np.round(P2 * 64) / 64
    monkeypatch.setattr(ref_ransac, "_sample_indices",
                        lambda *a, **k: jnp.asarray(idx))
    want = ref_ransac.sim3_ransac(jax.random.PRNGKey(0),
                                  *map(jnp.asarray, (P1, P2) + args))
    got = ransac.sim3_solve(t(idx), t(P1), t(P2), *map(t, args))
    assert int(want[4]) == int(got[4]) == 0
    assert not bool(want[5]) and not bool(got[5])
    assert not got[3].any()


def test_sim3_samples_draw_valid_rows_on_the_cpu_generator():
    valid = torch.zeros(50, dtype=torch.bool)
    valid[10:20] = True
    a = ransac.sim3_samples(torch.Generator().manual_seed(7), 128, valid)
    b = ransac.sim3_samples(torch.Generator().manual_seed(7), 128, valid)
    assert a.shape == (128, 3) and a.dtype == torch.int64
    assert torch.equal(a, b) and bool(valid[a].all())


def _opt_case(case):
    """The two cases of tests/test_sim3_opt.py, and one with 30% outliers
    and per-level sigmas."""
    rng = np.random.default_rng(0)
    n = {"converges": 60, "fix_scale": 40, "outliers": 80}[case]
    P2 = rng.uniform([-2, -2, 4], [2, 2, 9], (n, 3)).astype(np.float32)
    if case == "fix_scale":
        R, tt, s = _true_sim3([0.0, 0.1, 0.0, 0.2, 0.0, 0.1], 1.0)
    else:
        R, tt, s = _true_sim3([0.1, -0.2, 0.05, 0.3, -0.1, 0.4], 1.3)
    S_true = np.eye(4)
    S_true[:3, :3], S_true[:3, 3] = s * R, tt
    P1 = (P2 @ (s * R).T + tt).astype(np.float32)
    uv1, uv2 = _proj(P1), _proj(P2)
    is1 = is2 = np.ones(n, np.float32)
    S0 = S_true.astype(np.float32)
    if case != "fix_scale":
        uv1 = uv1 + rng.normal(0, 0.3, (n, 2))
        uv2 = uv2 + rng.normal(0, 0.3, (n, 2))
        n_bad = 10 if case == "converges" else 24
        bad = rng.choice(n, n_bad, replace=False)
        P2 = P2.copy()
        P2[bad] += rng.uniform(0.5, 1.5, (n_bad, 3))
        dxi = jnp.asarray([0.05, -0.03, 0.08, 0.02, 0.03, -0.02, 0.08], jnp.float32)
        S0 = (np.asarray(ref_lie.sim3_exp(dxi)) @ S_true).astype(np.float32)
    if case == "outliers":
        is1 = (1.0 / 1.2 ** (2 * rng.integers(0, 3, n))).astype(np.float32)
        is2 = (1.0 / 1.2 ** (2 * rng.integers(0, 3, n))).astype(np.float32)
    return (S0, P1, P2, uv1.astype(np.float32), uv2.astype(np.float32), is1, is2,
            np.ones(n, bool), K, K), case == "fix_scale", S_true


@pytest.mark.parametrize("case", ["converges", "fix_scale", "outliers"])
def test_optimize_sim3_equals_reference(case):
    args, fix_scale, S_true = _opt_case(case)
    S_r, inl_r, cnt_r = ref_sim3_opt.optimize_sim3(
        *map(jnp.asarray, args), fix_scale=fix_scale)
    S, inl, cnt = sim3_opt.optimize_sim3(*map(t, args), fix_scale=fix_scale)
    assert S.dtype == torch.float32
    np.testing.assert_array_equal(inl.numpy(), np.asarray(inl_r))
    assert int(cnt) == int(cnt_r)
    np.testing.assert_allclose(S.numpy(), np.asarray(S_r), atol=1e-4)
    R, _, s = lie.sim3_parts(S)
    if fix_scale:
        assert abs(float(s) - 1.0) < 1e-4
    else:
        assert int(cnt) >= 0.6 * len(inl)
        assert abs(float(s) - np.cbrt(np.linalg.det(S_true[:3, :3]))) < 0.02
