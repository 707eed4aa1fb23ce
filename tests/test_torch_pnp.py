"""PnP RANSAC of the port against the reference on the scenes of
tests/test_ransac.py (a general cloud and a planar wall), both fed the
minimal sets the reference draws (its `_sample_indices` on the call's key,
and on `fold_in(key, 1)` for the planar hypotheses).

Tolerances: inlier masks agree on >= 98% of the rows, rotation within
0.05 degrees, translation within 1e-3 of the scene's depth; the 6-point DLT
poses of the hypotheses are compared as poses (after the sign fix), never as
null vectors; `_pnp_gn_refine` within 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam2_dualcam_tpu.ops import lie as ref_lie
from orbslam2_dualcam_tpu.ops import ransac as ref_ransac
from orbslam2_dualcam_tpu_torch.ops import ransac

from torch_parity import t

torch.set_num_threads(1)

K = np.array([[500.0, 0, 320], [0, 500, 240], [0, 0, 1]], np.float32)


def _project(T, X):
    xc = X @ T[:3, :3].T + T[:3, 3]
    return xc[:, :2] / xc[:, 2:] * [K[0, 0], K[1, 1]] + [K[0, 2], K[1, 2]]


def _scene(kind: str):
    rng = np.random.default_rng(7)
    if kind == "general":
        n, n_out, depth = 150, 40, 7.0
        X = rng.uniform([-3, -2, 4], [3, 2, 10], size=(n, 3))
        xi = [0.2, -0.1, 0.05, 0.05, -0.03, 0.1]
    else:
        n, n_out, depth = 60, 20, 6.0
        X = np.stack([rng.uniform(-4, 4, n), rng.uniform(-2, 2, n),
                      np.full(n, 6.0)], 1)
        xi = [0.3, -0.1, 0.2, 0.05, -0.2, 0.1]
    T = np.asarray(ref_lie.se3_exp(jnp.asarray(xi, jnp.float32)), np.float64)
    uv = _project(T, X) + rng.normal(0, 0.5, (n, 2))
    out = rng.choice(n, n_out, replace=False)
    uv[out] += rng.uniform(25, 100, (n_out, 2)) * rng.choice([-1, 1], (n_out, 2))
    valid = np.ones(n, bool)
    valid[rng.choice(n, 5, replace=False)] = False
    return X.astype(np.float32), uv.astype(np.float32), valid, T, depth


def reference_sets(key, n_hyp, valid):
    """The minimal sets `ref_ransac.pnp_ransac(key, ...)` draws."""
    w = jnp.asarray(valid, jnp.float32)
    n = len(valid)
    idx6 = ref_ransac._sample_indices(key, n_hyp, 6, n, w)
    idx4 = ref_ransac._sample_indices(jax.random.fold_in(key, 1), n_hyp, 4, n, w)
    return np.asarray(idx6), np.asarray(idx4)


def _rot_deg(Ra, Rb):
    c = (np.trace(Ra @ Rb.T) - 1.0) / 2.0
    return np.degrees(np.arccos(np.clip(c, -1.0, 1.0)))


@pytest.mark.parametrize("kind", ["general", "planar_wall"])
def test_pnp_solve_equals_reference(kind):
    X, uv, valid, T_true, depth = _scene(kind)
    key = jax.random.PRNGKey(3)
    want = ref_ransac.pnp_ransac(key, jnp.asarray(X), jnp.asarray(uv),
                                 jnp.asarray(valid), jnp.asarray(K), n_hyp=256)
    idx6, idx4 = reference_sets(key, 256, valid)
    got = ransac.pnp_solve(t(idx6), t(idx4), t(X), t(uv), t(valid), t(K))
    T_w, inl_w = np.asarray(want[0], np.float64), np.asarray(want[1])
    T_g, inl_g = got[0].numpy().astype(np.float64), got[1].numpy()
    assert bool(want[3]) and bool(got[3])
    assert (inl_g == inl_w).mean() >= 0.98
    assert abs(int(got[2]) - int(want[2])) <= 0.02 * len(valid)
    assert not inl_g[~valid].any()
    assert _rot_deg(T_g[:3, :3], T_w[:3, :3]) < 0.05
    assert np.abs(T_g[:3, 3] - T_w[:3, 3]).max() < 1e-3 * depth
    # and both are the scene's pose
    assert _rot_deg(T_g[:3, :3], T_true[:3, :3]) < 1.5
    assert np.abs(T_g[:3, 3] - T_true[:3, 3]).max() < 0.03 * depth


def _clean_sets(X, uv, valid, T_true, k, n_sets=128):
    """Minimal sets of distinct rows whose observations are within 2 px of
    the scene's pose: what a hypothesis that can win is made of."""
    good = np.nonzero(valid & (np.abs(_project(T_true, X) - uv).max(1) < 2.0))[0]
    rng = np.random.default_rng(1)
    return np.stack([rng.choice(good, k, replace=False) for _ in range(n_sets)])


def _normalized(uv):
    Kinv = np.linalg.inv(K)
    return (np.concatenate([uv, np.ones_like(uv[:, :1])], 1)
            @ Kinv.T)[:, :2].astype(np.float32)


def test_dlt_hypotheses_equal_reference_as_poses():
    """The port's batched 6-point DLT against the reference's vmapped one
    on 128 clean sets of the general scene, compared as poses (the null
    vector's sign is free): rotation within 0.1 degree and translation
    within 1e-3 of the depth on every set."""
    X, uv, valid, T_true, depth = _scene("general")
    uv_n = _normalized(uv)
    idx6 = _clean_sets(X, uv, valid, T_true, 6)
    want = np.asarray(jax.vmap(
        lambda i: ref_ransac._pnp_dlt(jnp.asarray(X)[i], jnp.asarray(uv_n)[i]))(
            jnp.asarray(idx6)), np.float64)
    got = ransac._pnp_dlt(t(X)[t(idx6)], t(uv_n)[t(idx6)])
    got = got.numpy().astype(np.float64)
    assert got.shape == (128, 4, 4) and np.isfinite(got).all()
    rot = np.array([_rot_deg(g[:3, :3], w[:3, :3]) for g, w in zip(got, want)])
    dt = np.abs(got[:, :3, 3] - want[:, :3, 3]).max(1)
    assert rot.max() < 0.1 and dt.max() < 1e-3 * depth, (rot.max(), dt.max())
    # proper rotations
    assert np.allclose(np.linalg.det(got[:, :3, :3]), 1.0, atol=1e-3)


def test_planar_hypotheses_equal_reference(monkeypatch):
    """Plane-homography hypotheses on the wall from 128 clean 4-point sets.
    A 4-point homography in f32 (the null vector of a 9x9 Gram matrix) is
    ill-conditioned, and most such poses are far from the truth in both
    packages; among those the reference puts within 5 degrees of the
    scene's pose (the ones that can win the consensus), >= 90% agree
    within 0.5 degree and 2% of the depth."""
    X, uv, valid, T_true, depth = _scene("planar_wall")
    uv_n = _normalized(uv)
    idx4 = _clean_sets(X, uv, valid, T_true, 4)
    monkeypatch.setattr(ref_ransac, "_sample_indices",
                        lambda *a, **kw: jnp.asarray(idx4))
    want = np.asarray(ref_ransac._pnp_planar_hypotheses(
        jax.random.PRNGKey(9), jnp.asarray(X), jnp.asarray(uv_n),
        jnp.asarray(valid), 128), np.float64)
    got = ransac._pnp_planar_hypotheses(t(idx4), t(X), t(uv_n), t(valid))
    got = got.numpy().astype(np.float64)
    near = np.array([_rot_deg(w[:3, :3], T_true[:3, :3]) for w in want]) < 5.0
    assert near.sum() >= 40
    rot = np.array([_rot_deg(g[:3, :3], w[:3, :3]) for g, w in zip(got, want)])
    dt = np.abs(got[:, :3, 3] - want[:, :3, 3]).max(1)
    assert ((rot < 0.5) & (dt < 0.02 * depth))[near].mean() >= 0.90


@pytest.mark.parametrize("kind", ["general", "planar_wall"])
def test_gn_refine_equals_reference(kind):
    """From a pose 3 degrees and 0.1 off: within 1e-4."""
    X, uv, valid, T_true, _ = _scene(kind)
    Kinv = np.linalg.inv(K)
    uv_n = (np.concatenate([uv, np.ones_like(uv[:, :1])], 1) @ Kinv.T)[:, :2]
    uv_n = uv_n.astype(np.float32)
    T0 = (np.asarray(ref_lie.se3_exp(jnp.asarray(
        [0.1, -0.05, 0.08, 0.03, -0.04, 0.02], jnp.float32))) @ T_true
          ).astype(np.float32)
    err = np.abs(_project(T_true, X) - uv).max(1)
    w = (valid & (err < 3.0)).astype(np.float32)
    want = np.asarray(ref_ransac._pnp_gn_refine(
        jnp.asarray(T0), jnp.asarray(X), jnp.asarray(uv_n), jnp.asarray(w)))
    got = ransac._pnp_gn_refine(t(T0), t(X), t(uv_n), t(w)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)
    assert np.abs(got - T_true).max() < 0.02


def test_sampling_is_split_from_solving():
    """`pnp_samples` draws on the CPU among the valid rows, the same sets
    for the same seed, and `pnp_ransac` is samples + solve."""
    X, uv, valid, _, _ = _scene("general")
    a = ransac.pnp_samples(torch.Generator().manual_seed(5), 64, t(valid))
    b = ransac.pnp_samples(torch.Generator().manual_seed(5), 64, t(valid))
    assert a[0].shape == (64, 6) and a[1].shape == (64, 4)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert valid[a[0].numpy()].all() and valid[a[1].numpy()].all()
    r1 = ransac.pnp_ransac(torch.Generator().manual_seed(5), t(X), t(uv),
                           t(valid), t(K), n_hyp=64)
    r2 = ransac.pnp_solve(a[0], a[1], t(X), t(uv), t(valid), t(K))
    for x, y in zip(r1, r2):
        assert torch.equal(x, y)
    assert bool(r1[3]) and int(r1[2]) > 90


def test_weighted_dlt_and_degenerate_sets():
    """The overdetermined weighted refit recovers the pose of a clean
    general scene; a set of six copies of one point gives no inlier and
    breaks nothing."""
    X, uv, valid, T_true, depth = _scene("general")
    Kinv = np.linalg.inv(K)
    uv_clean = _project(T_true, X)
    uv_n = (np.concatenate([uv_clean, np.ones((len(X), 1))], 1) @ Kinv.T)[:, :2]
    T = ransac._pnp_dlt(t(X), t(uv_n.astype(np.float32)),
                                 t(valid.astype(np.float32))).numpy()
    want = np.asarray(ref_ransac._pnp_dlt_weighted(
        jnp.asarray(X), jnp.asarray(uv_n.astype(np.float32)),
        jnp.asarray(valid.astype(np.float32))))
    assert _rot_deg(T[:3, :3], T_true[:3, :3]) < 0.2
    assert np.abs(T[:3, 3] - T_true[:3, 3]).max() < 5e-3 * depth
    assert _rot_deg(T[:3, :3], want[:3, :3]) < 0.2
    idx6 = torch.zeros((8, 6), dtype=torch.int64)
    idx4 = torch.zeros((8, 4), dtype=torch.int64)
    T, inl, n, ok = ransac.pnp_solve(idx6, idx4, t(X), t(uv), t(valid), t(K))
    assert torch.isfinite(T).all() or not bool(ok)
    assert not bool(ok)
