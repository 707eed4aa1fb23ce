"""Descriptor matching: Hamming distances, the masked top-2 matcher with
its mutual and rotation-consistency tests, and the variant masks, against
the JAX reference on descriptors built to tie.  Indices and distances are
integers and compare exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam2_dualcam_tpu.ops import matching as jm
from orbslam2_dualcam_tpu_torch.ops import matching as tm
from orbslam2_dualcam_tpu_torch.utils import convert

from torch_parity import random_desc

torch.set_num_threads(1)


def desc_to_torch(d):
    return convert.desc_to_torch(d, "cpu")


def _flip_bits(rng, d, k):
    out = d.copy()
    for row in out:
        for b in rng.choice(256, k, replace=False):
            row[b // 32] ^= np.uint32(1) << np.uint32(b % 32)
    return out


def _tied_sets(seed):
    """Rows are noisy copies of a few bases, columns hold exact duplicates
    and copies at equal bit distances: many equal distances per row, and
    several rows claiming the same column at the same distance."""
    rng = np.random.default_rng(seed)
    base = random_desc(rng, 40)
    a = np.concatenate([base, _flip_bits(rng, base, 3), base[:20],
                        random_desc(rng, 60)])
    b = np.concatenate([base, base[:20], _flip_bits(rng, base, 2),
                        _flip_bits(rng, base, 2), random_desc(rng, 30)])
    return rng, a, b


def test_hamming_matrix_exact():
    _, a, b = _tied_sets(0)
    ours = tm.hamming_matrix(desc_to_torch(a), desc_to_torch(b)).numpy()
    np.testing.assert_array_equal(ours, np.asarray(
        jm.hamming_matrix(jnp.asarray(a), jnp.asarray(b))))
    pop = np.bitwise_count(a[:, None, :] ^ b[None, :, :]).sum(-1)
    np.testing.assert_array_equal(ours, pop)


@pytest.mark.parametrize("max_dist,ratio", [(50.0, 1.0), (100.0, 0.9),
                                            (40.0, 0.8)])
def test_match_masked_exact_with_ties(max_dist, ratio):
    """Same idx and dist exactly: integer distances, and the top-2 and
    de-duplication tie rules (lower column first, first row wins) pinned
    on both sides."""
    rng, a, b = _tied_sets(1)
    N, M = len(a), len(b)
    uv_a = rng.uniform(0, 60, (N, 2)).astype(np.float32)
    uv_b = rng.uniform(0, 60, (M, 2)).astype(np.float32)
    radius = rng.uniform(10, 40, N).astype(np.float32)
    lv_a = rng.integers(0, 4, N).astype(np.int32)
    lv_b = rng.integers(0, 4, M).astype(np.int32)
    va = rng.uniform(size=N) > 0.1
    vb = rng.uniform(size=M) > 0.1

    jallow = (jm.window_mask(jnp.asarray(uv_a), jnp.asarray(uv_b),
                             jnp.asarray(radius)) &
              jm.level_mask(jnp.asarray(lv_a), jnp.asarray(lv_b), -1, 1))
    jr = jm.match_masked(jnp.asarray(a), jnp.asarray(b), allow=jallow,
                         valid_a=jnp.asarray(va), valid_b=jnp.asarray(vb),
                         max_dist=max_dist, ratio=ratio)
    tallow = (tm.window_mask(torch.as_tensor(uv_a), torch.as_tensor(uv_b),
                             torch.as_tensor(radius)) &
              tm.level_mask(torch.as_tensor(lv_a).long(),
                            torch.as_tensor(lv_b).long(), -1, 1))
    np.testing.assert_array_equal(tallow.numpy(), np.asarray(jallow))
    tr = tm.match_masked(desc_to_torch(a), desc_to_torch(b), allow=tallow,
                         valid_a=torch.as_tensor(va),
                         valid_b=torch.as_tensor(vb),
                         max_dist=max_dist, ratio=ratio)
    assert (np.asarray(jr.idx) >= 0).sum() >= 20
    np.testing.assert_array_equal(tr.idx.numpy(), np.asarray(jr.idx))
    np.testing.assert_array_equal(tr.dist.numpy(), np.asarray(jr.dist))


def test_match_masked_batched_equals_per_batch():
    """A leading batch axis (the port's camera axis) equals the rows of
    the batch matched one by one."""
    rng, a, b = _tied_sets(2)
    b2 = np.stack([b, b[::-1].copy()])
    allow = torch.as_tensor(rng.uniform(size=(2, len(a), len(b))) > 0.3)
    da, db = desc_to_torch(a), desc_to_torch(b2)
    res = tm.match_masked(da, db, allow=allow, max_dist=100.0, ratio=0.9)
    for c in range(2):
        one = tm.match_masked(da, db[c], allow=allow[c], max_dist=100.0,
                              ratio=0.9)
        assert torch.equal(res.idx[c], one.idx)
        assert torch.equal(res.dist[c], one.dist)


def _angles(rng, a_len, b_len):
    """Angles whose differences fall into a few crowded bins and many
    sparse ones, so the three-maxima rule has something to drop."""
    ang_b = rng.uniform(-np.pi, np.pi, b_len).astype(np.float32)
    ang_a = rng.uniform(-np.pi, np.pi, a_len).astype(np.float32)
    n = min(a_len, b_len)
    offs = rng.choice([0.3, 0.35, 1.9, -2.2], n, p=[0.4, 0.3, 0.2, 0.1])
    ang_a[:n] = ang_b[:n] + offs + rng.normal(0, 0.02, n)
    return ang_a.astype(np.float32), ang_b


@pytest.mark.parametrize("mutual,angles,histo_length", [
    (True, False, 30), (False, True, 30), (True, True, 30), (False, True, 12)])
def test_match_masked_variants_exact(mutual, angles, histo_length):
    """mutual-best and rotation consistency, alone and together: idx and
    dist equal the reference's exactly, with a precomputed distance matrix
    too."""
    rng, a, b = _tied_sets(3)
    va = rng.uniform(size=len(a)) > 0.1
    vb = rng.uniform(size=len(b)) > 0.1
    ang_a, ang_b = _angles(rng, len(a), len(b))
    jkw = dict(angle_a=jnp.asarray(ang_a), angle_b=jnp.asarray(ang_b)) if angles else {}
    tkw = dict(angle_a=torch.as_tensor(ang_a), angle_b=torch.as_tensor(ang_b)) if angles else {}
    jr = jm.match_masked(jnp.asarray(a), jnp.asarray(b), valid_a=jnp.asarray(va),
                         valid_b=jnp.asarray(vb), max_dist=140.0, ratio=1.0,
                         mutual=mutual, histo_length=histo_length, **jkw)
    plain = jm.match_masked(jnp.asarray(a), jnp.asarray(b), valid_a=jnp.asarray(va),
                            valid_b=jnp.asarray(vb), max_dist=140.0, ratio=1.0)
    n_ref = int((np.asarray(jr.idx) >= 0).sum())
    # the variant really changes the result on this input
    assert n_ref >= 20
    assert (np.asarray(jr.idx) != np.asarray(plain.idx)).any()
    da, db = desc_to_torch(a), desc_to_torch(b)
    for dm in (None, tm.hamming_matrix(da, db)):
        tr = tm.match_masked(da, db, valid_a=torch.as_tensor(va),
                             valid_b=torch.as_tensor(vb), max_dist=140.0,
                             ratio=1.0, mutual=mutual,
                             histo_length=histo_length, dist_matrix=dm, **tkw)
        np.testing.assert_array_equal(tr.idx.numpy(), np.asarray(jr.idx))
        np.testing.assert_array_equal(tr.dist.numpy(), np.asarray(jr.dist))


def test_rotation_consistency_exact():
    rng = np.random.default_rng(4)
    ang_a, ang_b = _angles(rng, 300, 260)
    idx = rng.integers(-1, 260, 300).astype(np.int32)
    for h in (30, 12):
        ref = np.asarray(jm._rotation_consistency(
            jnp.asarray(ang_a), jnp.asarray(ang_b), jnp.asarray(idx), h))
        ours = tm._rotation_consistency(
            torch.as_tensor(ang_a), torch.as_tensor(ang_b),
            torch.as_tensor(idx).long(), h).numpy()
        np.testing.assert_array_equal(ours, ref)
        assert 0 < ours.sum() < (idx >= 0).sum()
    # a leading batch axis equals the rows one by one
    both = tm._rotation_consistency(
        torch.as_tensor(np.stack([ang_a, ang_a[::-1].copy()])),
        torch.as_tensor(np.stack([ang_b, ang_b])),
        torch.as_tensor(np.stack([idx, idx])).long(), 30)
    ref_30 = torch.as_tensor(np.array(jm._rotation_consistency(
        jnp.asarray(ang_a), jnp.asarray(ang_b), jnp.asarray(idx), 30)))
    assert torch.equal(both[0], ref_30) and not torch.equal(both[1], ref_30)


def test_node_mask_and_bow_match_exact():
    """node_mask as match_bow_frame_kf uses it (frontend.py:498): same
    mask, same matches."""
    rng, a, b = _tied_sets(5)
    na = rng.integers(-1, 6, len(a)).astype(np.int32)
    nb = rng.integers(-1, 6, len(b)).astype(np.int32)
    ang_a, ang_b = _angles(rng, len(a), len(b))
    jallow = jm.node_mask(jnp.asarray(na), jnp.asarray(nb)) & (jnp.asarray(na) >= 0)[:, None]
    tna, tnb = torch.as_tensor(na).long(), torch.as_tensor(nb).long()
    tallow = tm.node_mask(tna, tnb) & (tna >= 0)[:, None]
    np.testing.assert_array_equal(tallow.numpy(), np.asarray(jallow))
    jr = jm.match_masked(jnp.asarray(a), jnp.asarray(b), allow=jallow,
                         max_dist=50.0, ratio=0.75, angle_a=jnp.asarray(ang_a),
                         angle_b=jnp.asarray(ang_b))
    tr = tm.match_masked(desc_to_torch(a), desc_to_torch(b), allow=tallow,
                         max_dist=50.0, ratio=0.75, angle_a=torch.as_tensor(ang_a),
                         angle_b=torch.as_tensor(ang_b))
    assert (np.asarray(jr.idx) >= 0).sum() >= 10
    np.testing.assert_array_equal(tr.idx.numpy(), np.asarray(jr.idx))
    np.testing.assert_array_equal(tr.dist.numpy(), np.asarray(jr.dist))


def test_epipolar_mask_exact():
    """The triangulation gate on a two-view geometry with points on and off
    their epipolar lines: the same boolean matrix, and the matches through
    it (ratio 0.8, mutual, as triangulate_pair calls it) exact."""
    rng, a, b = _tied_sets(6)
    N, M = len(a), len(b)
    K = np.array([[260.0, 0, 160], [0, 260.0, 120], [0, 0, 1]])
    R = np.array([[0.995, 0, 0.0998], [0, 1, 0], [-0.0998, 0, 0.995]])
    t = np.array([0.3, 0.02, 0.05])
    X = np.concatenate([rng.uniform(-2, 2, (N, 2)), rng.uniform(3, 8, (N, 1))], 1)
    x1 = X @ K.T
    x2 = (X @ R.T + t) @ K.T
    uv1 = (x1[:, :2] / x1[:, 2:]).astype(np.float32)
    uv2 = np.resize(x2[:, :2] / x2[:, 2:], (M, 2)).astype(np.float32)
    uv2 += rng.normal(0, 0.7, uv2.shape).astype(np.float32)
    tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
    F12 = (np.linalg.inv(K).T @ (tx @ R).T @ np.linalg.inv(K)).astype(np.float32)
    F12 /= np.abs(F12).max()
    e = K @ t
    ep = (e[:2] / e[2]).astype(np.float32)
    sig2 = (1.2 ** rng.integers(0, 4, M) ** 2).astype(np.float32)
    jallow = jm.epipolar_mask(jnp.asarray(F12), jnp.asarray(uv1), jnp.asarray(uv2),
                              jnp.asarray(sig2), jnp.asarray(ep), jnp.float32(100.0))
    tallow = tm.epipolar_mask(torch.as_tensor(F12), torch.as_tensor(uv1),
                              torch.as_tensor(uv2), torch.as_tensor(sig2),
                              torch.as_tensor(ep), torch.tensor(100.0))
    ref = np.asarray(jallow)
    assert 0.002 < ref.mean() < 0.5
    np.testing.assert_array_equal(tallow.numpy(), ref)
    jr = jm.match_masked(jnp.asarray(a), jnp.asarray(b), allow=jallow,
                         max_dist=100.0, ratio=0.8, mutual=True)
    tr = tm.match_masked(desc_to_torch(a), desc_to_torch(b), allow=tallow,
                         max_dist=100.0, ratio=0.8, mutual=True)
    np.testing.assert_array_equal(tr.idx.numpy(), np.asarray(jr.idx))
    np.testing.assert_array_equal(tr.dist.numpy(), np.asarray(jr.dist))
