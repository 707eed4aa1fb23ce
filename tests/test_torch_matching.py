"""Descriptor matching: Hamming distances and the masked top-2 matcher
against the JAX reference on descriptors built to tie."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam2_dualcam_tpu.ops import matching as jm
from orbslam2_dualcam_tpu_torch.ops import matching as tm
from orbslam2_dualcam_tpu_torch.utils.convert import desc_to_torch

from torch_parity import random_desc

torch.set_num_threads(1)


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
