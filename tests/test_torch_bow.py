"""BoW vocabulary: the port's numpy training copy and its torch quantize
against the JAX reference."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam2_dualcam_tpu.vocab import bow as jbow
from orbslam2_dualcam_tpu_torch.utils.convert import desc_to_torch, vocab_from_numpy
from orbslam2_dualcam_tpu_torch.vocab import bow as tbow

from torch_parity import random_desc

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def trained():
    rng = np.random.default_rng(5)
    train = random_desc(rng, 3000)
    return rng, train, jbow.train_vocabulary(train, branching=10, depth=3,
                                             seed=3, direct_level=2)


@pytest.mark.parametrize("weighted", [False, True])
def test_train_vocabulary_copy_matches_reference(trained, weighted):
    """The numpy training copy reproduces the reference tree exactly, and
    with training documents the same tf-idf weights."""
    rng, train, jv = trained
    docs = None
    if weighted:
        docs = [train[i:i + 150] for i in range(0, 1500, 150)]
        jv = jbow.train_vocabulary(train, branching=10, depth=3, seed=3,
                                   direct_level=2, weight_docs=docs)
    tv = tbow.train_vocabulary(train, branching=10, depth=3, seed=3,
                               direct_level=2, weight_docs=docs,
                               device="cpu")
    for a, b in zip(tv.centroids, jv.centroids):
        np.testing.assert_array_equal(a.numpy().view(np.uint32), np.asarray(b))
    np.testing.assert_array_equal(tv.idf.numpy(), np.asarray(jv.idf))
    assert weighted == bool((tv.idf.numpy() != 1.0).any())


@pytest.mark.parametrize("word_map", [False, True])
def test_quantize_exact(trained, word_map):
    """Words and direct-index nodes are integers from exact popcounts with
    first-minimum argmin: exactly equal, also through a word_map."""
    rng, train, jv = trained
    if word_map:
        jv = jv._replace(word_map=jnp.asarray(
            rng.permutation(1000).astype(np.int32)))
    # random descriptors, plus training rows (ties with their centroids)
    desc = np.concatenate([random_desc(rng, 700), train[:300]])
    jw, jn = jbow.quantize(jv, jnp.asarray(desc))
    tv = vocab_from_numpy(jv, "cpu")
    tw, tn = tbow.quantize(tv, desc_to_torch(desc, "cpu"))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))


def test_popcount_words_matches_numpy():
    rng = np.random.default_rng(9)
    d = random_desc(rng, 64)
    np.testing.assert_array_equal(
        tbow.popcount_words(desc_to_torch(d, "cpu")).numpy(), np.bitwise_count(d))
