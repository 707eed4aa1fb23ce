"""The host half of the port's vocabulary module against the reference's on
equal numpy inputs: `sparse_bow` and `score_sparse` are numpy in both
packages and must agree exactly; the dense `bow_vector` / `score_l1` within
1e-6; `save_vocabulary` / `load_vocabulary` read each other's files."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam2_dualcam_tpu.vocab import bow as ref_bow
from orbslam2_dualcam_tpu_torch.utils.convert import vocab_from_numpy
from orbslam2_dualcam_tpu_torch.vocab import bow

from torch_parity import random_desc, t

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def vocs():
    rng = np.random.default_rng(4)
    docs = [random_desc(rng, 150) for _ in range(6)]
    ref = ref_bow.train_vocabulary(np.concatenate(docs), branching=5, depth=3,
                                   seed=2, weight_docs=docs)
    as_np = ref._replace(centroids=tuple(np.asarray(c) for c in ref.centroids),
                         idf=np.asarray(ref.idf))
    return ref, vocab_from_numpy(as_np, device="cpu"), rng


@pytest.mark.parametrize("case", ["dense", "few_valid", "negative_words",
                                  "empty"])
def test_sparse_bow_equals_reference(vocs, case):
    """Exact: same words, same float32 weights."""
    ref, voc, _ = vocs
    rng = np.random.default_rng(hash(case) % 1000)
    words = rng.integers(0, ref.n_words, 400)
    valid = rng.random(400) < {"dense": 0.9, "few_valid": 0.05,
                               "negative_words": 0.9, "empty": 0.0}[case]
    if case == "negative_words":
        words[::3] = -1
    want = ref_bow.sparse_bow(ref, words, valid)
    got = bow.sparse_bow(voc, words, valid)
    np.testing.assert_array_equal(got.words, want.words)
    np.testing.assert_array_equal(got.weights, want.weights)
    assert got.words.dtype == np.int32 and got.weights.dtype == np.float32
    assert got.nbytes == want.nbytes


def test_score_sparse_equals_reference(vocs):
    """Exact on 30 random pairs, on a vector with itself and on an empty
    one."""
    ref, voc, rng = vocs
    vecs = []
    for _ in range(12):
        words = rng.integers(0, ref.n_words, 300)
        valid = rng.random(300) < 0.8
        vecs.append((ref_bow.sparse_bow(ref, words, valid),
                     bow.sparse_bow(voc, words, valid)))
    for i in range(30):
        a, b = vecs[i % 12], vecs[(7 * i + 3) % 12]
        assert bow.score_sparse(a[1], b[1]) == ref_bow.score_sparse(a[0], b[0])
    assert bow.score_sparse(vecs[0][1], vecs[0][1]) == pytest.approx(1.0, abs=1e-5)
    empty = bow.sparse_bow(voc, np.zeros(4, np.int64), np.zeros(4, bool))
    assert bow.score_sparse(empty, vecs[0][1]) == 0.0


def test_idf_host_copy_is_cached_per_vocabulary(vocs):
    _, voc, _ = vocs
    a = bow._idf_np(voc)
    assert bow._idf_np(voc) is a
    other = voc._replace(idf=voc.idf * 2.0)
    np.testing.assert_array_equal(bow._idf_np(other), a * 2.0)
    np.testing.assert_array_equal(bow._idf_np(voc), a)


def test_dense_bow_vector_and_l1_score(vocs):
    """Dense vectors within 1e-6, and the dense L1 score equals the sparse
    one within 1e-5."""
    ref, voc, rng = vocs
    words = rng.integers(0, ref.n_words, (2, 300))
    valid = rng.random((2, 300)) < 0.8
    want = [np.asarray(ref_bow.bow_vector(ref, jnp.asarray(w), jnp.asarray(v)))
            for w, v in zip(words, valid)]
    got = [bow.bow_vector(voc, t(w), t(v)) for w, v in zip(words, valid)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-6)
    s = float(bow.score_l1(got[0], got[1]))
    assert s == pytest.approx(float(ref_bow.score_l1(jnp.asarray(want[0]),
                                                     jnp.asarray(want[1]))),
                              abs=1e-6)
    sp = [bow.sparse_bow(voc, w, v) for w, v in zip(words, valid)]
    assert s == pytest.approx(bow.score_sparse(sp[0], sp[1]), abs=1e-5)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_vocabulary_files_are_interchangeable(vocs, tmp_path, writer):
    ref, voc, rng = vocs
    path = str(tmp_path / "voc.npz")
    if writer == "port":
        bow.save_vocabulary(voc, path)
        back = ref_bow.load_vocabulary(path)
        got = [np.asarray(c) for c in back.centroids]
        idf = np.asarray(back.idf)
    else:
        ref_bow.save_vocabulary(ref, path)
        back = bow.load_vocabulary(path, device="cpu")
        got = [c.numpy().view(np.uint32) for c in back.centroids]
        idf = back.idf.numpy()
    assert (back.branching, back.depth, back.direct_level, back.n_words) == \
        (ref.branching, ref.depth, ref.direct_level, ref.n_words)
    for g, w in zip(got, ref.centroids):
        np.testing.assert_array_equal(g, np.asarray(w))
    np.testing.assert_array_equal(idf, np.asarray(ref.idf))
    if writer == "reference":
        d = random_desc(rng, 64)
        np.testing.assert_array_equal(
            bow.quantize(back, t(d.view(np.int32)))[0].numpy(),
            np.asarray(ref_bow.quantize(ref, jnp.asarray(d))[0]))
        with pytest.raises(RuntimeError, match="no CUDA device") \
                if not torch.cuda.is_available() else _noraise():
            bow.load_vocabulary(path)


class _noraise:
    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False
