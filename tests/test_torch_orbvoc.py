"""The port's ORBvoc loader on the synthetic ragged trees of
tests/test_orbvoc.py (its cases that are not slow), and against the
reference's loader on the same files: numpy host code, so the trees are
equal to the bit."""

import numpy as np
import pytest
import torch

from orbslam2_dualcam_tpu.vocab import orbvoc as ref_orbvoc
from orbslam2_dualcam_tpu_torch.vocab import bow, orbvoc

from test_orbvoc import (_make_ragged_tree, _reference_transform, _write_binary,
                         _write_text)
from torch_parity import t

torch.set_num_threads(1)


@pytest.fixture
def ragged(tmp_path):
    rng = np.random.default_rng(5)
    k, L = 3, 3
    rows = _make_ragged_tree(rng, k, L)
    return tmp_path, k, L, rows, rng


def test_text_binary_agree(ragged):
    tmp, k, L, rows, rng = ragged
    _write_text(str(tmp / "voc.txt"), k, L, rows)
    _write_binary(str(tmp / "voc.bin"), k, L, rows)
    v1 = orbvoc.load_orbvoc(str(tmp / "voc.txt"), device="cpu")
    v2 = orbvoc.load_orbvoc(str(tmp / "voc.bin"), device="cpu")
    assert v1.n_words == v2.n_words == sum(1 for r in rows if r[1])
    for c1, c2 in zip(v1.centroids, v2.centroids):
        assert torch.equal(c1, c2)
    assert torch.equal(v1.word_map, v2.word_map)
    np.testing.assert_allclose(v1.idf.numpy(), v2.idf.numpy(), rtol=1e-6)


def test_quantize_matches_reference_descent(ragged):
    tmp, k, L, rows, rng = ragged
    _write_text(str(tmp / "voc.txt"), k, L, rows)
    voc = orbvoc.load_orbvoc(str(tmp / "voc.txt"), device="cpu")
    qs = rng.integers(0, 256, (64, 32)).astype(np.uint8)
    words, _ = bow.quantize(voc, t(orbvoc._pack_desc(qs).view(np.int32)))
    words = words.numpy()
    for i in range(len(qs)):
        assert words[i] == _reference_transform(rows, k, L, qs[i]), i


@pytest.mark.parametrize("fmt", ["txt", "bin"])
def test_loader_equals_reference(ragged, fmt):
    """Exact: parsed arrays, centroids, word map, idf, word count."""
    tmp, k, L, rows, rng = ragged
    path = str(tmp / f"voc.{fmt}")
    (_write_text if fmt == "txt" else _write_binary)(path, k, L, rows)
    parse = "parse_text" if fmt == "txt" else "parse_binary"
    for g, w in zip(getattr(orbvoc, parse)(path), getattr(ref_orbvoc, parse)(path)):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    want = ref_orbvoc.load_orbvoc(path)
    got = orbvoc.load_orbvoc(path, device="cpu")
    assert (got.branching, got.depth, got.direct_level, got.n_words) == \
        (want.branching, want.depth, want.direct_level, want.n_words)
    for g, w in zip(got.centroids, want.centroids):
        np.testing.assert_array_equal(g.numpy().view(np.uint32), np.asarray(w))
    np.testing.assert_array_equal(got.word_map.numpy(), np.asarray(want.word_map))
    np.testing.assert_array_equal(got.idf.numpy(), np.asarray(want.idf))


def test_loader_default_device_is_the_card(ragged):
    tmp, k, L, rows, rng = ragged
    _write_text(str(tmp / "voc.txt"), k, L, rows)
    if torch.cuda.is_available():
        assert orbvoc.load_orbvoc(str(tmp / "voc.txt")).idf.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            orbvoc.load_orbvoc(str(tmp / "voc.txt"))
