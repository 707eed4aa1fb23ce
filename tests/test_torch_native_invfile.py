"""The port's C++ postings index (orbslam2_dualcam_tpu_torch/native) against
its Python postings and against the reference's C++ index: the source is
the reference's byte for byte, the shared-word counts equal the Python
postings' (the reference's tests/test_native_invfile.py), and the same
adds, erases, clears and queries give the reference's results in the
reference's order (the order in which `_score_and_group` breaks score
ties).  The library is built under the package's `_build/`, and a failed
build raises instead of falling back to the Python postings."""

import filecmp
import pathlib

import numpy as np
import pytest
import torch

from orbslam2_dualcam_tpu.native import invfile as ref_invfile
from orbslam2_dualcam_tpu_torch.models import kfdb
from orbslam2_dualcam_tpu_torch.native import invfile
from orbslam2_dualcam_tpu_torch.vocab.bow import SparseBow

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
N_WORDS = 500


def _words(rng, n):
    return rng.integers(-1, N_WORDS, size=n).astype(np.int32)


def test_source_is_the_references():
    assert filecmp.cmp(ROOT / "orbslam2_dualcam_tpu_torch/native/invfile.cpp",
                       ROOT / "orbslam2_dualcam_tpu/native/invfile.cpp",
                       shallow=False)
    assert invfile.SRC == ROOT / "orbslam2_dualcam_tpu_torch/native/invfile.cpp"


def test_native_counts_equal_python_postings():
    """Random postings for 20 keyframes x 2 cameras (words in [-1, 500),
    repeats included): equal shared-word counts for 10 queries with
    exclusions, after an erase, and nothing after a clear."""
    rng = np.random.default_rng(0)
    dbs = [kfdb.KeyFrameDatabase(2, N_WORDS),
           kfdb.KeyFrameDatabase(2, N_WORDS, use_native=False)]
    assert dbs[0].native is not None and dbs[1].native is None
    words = {}
    for kid in range(20):
        for cam in range(2):
            w = words[kid, cam] = _words(rng, 120)
            uw = np.unique(w[w >= 0]).astype(np.int32)
            vec = SparseBow(uw, np.full(len(uw), 1.0 / max(len(uw), 1), np.float32))
            for db in dbs:
                db.add(kid, cam, w, vec)
    for trial in range(10):
        q = _words(rng, 100)
        excl = set(rng.integers(0, 20, size=3).tolist())
        a, b = (db._shared_word_counts(q, trial % 2, excl) for db in dbs)
        assert a == dict(b), trial
        assert a and not excl & set(a)
    for db in dbs:
        db.erase(7)
    a, b = (db._shared_word_counts(words[7, 0], 0, set()) for db in dbs)
    assert 7 not in a and a == dict(b)
    for db in dbs:
        db.clear()
    assert all(db._shared_word_counts(words[7, 0], 0, set()) == {} for db in dbs)


def test_native_equals_reference_native_in_order():
    """One sequence of adds (unknown words and repeats included), erases
    (an unknown kid included), a clear and queries through both packages'
    C++ indexes: every query returns the same (kid, count) pairs in the same
    order."""
    rng = np.random.default_rng(1)
    port, ref = invfile.NativeInvertedFile(2, N_WORDS), \
        ref_invfile.NativeInvertedFile(2, N_WORDS)
    results = []

    def query_both():
        for _ in range(6):
            q = _words(rng, 150)
            cam = int(rng.integers(0, 2))
            excl = rng.integers(0, 60, size=int(rng.integers(0, 4))).tolist()
            a, b = port.query(cam, q, excl), ref.query(cam, q, excl)
            assert list(a.items()) == list(b.items())
            results.append(len(a))

    for round_ in range(2):
        for kid in range(60):
            for cam in range(2):
                w = np.concatenate([_words(rng, 200), [N_WORDS + 3, -7]]).astype(np.int32)
                port.add(kid, cam, w)
                ref.add(kid, cam, w)
        query_both()
        for kid in (3, 17, 59, 1000):
            port.erase(kid)
            ref.erase(kid)
        query_both()
        if round_ == 0:
            port.clear()
            ref.clear()
            query_both()
    assert max(results) > 40 and min(results) == 0


def test_library_is_built_under_build_dir():
    db = kfdb.KeyFrameDatabase(1, 16)
    assert db.native is not None
    so = invfile.library_path()
    assert so.exists()
    assert so.parent == ROOT / "orbslam2_dualcam_tpu_torch" / "_build"


def test_broken_build_raises_and_does_not_fall_back(tmp_path, monkeypatch):
    """A source g++ rejects: making a database raises with the compiler's
    message; nothing selects the Python postings on the way."""
    bad = tmp_path / "invfile.cpp"
    bad.write_text(invfile.SRC.read_text() + "\nthis is not C++;\n")
    monkeypatch.setattr(invfile, "SRC", bad)
    monkeypatch.setattr(invfile, "BUILD_DIR", tmp_path / "_build")
    invfile.load_library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match=r"g\+\+ failed[\s\S]*error"):
            kfdb.KeyFrameDatabase(2, N_WORDS)
        assert not list((tmp_path / "_build").glob("*.so"))
    finally:
        monkeypatch.undo()
        invfile.load_library.cache_clear()
    assert kfdb.KeyFrameDatabase(2, N_WORDS).native is not None
