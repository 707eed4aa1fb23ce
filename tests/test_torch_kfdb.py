"""The port's keyframe database against the reference's, both built with
`use_native=False` (the pure-Python postings, whose postings the tests
read and carry across; the C++ index of both packages is held equal in
tests/test_torch_native_invfile.py): the same adds, erases and queries on
both give equal shared-word counts and equal candidate lists, and
`kfdb_from_reference` carries a database across."""

import numpy as np
import pytest
import torch

from orbslam2_dualcam_tpu.models import kfdb as ref_kfdb
from orbslam2_dualcam_tpu.models import map as ref_map
from orbslam2_dualcam_tpu.vocab import bow as ref_bow
from orbslam2_dualcam_tpu_torch.models import kfdb
from orbslam2_dualcam_tpu_torch.models import map as port_map
from orbslam2_dualcam_tpu_torch.utils.convert import (kfdb_from_reference,
                                                      vocab_from_numpy)
from orbslam2_dualcam_tpu_torch.vocab import bow

from torch_parity import random_desc, scripted_map

torch.set_num_threads(1)

N_WORDS = 64


@pytest.fixture(scope="module")
def setup():
    """Two cameras' words for each keyframe of the scripted map: nearby
    keyframes share most of their words, as views of one place do."""
    rng = np.random.default_rng(1)
    docs = [random_desc(rng, 100) for _ in range(4)]
    ref_voc = ref_bow.train_vocabulary(np.concatenate(docs), branching=4,
                                       depth=3, seed=1, weight_docs=docs)
    assert ref_voc.n_words == N_WORDS
    voc = vocab_from_numpy(
        ref_voc._replace(centroids=tuple(np.asarray(c) for c in ref_voc.centroids),
                         idf=np.asarray(ref_voc.idf)), device="cpu")
    rm, _, _ = scripted_map(ref_map, n_kf=8)
    pm, _, _ = scripted_map(port_map, n_kf=8)
    place = rng.integers(0, N_WORDS, (4, 2, 120))
    words = {}
    for kid in rm.keyframes:
        w = place[kid // 2].copy()
        flip = rng.random(w.shape) < 0.25
        w[flip] = rng.integers(0, N_WORDS, int(flip.sum()))
        w[rng.random(w.shape) < 0.05] = -1
        words[kid] = w
    return ref_voc, voc, rm, pm, words, rng


def _fill(db, voc, sparse_bow, words, kids):
    for kid in kids:
        for cam in range(2):
            w = words[kid][cam]
            valid = w >= 0
            db.add(kid, cam, w[valid], sparse_bow(voc, w, valid))


def _both(setup, kids=None):
    ref_voc, voc, rm, pm, words, _ = setup
    kids = sorted(words) if kids is None else kids
    rdb = ref_kfdb.KeyFrameDatabase(2, N_WORDS, use_native=False)
    pdb = kfdb.KeyFrameDatabase(2, N_WORDS, use_native=False)
    _fill(rdb, ref_voc, ref_bow.sparse_bow, words, kids)
    _fill(pdb, voc, bow.sparse_bow, words, kids)
    return rdb, pdb


def _queries(setup, rdb, pdb):
    ref_voc, voc, rm, pm, words, rng = setup
    out = []
    for q in range(6):
        w = words[q][q % 2].copy()
        w[rng.random(w.shape) < 0.2] = -1
        for qc, rc in ((0, 0), (1, 0), (0, 1)):
            valid = w >= 0
            want = rdb.detect_reloc_candidates(
                w, ref_bow.sparse_bow(ref_voc, w, valid), qc, rc, rm)
            got = pdb.detect_reloc_candidates(
                w, bow.sparse_bow(voc, w, valid), qc, rc, pm)
            out.append((want, got))
    return out


def test_reloc_candidates_equal_reference(setup):
    rdb, pdb = _both(setup)
    res = _queries(setup, rdb, pdb)
    # every query finds its place, and the places differ
    assert all(len(w) >= 1 for w, _ in res)
    assert len({w[0] for w, _ in res}) >= 3
    for want, got in res:
        assert got == want
    assert pdb.nbytes_bow == rdb.nbytes_bow > 0


def test_shared_word_counts_equal_reference(setup):
    rdb, pdb = _both(setup)
    _, _, _, _, words, _ = setup
    for kid in (0, 3, 7):
        for cam in range(2):
            for exclude in (set(), {kid, 1}):
                want = rdb._shared_word_counts(words[kid][cam], cam, exclude)
                got = pdb._shared_word_counts(words[kid][cam], cam, exclude)
                assert dict(got) == dict(want) and list(got) == list(want)


def test_loop_candidates_equal_reference(setup):
    ref_voc, voc, rm, pm, words, _ = setup
    rdb, pdb = _both(setup)
    for kid in (5, 7):
        w = words[kid][0]
        valid = w >= 0
        for min_score in (0.0, 0.05):
            want = rdb.detect_loop_candidates(
                rm.keyframes[kid], w, ref_bow.sparse_bow(ref_voc, w, valid),
                0, 0, rm, min_score)
            got = pdb.detect_loop_candidates(
                pm.keyframes[kid], w, bow.sparse_bow(voc, w, valid),
                0, 0, pm, min_score)
            assert got == want


def test_erase_and_clear_equal_reference(setup):
    rdb, pdb = _both(setup)
    for kid in (2, 5, 99):
        rdb.erase(kid)
        pdb.erase(kid)
    for want, got in _queries(setup, rdb, pdb):
        assert got == want
        assert 2 not in got and 5 not in got
    for cam in range(2):
        assert set(pdb.bow[cam]) == set(rdb.bow[cam])
        assert {w: set(k) for w, k in pdb.inverted[cam].items() if k} == \
            {w: set(k) for w, k in rdb.inverted[cam].items() if k}
    rdb.clear()
    pdb.clear()
    assert all(got == want == [] for want, got in _queries(setup, rdb, pdb))


def test_kfdb_from_reference_carries_the_database(setup):
    rdb, _ = _both(setup, kids=[0, 1, 2, 3, 4, 6])
    pdb = kfdb_from_reference(rdb)
    for want, got in _queries(setup, rdb, pdb):
        assert got == want
    # independent copies
    pdb.erase(0)
    assert 0 in rdb.bow[0] and 0 not in pdb.bow[0]
    assert pdb.native is None
    if ref_kfdb.NativeInvertedFile is not None:
        with pytest.raises(ValueError, match="use_native=False"):
            kfdb_from_reference(ref_kfdb.KeyFrameDatabase(2, N_WORDS))
