"""Per-camera inverted-file keyframe database for relocalization and loop
detection.

Port of orbslam2_dualcam_tpu/models/kfdb.py (the original's
KeyFrameDatabase, src/KeyFrameDatabase.cc):
``mvvInvertedFiles[cam][wordId] -> list<KF>`` (KeyFrameDatabase.cc:56-73),
queried asymmetrically — camera `query_cam`'s BoW vector against camera
`resp_cam`'s index — which is THE enabler of cross-camera relocalization
(DetectRelocalizationCandidatesForCam, :250-370).

Index bookkeeping is host-side: the C++ postings index
(native/invfile.cpp) or Python sets.  BoW vectors are SPARSE
(word -> weight), exactly DBoW2's BowVector representation: at ORBvoc scale
(1e6 words) a dense vector is 4 MB/KF/camera, a sparse one ~10 KB, and the
L1 score only ever needs the intersection of active words
(vocab/bow.score_sparse, ScoringObject.h:76 semantics)."""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from orbslam2_dualcam_tpu_torch.models.map import KeyFrame, Map
from orbslam2_dualcam_tpu_torch.vocab.bow import SparseBow, score_sparse

# The C++ postings index (native/invfile.cpp), imported without a `try`:
# a failed build raises with g++'s message when a database is made.  Set
# this attribute to None to select the Python postings for every database
# made after that (the parity tests do, on both packages, to carry
# postings from one database to the other).
from orbslam2_dualcam_tpu_torch.native.invfile import NativeInvertedFile


class KeyFrameDatabase:
    def __init__(self, n_cameras: int, n_words: int,
                 use_native: bool = True) -> None:
        """`use_native` selects the C++ postings index (the reference's
        default too, so both packages break `_score_and_group`'s score
        ties in the same order); False, or the module attribute
        `NativeInvertedFile` set to None, selects the Python postings,
        which `inverted` exposes."""
        self.n_cameras = n_cameras
        self.n_words = n_words
        self.native = (NativeInvertedFile(n_cameras, n_words)
                       if use_native and NativeInvertedFile is not None
                       else None)
        # the Python postings: inverted[cam][word] = set of kids
        self.inverted: List[Dict[int, Set[int]]] = [
            defaultdict(set) for _ in range(n_cameras)]
        # sparse per-camera BoW vectors: kid -> SparseBow
        self.bow: List[Dict[int, SparseBow]] = [dict()
                                                for _ in range(n_cameras)]

    @property
    def nbytes_bow(self) -> int:
        """Total BoW-vector storage (the scale-gated budget)."""
        return sum(v.nbytes for per_cam in self.bow
                   for v in per_cam.values())

    # -- maintenance ------------------------------------------------------
    def add(self, kid: int, cam: int, words: np.ndarray,
            bow_vec: SparseBow) -> None:
        """Register camera `cam` of keyframe `kid` (KeyFrameDatabase::add,
        :66-73 adds per camera)."""
        if self.native is not None:
            self.native.add(kid, cam, words)
        else:
            for w in np.unique(words[words >= 0]):
                self.inverted[cam][int(w)].add(kid)
        self.bow[cam][kid] = bow_vec

    def erase(self, kid: int) -> None:
        if self.native is not None:
            self.native.erase(kid)
        for cam in range(self.n_cameras):
            vec = self.bow[cam].pop(kid, None)
            if vec is None or self.native is not None:
                continue
            for w in vec.words:
                self.inverted[cam][int(w)].discard(kid)

    def clear(self) -> None:
        if self.native is not None:
            self.native.clear()
        for cam in range(self.n_cameras):
            self.inverted[cam].clear()
            self.bow[cam].clear()

    # -- queries ----------------------------------------------------------
    def _shared_word_counts(self, words: np.ndarray, resp_cam: int,
                            exclude: Set[int]) -> Dict[int, int]:
        if self.native is not None:
            return self.native.query(resp_cam, words, exclude)
        counts: Dict[int, int] = defaultdict(int)
        for w in np.unique(words[words >= 0]):
            for kid in self.inverted[resp_cam].get(int(w), ()):
                if kid not in exclude:
                    counts[kid] += 1
        return counts

    def _score_and_group(self, counts: Dict[int, int], query_bow: SparseBow,
                         resp_cam: int, mp: Map, min_score: float,
                         min_common_frac: float = 0.8,
                         keep_frac: float = 0.75) -> List[int]:
        """Shared-word gating + best-covisibility-group accumulation,
        mirroring DetectLoopCandidatesForCam (KeyFrameDatabase.cc:111-247).

        For each scored candidate, its accumulator group is its 10 BEST
        covisible keyframes (GetBestCovisibilityKeyFrames, :167-172); the
        group's accumulated score competes, and the group's best-scoring
        MEMBER is what gets returned (:173-199) — so a strong neighbour
        promotes the whole region even when the direct hit is mediocre."""
        if not counts:
            return []
        max_common = max(counts.values())
        min_common = max_common * min_common_frac
        scored: Dict[int, float] = {}
        for kid, c in counts.items():
            if c < min_common:
                continue
            vec = self.bow[resp_cam].get(kid)
            if vec is None:
                continue
            s = score_sparse(query_bow, vec)
            if s >= min_score:
                scored[kid] = s
        if not scored:
            return []
        best_acc = 0.0
        groups: List[Tuple[float, int]] = []
        for kid, s in scored.items():
            kf = mp.keyframes.get(kid)
            acc, best_kid, best_s = s, kid, s
            if kf is not None:
                for nkid in mp.covisible_kfs(kf, 10):
                    ns = scored.get(nkid)
                    if ns is not None:
                        acc += ns
                        if ns > best_s:
                            best_s, best_kid = ns, nkid
            groups.append((acc, best_kid))
            best_acc = max(best_acc, acc)
        out, seen = [], set()
        for acc, kid in sorted(groups, key=lambda t: -t[0]):
            if acc >= keep_frac * best_acc and kid not in seen:
                seen.add(kid)
                out.append(kid)
        return out

    def detect_reloc_candidates(self, words: np.ndarray,
                                query_bow: SparseBow,
                                query_cam: int, resp_cam: int,
                                mp: Map) -> List[int]:
        """Relocalization candidates for a *frame*'s camera `query_cam`
        against camera `resp_cam`'s index
        (DetectRelocalizationCandidatesForCam, KeyFrameDatabase.cc:250-370).
        The (query_cam != resp_cam) case is cross-camera reloc."""
        del query_cam  # query side only contributes words/bow
        counts = self._shared_word_counts(words, resp_cam, exclude=set())
        return self._score_and_group(counts, query_bow, resp_cam, mp,
                                     min_score=0.0)

    def detect_loop_candidates(self, kf: KeyFrame, words: np.ndarray,
                               query_bow: SparseBow, query_cam: int,
                               resp_cam: int, mp: Map,
                               min_score: float) -> List[int]:
        """Loop candidates for keyframe `kf` (DetectLoopCandidatesForCam,
        KeyFrameDatabase.cc:111-247): excludes kf's covisibility
        neighbourhood, gates on min_score."""
        del query_cam
        exclude = set(kf.covis) | {kf.kid}
        counts = self._shared_word_counts(words, resp_cam, exclude)
        return self._score_and_group(counts, query_bow, resp_cam, mp,
                                     min_score=min_score)
