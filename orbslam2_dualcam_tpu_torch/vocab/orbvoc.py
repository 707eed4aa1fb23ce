"""DBoW2 ORBvoc interop: load the original system's vocabulary files.

Port of orbslam2_dualcam_tpu/vocab/orbvoc.py: the parsers and the
densification are that module's numpy code; the finished tree is placed on
a torch device.

The original ships a pre-trained 10^6-word ORB vocabulary (k=10, L=6)
and loads it in TemplatedVocabulary::loadFromTextFile
(Thirdparty/DBoW2/DBoW2/TemplatedVocabulary.h:1362) or loadFromBinaryFile
(:1478).  Both formats list nodes in creation order: `parent is_leaf
d0..d31 weight`, with word ids assigned to leaves in file order.

DBoW2 trees are RAGGED: a cluster with fewer than k descriptors stops
splitting, so leaves occur at any depth and interior nodes can have fewer
than k children (TemplatedVocabulary.h:251-276 HKmeansStep).  Our device
quantizer (vocab/bow.quantize) walks a DENSE per-level layout — child j of
flat node n lives at slot n*k+j — so the loader densifies:

- missing children copy the parent centroid (the argmin then never leaves
  the real branch: a copy ties with its source and argmin takes the
  lowest index, which is the real child when one exists);
- a leaf reached before full depth is propagated downward as its own
  single child until the final level;
- `word_map` [k^depth] resolves each final slot to the DBoW2 word id of
  the leaf whose propagation covers it (-1 slots are unreachable).

The per-word idf weights come straight from the file's leaf weights (DBoW2
TF_IDF: the stored weight IS the idf, TemplatedVocabulary.h:679-720).
"""

from __future__ import annotations

import struct
from typing import List, Tuple

import numpy as np
import torch

from orbslam2_dualcam_tpu_torch.utils.device import resolve_device
from orbslam2_dualcam_tpu_torch.vocab.bow import Vocabulary


def _pack_desc(bytes32: np.ndarray) -> np.ndarray:
    """[N, 32] uint8 descriptor bytes -> [N, 8] uint32 little-endian packed
    (our matchers' layout; bit b of byte i == bit (i%4)*8+b of
    word i//4, matching cv2's row-major byte order)."""
    return bytes32.reshape(-1, 8, 4).astype(np.uint32) @ (
        np.uint32(1) << np.uint32([0, 8, 16, 24]))


def parse_text(path: str):
    """Parse a DBoW2 text vocabulary.  Returns (k, L, parents, is_leaf,
    desc_bytes [n,32] uint8, weights [n])."""
    with open(path, "r") as f:
        header = f.readline().split()
        k, L = int(header[0]), int(header[1])
        parents: List[int] = []
        leaf: List[int] = []
        weights: List[float] = []
        descs: List[List[int]] = []
        for line in f:
            t = line.split()
            if len(t) < 35:
                continue
            parents.append(int(t[0]))
            leaf.append(int(t[1]))
            descs.append([int(x) for x in t[2:34]])
            weights.append(float(t[34]))
    return (k, L, np.asarray(parents, np.int64),
            np.asarray(leaf, bool),
            np.asarray(descs, np.uint8),
            np.asarray(weights, np.float32))


def parse_binary(path: str):
    """Parse a DBoW2 binary vocabulary (saveToBinaryFile layout:
    TemplatedVocabulary.h:1478-1532 — header of nb_nodes/size_node/k/L/
    scoring/weighting, then per node: int32 parent, 32 descriptor bytes,
    float32 weight, bool is_leaf)."""
    with open(path, "rb") as f:
        nb_nodes, size_node, k, L, _scoring, _weighting = struct.unpack(
            "<IIiiii", f.read(24))
        raw = f.read(nb_nodes * size_node)
    assert size_node == 4 + 32 + 4 + 1, size_node
    rec = np.frombuffer(raw[:nb_nodes * size_node], dtype=np.uint8)
    rec = rec.reshape(nb_nodes, size_node)
    parents = rec[:, 0:4].copy().view(np.int32)[:, 0].astype(np.int64)
    descs = rec[:, 4:36].copy()
    weights = rec[:, 36:40].copy().view(np.float32)[:, 0]
    leaf = rec[:, 40] != 0
    return k, L, parents, leaf, descs, weights


def build_vocabulary(k: int, L: int, parents: np.ndarray,
                     is_leaf: np.ndarray, desc_bytes: np.ndarray,
                     weights: np.ndarray,
                     direct_level: int = 2, device=None) -> Vocabulary:
    """Densify a ragged DBoW2 node list into the flattened per-level
    Vocabulary layout (see module docstring) on `device` (None: the current
    CUDA device)."""
    device = resolve_device(device)
    n = len(parents)
    packed = _pack_desc(desc_bytes)          # [n, 8] uint32
    # children in file order; node ids here are 1-based in the file's
    # numbering (node 0 is the implicit root), parents index that numbering
    children: List[List[int]] = [[] for _ in range(n + 1)]
    for i in range(n):
        children[int(parents[i])].append(i + 1)
    # word ids: leaves in file order
    word_of_node = np.full(n + 1, -1, np.int64)
    wid = 0
    for i in range(n):
        if is_leaf[i]:
            word_of_node[i + 1] = wid
            wid += 1
    n_words = wid
    idf = np.zeros(n_words, np.float32)
    for i in range(n):
        w = word_of_node[i + 1]
        if w >= 0:
            idf[w] = weights[i]

    def desc_of(node_id: int) -> np.ndarray:
        return packed[node_id - 1] if node_id > 0 else np.zeros(8, np.uint32)

    levels: List[np.ndarray] = []
    # slot state at current level: (node_id, is_live) — node_id < 0 means
    # a propagated leaf/dead branch carrying word id ~node_id
    slots: List[Tuple[int, int]] = [(0, -1)]   # root: live interior
    for level in range(L):
        width = k ** (level + 1)
        cents = np.zeros((width, 8), np.uint32)
        nxt: List[Tuple[int, int]] = []
        for s, (nid, wcarry) in enumerate(slots):
            live_interior = nid > 0 or (nid == 0 and level == 0)
            if not live_interior:
                # dead/propagated branch: child 0 carries on, rest dead
                base = levels[level - 1][s] if level > 0 else \
                    np.zeros(8, np.uint32)
                for j in range(k):
                    cents[s * k + j] = base
                    nxt.append((-1, wcarry if j == 0 else -1))
                continue
            kids = children[nid]
            pad = desc_of(kids[0]) if kids else desc_of(nid)
            for j in range(k):
                if j < len(kids):
                    c = kids[j]
                    cents[s * k + j] = desc_of(c)
                    w = int(word_of_node[c])
                    if is_leaf[c - 1]:
                        nxt.append((-1, w))     # leaf: propagate word
                    else:
                        nxt.append((c, -1))     # live interior
                else:
                    # pad with a REAL child's centroid: a pad can then at
                    # worst TIE with that child, and argmin resolves ties
                    # to the lowest index — the real child (padding with
                    # the parent's own centroid could strictly win and
                    # leak the walk out of the real tree)
                    cents[s * k + j] = pad
                    nxt.append((-1, -1))
        levels.append(cents)
        slots = nxt
    word_map = np.asarray([w for (_nid, w) in slots], np.int64)
    # unreachable slots map to word 0 (they can never win the argmin walk
    # when a real sibling exists; mapping them keeps gathers in-bounds)
    word_map = np.where(word_map >= 0, word_map, 0).astype(np.int64)
    return Vocabulary(
        branching=k, depth=L,
        centroids=tuple(torch.as_tensor(c.view(np.int32), device=device)
                        for c in levels),
        idf=torch.as_tensor(idf, device=device), direct_level=direct_level,
        word_map=torch.as_tensor(word_map, device=device),
        n_words_leaves=n_words)


def load_orbvoc(path: str, direct_level: int = 2, device=None) -> Vocabulary:
    """Load an ORBvoc .txt or .bin vocabulary file onto `device` (None: the
    current CUDA device)."""
    if path.endswith((".bin", ".voc")):
        parsed = parse_binary(path)
    else:
        parsed = parse_text(path)
    return build_vocabulary(*parsed, direct_level=direct_level,
                            device=device)
