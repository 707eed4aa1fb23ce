"""Bag-of-binary-words vocabulary tree: host training and device quantization.

Port of orbslam2_dualcam_tpu/vocab/bow.py.  Training is the reference's
numpy code (recursive k-majority, TemplatedVocabulary::create semantics),
copied because the reference module imports jax.  Quantization descends
the flattened tree on the device: each level gathers every descriptor's k
candidate children and takes the XOR + popcount argmin.

Descriptors are [N, 8] int32 words carrying the reference's uint32 bits
(numpy ``.view(np.int32)``); torch has no popcount, so bits are counted
through a 256-entry byte table over the words viewed as uint8.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from orbslam2_dualcam_tpu_torch.utils.device import resolve_device


def _popcount64(x: np.ndarray) -> np.ndarray:
    return np.bitwise_count(x)


def hamming_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """[N,8]x[M,8] uint32 -> [N,M] int Hamming (host, for training)."""
    x = a[:, None, :] ^ b[None, :, :]
    return _popcount64(x).sum(-1).astype(np.int32)


def _kmajority(desc: np.ndarray, k: int, rng: np.random.Generator,
               iters: int = 8) -> tuple[np.ndarray, np.ndarray]:
    """Binary k-means: k-majority voting on bits. Returns (centroids [k,8],
    assign [N])."""
    n = len(desc)
    k = min(k, n)
    # k-means++ seeding with Hamming distances
    centroids = [desc[rng.integers(n)]]
    d = hamming_np(desc, np.asarray([centroids[0]]))[:, 0].astype(np.float64)
    for _ in range(1, k):
        p = d * d
        s = p.sum()
        idx = rng.integers(n) if s <= 0 else rng.choice(n, p=p / s)
        centroids.append(desc[idx])
        d = np.minimum(d, hamming_np(desc, np.asarray([centroids[-1]]))[:, 0])
    C = np.asarray(centroids)
    assign = np.zeros(n, np.int64)
    bits_lut = ((desc[:, :, None] >> np.arange(32, dtype=np.uint32)) & 1)  # [N,8,32]
    for _ in range(iters):
        D = hamming_np(desc, C)
        assign = D.argmin(1)
        newC = C.copy()
        for j in range(len(C)):
            members = bits_lut[assign == j]
            if len(members) == 0:
                continue
            maj = (members.mean(0) > 0.5).astype(np.uint32)
            newC[j] = (maj << np.arange(32, dtype=np.uint32)[None, :]).sum(1, dtype=np.uint32)
        if np.array_equal(newC, C):
            break
        C = newC
    return C, hamming_np(desc, C).argmin(1)


class Vocabulary(NamedTuple):
    """Flattened per-level tree on one device.

    centroids[l]: [k^(l+1), 8] int32 (uint32 bits): children of level-l
    nodes laid out contiguously (node n's children occupy rows
    n*k .. n*k+k-1; unused rows hold the parent centroid).
    idf: [n_words] float32 tf-idf word weights.
    word_map: optional [k^depth] int64 final-level slot -> word id."""

    branching: int
    depth: int
    centroids: tuple
    idf: torch.Tensor
    direct_level: int
    word_map: Optional[torch.Tensor] = None
    n_words_leaves: int = 0

    @property
    def n_words(self) -> int:
        return self.n_words_leaves or self.branching ** self.depth


def train_vocabulary(desc: np.ndarray, branching: int = 10, depth: int = 4,
                     seed: int = 42, direct_level: int = 2,
                     weight_docs: Optional[list[np.ndarray]] = None,
                     device=None) -> Vocabulary:
    """Train the tree by recursive k-majority on the host and place it on
    `device` (None: the current CUDA device). desc: [N, 8] uint32 training
    descriptors."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    k = branching
    levels: list[np.ndarray] = []
    # groups[i] = indices of desc assigned to node i at current level
    groups = [np.arange(len(desc))]
    for level in range(depth):
        n_nodes = k ** (level + 1)
        cents = np.zeros((n_nodes, 8), np.uint32)
        new_groups: list[np.ndarray] = []
        for node, g in enumerate(groups):
            if len(g) == 0:
                # dead branch: copy parent's centroid into all children
                parent_c = levels[level - 1][node] if level > 0 else np.zeros(8, np.uint32)
                for j in range(k):
                    cents[node * k + j] = parent_c
                    new_groups.append(np.array([], np.int64))
                continue
            C, assign = _kmajority(desc[g], k, rng)
            for j in range(k):
                cents[node * k + j] = C[j] if j < len(C) else C[len(C) - 1]
                new_groups.append(g[assign == j] if j < len(C) else
                                  np.array([], np.int64))
        levels.append(cents)
        groups = new_groups

    def build(idf):
        return Vocabulary(
            branching, depth,
            tuple(torch.as_tensor(c.view(np.int32), device=device)
                  for c in levels),
            torch.as_tensor(idf, device=device), direct_level)

    n_words = k ** depth
    # idf from training docs (or uniform): DBoW2 TF_IDF weighting
    idf = np.ones(n_words, np.float32)
    if weight_docs:
        counts = np.zeros(n_words, np.float64)
        voc_tmp = build(idf)
        for d in weight_docs:
            dt = torch.as_tensor(np.ascontiguousarray(d).view(np.int32),
                                 device=device)
            w = np.unique(quantize(voc_tmp, dt)[0].cpu().numpy())
            counts[w] += 1
        n_docs = len(weight_docs)
        idf = np.log(n_docs / np.maximum(counts, 1e-9)).astype(np.float32)
        idf[counts == 0] = 0.0
    return build(idf)


# ---------------------------------------------------------------------------
# device-side quantization
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=8)
def _byte_popcount(device: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.bitwise_count(np.arange(256, dtype=np.uint8)),
                           dtype=torch.int32, device=device)


def popcount_words(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each int32 word's 32 bits, as int32 of x's shape."""
    table = _byte_popcount(x.device)
    b = x.contiguous().view(torch.uint8).to(torch.int64)
    return table[b].reshape(*x.shape, 4).sum(-1, dtype=torch.int32)


def quantize(voc: Vocabulary, desc: torch.Tensor):
    """Quantize descriptors [N, 8] int32 down the tree.

    Returns (word [N] int64, node [N] int64) where `node` is the tree node
    id at `direct_level`.  Each level's argmin takes the first minimum,
    as jnp.argmin does: the distance and the child index form one unique
    key."""
    k = voc.branching
    n = desc.shape[0]
    ar = torch.arange(k, device=desc.device)
    node = torch.zeros(n, dtype=torch.int64, device=desc.device)
    direct = node
    for level, cents in enumerate(voc.centroids):
        cand = cents[node[:, None] * k + ar]                   # [N, k, 8]
        d = popcount_words(cand ^ desc[:, None, :]).sum(-1)    # [N, k]
        node = node * k + torch.argmin(d.to(torch.int64) * k + ar, dim=1)
        if level + 1 == voc.direct_level:
            direct = node
    word = node if voc.word_map is None else voc.word_map[node]
    return word, direct
