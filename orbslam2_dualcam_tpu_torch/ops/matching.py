"""Descriptor matching as dense tensor algebra.

Port of orbslam2_dualcam_tpu/ops/matching.py: one masked Hamming-distance
matrix, then top-2 selection, Lowe ratio, absolute threshold, the
optional mutual-best and rotation-consistency tests and a
one-row-per-column de-duplication.  Each search variant of the reference
matcher is a different mask on the same computation (window, level,
vocabulary-node and epipolar masks).  Every function
accepts leading batch axes.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

INF = 1e9


def unpack_bits(desc: torch.Tensor) -> torch.Tensor:
    """[..., 8] int32 packed descriptors -> float32 bits [..., 256] (0/1),
    bit b of word w at position 32 w + b."""
    shifts = torch.arange(32, device=desc.device, dtype=torch.int32)
    bits = (desc[..., :, None] >> shifts) & 1
    return bits.reshape(*desc.shape[:-1], desc.shape[-1] * 32).to(torch.float32)


def hamming_matrix(desc_a: torch.Tensor, desc_b: torch.Tensor) -> torch.Tensor:
    """Dense Hamming distances [..., N, M] from packed [..., N, 8] and
    [..., M, 8] descriptors, as popcount(a) + popcount(b) - 2 a.b over 0/1
    bits: a float32 matrix product whose integer results (<= 256) are
    exact."""
    A = unpack_bits(desc_a)
    B = unpack_bits(desc_b)
    dots = torch.matmul(A, B.transpose(-1, -2))
    na = A.sum(-1, keepdim=True)
    nb = B.sum(-1, keepdim=True)
    return na + nb.transpose(-1, -2) - 2.0 * dots


class MatchResult(NamedTuple):
    """Per-row (query) match into the column (train) set."""

    idx: torch.Tensor    # [N] int64 best column, -1 if unmatched
    dist: torch.Tensor   # [N] float32 best Hamming distance (INF if unmatched)


def _rotation_consistency(angle_a: torch.Tensor, angle_b: torch.Tensor,
                          idx: torch.Tensor, histo_length: int) -> torch.Tensor:
    """ORBmatcher::ComputeThreeMaxima (ORBmatcher.cc:1986-2013): bin the
    per-match angle difference into `histo_length` bins, keep matches in
    the 3 most-populated bins.  angle_a, idx [..., N], angle_b [..., M];
    returns the keep mask aligned with idx."""
    matched = idx >= 0
    two_pi = 2.0 * math.pi
    d = torch.remainder(angle_a - torch.gather(angle_b, -1, idx.clamp(min=0)),
                        two_pi)
    bins = torch.clamp((d * histo_length / two_pi).to(torch.int64), 0,
                       histo_length - 1)
    counts = torch.zeros((*idx.shape[:-1], histo_length), dtype=torch.int64,
                         device=idx.device).scatter_add_(
        -1, bins, matched.to(torch.int64))
    top3 = torch.sort(counts, dim=-1).values[..., -3:]
    v1, v2, v3 = top3[..., 2], top3[..., 1], top3[..., 0]
    # drop 2nd/3rd maxima below 0.1*max (ORBmatcher.cc:2002-2010)
    min_keep = torch.where(v3 >= 0.1 * v1, v3,
                           torch.where(v2 >= 0.1 * v1, v2, v1))
    keep_bin = counts >= min_keep.clamp(min=1)[..., None]
    return matched & torch.gather(keep_bin, -1, bins)


def match_masked(desc_a: torch.Tensor, desc_b: torch.Tensor,
                 allow: Optional[torch.Tensor] = None,
                 valid_a: Optional[torch.Tensor] = None,
                 valid_b: Optional[torch.Tensor] = None,
                 max_dist=50.0, ratio=1.0,
                 angle_a: Optional[torch.Tensor] = None,
                 angle_b: Optional[torch.Tensor] = None,
                 histo_length: int = 30,
                 mutual: bool = False,
                 dist_matrix: Optional[torch.Tensor] = None) -> MatchResult:
    """The universal matcher: masked Hamming top-2 with ratio, threshold
    and rotation tests.

    allow: optional bool [..., N, M], which pairs may match.
    ratio: Lowe ratio on best vs second-best within the allowed set;
      ratio >= 1 disables it.  max_dist may be a 0-d tensor; ratio is a
      Python float.
    angle_a, angle_b: keypoint angles [..., N] and [..., M]; with both
      given, matches outside the 3 fullest of `histo_length` bins of the
      angle difference are dropped.
    mutual: additionally require a to be b's best (the bidirectional check
      of SearchForInitialization, ORBmatcher.cc:1117+).
    dist_matrix: precomputed hamming_matrix(desc_a, desc_b), to share it
      between several variant calls on the same frame pair.

    Top-2 follows `lax.top_k`'s order: smaller distance first, and on
    equal distances the lower column first; the mutual check follows
    `argmin`'s: the lower row first.  Distances are integers in [0, 256]
    (masked pairs read 257), so distance * M + column (or * N + row) is a
    unique int64 key and the order is explicit."""
    D = hamming_matrix(desc_a, desc_b) if dist_matrix is None else dist_matrix
    mask = torch.ones(D.shape, dtype=torch.bool, device=D.device)
    if allow is not None:
        mask = mask & allow
    if valid_a is not None:
        mask = mask & valid_a[..., :, None]
    if valid_b is not None:
        mask = mask & valid_b[..., None, :]
    N, M = D.shape[-2:]
    cols = torch.arange(M, device=D.device)
    code = torch.where(mask, D.to(torch.int64), torch.full_like(cols, 257))
    if M >= 2:
        top = torch.topk(code * M + cols, 2, dim=-1, largest=False).values
        best = top[..., 0] % M
        dd = top // M
        d1 = torch.where(dd[..., 0] == 257, INF, dd[..., 0].to(torch.float32))
        d2 = torch.where(dd[..., 1] == 257, INF, dd[..., 1].to(torch.float32))
    else:
        best = torch.zeros(D.shape[:-1], dtype=torch.int64, device=D.device)
        d1 = torch.where(mask[..., 0], D[..., 0], INF)
        d2 = torch.full_like(d1, INF)

    ok = d1 <= max_dist
    if ratio < 1.0:
        ok = ok & (d1 < ratio * d2)
    if mutual:
        rows = torch.arange(N, device=D.device)
        col_best = (code * N + rows[:, None]).amin(dim=-2) % N     # [..., M]
        ok = ok & (torch.gather(col_best, -1, best) == rows)
    idx = torch.where(ok, best, torch.full_like(best, -1))

    if angle_a is not None and angle_b is not None:
        keep = _rotation_consistency(angle_a, angle_b, idx, histo_length)
        idx = torch.where(keep, idx, torch.full_like(idx, -1))

    # resolve duplicate column assignments: keep the lowest-distance row
    idx = _dedup_columns(idx, d1, M)
    return MatchResult(idx=idx, dist=torch.where(idx >= 0, d1, INF))


def _dedup_columns(idx: torch.Tensor, dist: torch.Tensor, m: int) -> torch.Tensor:
    """Keep only the best row per claimed column: scatter-min of the
    distance, then of the row index among the rows at that minimum (the
    first row wins ties).  Unmatched rows park in a scratch column m."""
    matched = idx >= 0
    safe = torch.where(matched, idx, torch.full_like(idx, m))
    lead = safe.shape[:-1]
    best_per_col = torch.full((*lead, m + 1), INF, device=idx.device).scatter_reduce(
        -1, safe, torch.where(matched, dist, INF), "amin", include_self=True)
    n = idx.shape[-1]
    rows = torch.arange(n, device=idx.device).expand_as(idx)
    is_best = matched & (dist <= torch.gather(best_per_col, -1, safe))
    first_row = torch.full((*lead, m + 1), n, dtype=torch.int64,
                           device=idx.device).scatter_reduce(
        -1, safe, torch.where(is_best, rows, n), "amin", include_self=True)
    win = is_best & (torch.gather(first_row, -1, safe) == rows)
    return torch.where(win, idx, torch.full_like(idx, -1))


# ---------------------------------------------------------------------------
# variant masks
# ---------------------------------------------------------------------------

def window_mask(uv_a: torch.Tensor, uv_b: torch.Tensor, radius) -> torch.Tensor:
    """[..., N, M] pairs within a Chebyshev pixel window (GetFeaturesInArea
    semantics). radius may be a scalar or per-row [..., N]."""
    d = (uv_a[..., :, None, :] - uv_b[..., None, :, :]).abs()
    r = torch.as_tensor(radius, device=uv_a.device)
    if r.dim() >= 1:
        r = r[..., None]
    return (d[..., 0] <= r) & (d[..., 1] <= r)


def node_mask(nodes_a: torch.Tensor, nodes_b: torch.Tensor) -> torch.Tensor:
    """[..., N, M] same-vocabulary-node pairs (FeatureVector alignment,
    ORBmatcher.cc:181-276)."""
    return nodes_a[..., :, None] == nodes_b[..., None, :]


def level_mask(level_a: torch.Tensor, level_b: torch.Tensor,
               lo: int = -1, hi: int = 1) -> torch.Tensor:
    """Pyramid-level agreement window (SearchByProjection checks the
    predicted octave +-1)."""
    d = level_b[..., None, :] - level_a[..., :, None]
    return (d >= lo) & (d <= hi)


def epipolar_mask(F12: torch.Tensor, uv1: torch.Tensor, uv2: torch.Tensor,
                  sigma2_2: torch.Tensor, epipole1_in_2: torch.Tensor,
                  min_epipole_dist2, chi2: float = 3.84) -> torch.Tensor:
    """SearchForTriangulation gate (ORBmatcher.cc:1253-1427): a candidate
    in image 2 must lie near the epipolar line of uv1 and away from the
    epipole.  F12 [3, 3], uv1 [N, 2], uv2 [M, 2], sigma2_2 [M] -> [N, M]."""
    x1 = torch.cat([uv1, torch.ones_like(uv1[..., :1])], dim=-1)
    line = x1 @ F12                                   # [N, 3]
    num = (line[:, None, 0] * uv2[None, :, 0] +
           line[:, None, 1] * uv2[None, :, 1] + line[:, None, 2])
    den = line[:, 0] ** 2 + line[:, 1] ** 2
    d2 = num * num / torch.where(den > 1e-12, den,
                                 torch.full_like(den, 1e-12))[:, None]
    near_line = d2 < chi2 * sigma2_2[None, :]
    far_from_epipole = ((uv2 - epipole1_in_2) ** 2).sum(-1) > min_epipole_dist2
    return near_line & far_from_epipole[None, :]
