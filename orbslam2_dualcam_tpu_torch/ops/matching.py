"""Descriptor matching as dense tensor algebra.

Port of orbslam2_dualcam_tpu/ops/matching.py: one masked Hamming-distance
matrix, then top-2 selection, Lowe ratio, absolute threshold and a
one-row-per-column de-duplication.  Each search variant of the reference
matcher is a different mask on the same computation.  Every function
accepts leading batch axes.
"""

from __future__ import annotations

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


def match_masked(desc_a: torch.Tensor, desc_b: torch.Tensor,
                 allow: Optional[torch.Tensor] = None,
                 valid_a: Optional[torch.Tensor] = None,
                 valid_b: Optional[torch.Tensor] = None,
                 max_dist=50.0, ratio=1.0) -> MatchResult:
    """Masked Hamming top-2 with ratio and threshold tests.

    allow: optional bool [..., N, M], which pairs may match.
    ratio: Lowe ratio on best vs second-best within the allowed set;
      ratio >= 1 disables it.  max_dist may be a 0-d tensor; ratio is a
      Python float.

    Top-2 follows `lax.top_k`'s order: smaller distance first, and on
    equal distances the lower column first.  Distances are integers in
    [0, 256] (masked pairs read 257), so distance * M + column is a unique
    int64 key and the order is explicit."""
    D = hamming_matrix(desc_a, desc_b)
    mask = torch.ones(D.shape, dtype=torch.bool, device=D.device)
    if allow is not None:
        mask = mask & allow
    if valid_a is not None:
        mask = mask & valid_a[..., :, None]
    if valid_b is not None:
        mask = mask & valid_b[..., None, :]
    M = D.shape[-1]
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
    idx = torch.where(ok, best, torch.full_like(best, -1))
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


def level_mask(level_a: torch.Tensor, level_b: torch.Tensor,
               lo: int = -1, hi: int = 1) -> torch.Tensor:
    """Pyramid-level agreement window (SearchByProjection checks the
    predicted octave +-1)."""
    d = level_b[..., None, :] - level_a[..., :, None]
    return (d >= lo) & (d <= hi)
