"""Host-side numpy constant tables of the ORB extractor.

Copied from orbslam2_dualcam_tpu/ops/orb.py, whose module imports jax; a
test pins every table here equal to the reference's.  Everything is
computed once on the host and uploaded by the callers.
"""

from __future__ import annotations

import functools

import numpy as np

# FAST-16 Bresenham circle of radius 3 (clockwise from 12 o'clock).
FAST_OFFSETS = np.array([
    (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
    (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
], np.int32)  # (dx, dy)


@functools.lru_cache()
def brief_pattern(seed: int, patch_size: int = 31,
                  n_bits: int = 256) -> np.ndarray:
    """(n_bits, 2, 2) int offsets (pairs of (dx, dy)): the BRIEF isotropic
    Gaussian test pattern clipped to the patch, or, for seed < 0, the ORB
    paper's published learned pattern (ops/orb_pattern.py)."""
    if seed < 0:
        from orbslam2_dualcam_tpu.ops.orb_pattern import learned_pattern
        return learned_pattern()
    rng = np.random.default_rng(seed)
    half = patch_size // 2
    sigma = patch_size / 5.0
    pts = rng.normal(0.0, sigma, size=(n_bits, 2, 2))
    pts = np.clip(np.round(pts), -half + 2, half - 2).astype(np.int32)
    # avoid degenerate identical pairs
    same = np.all(pts[:, 0] == pts[:, 1], axis=-1)
    pts[same, 1, 0] += 1
    return pts


@functools.lru_cache()
def ic_angle_masks(radius: int = 15):
    """Circular-patch coordinate grids for intensity-centroid orientation:
    (xs * mask, ys * mask, mask) as float32 [2r+1, 2r+1]."""
    ys, xs = np.mgrid[-radius:radius + 1, -radius:radius + 1]
    mask = (xs * xs + ys * ys) <= radius * radius
    return ((xs * mask).astype(np.float32), (ys * mask).astype(np.float32),
            mask.astype(np.float32))


@functools.lru_cache()
def _blur_kernel(sigma: float = 2.0, r: int = 3) -> np.ndarray:
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


@functools.lru_cache()
def _blur_matrix(n: int, sigma: float = 2.0, r: int = 3) -> np.ndarray:
    """[n, n] banded matrix applying a 1-D Gaussian with edge-clamp
    padding: out = B @ vec."""
    k = _blur_kernel(sigma, r)
    B = np.zeros((n, n), np.float32)
    for i in range(n):
        for t, w in zip(range(i - r, i + r + 1), k):
            B[i, min(max(t, 0), n - 1)] += w
    return B


@functools.lru_cache()
def _resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] bilinear-resize matrix with half-pixel centers and
    antialiasing on downscale (triangle kernel widened by the scale factor
    and weight-normalized: jax.image.resize semantics)."""
    R = np.zeros((n_out, n_in), np.float32)
    scale = n_in / n_out
    s = max(scale, 1.0)          # kernel widening for antialias
    for i in range(n_out):
        x = (i + 0.5) * scale - 0.5
        lo = int(np.floor(x - s))
        hi = int(np.ceil(x + s))
        ts = np.arange(lo, hi + 1)
        w = np.maximum(0.0, 1.0 - np.abs(ts - x) / s)
        w = w / w.sum()
        for t, wt in zip(ts, w):
            R[i, min(max(t, 0), n_in - 1)] += wt
    return R


@functools.lru_cache()
def _steered_sampling_indices(seed: int, patch_size: int = 31,
                              n_bits: int = 256, n_bins: int = 30,
                              radius: int = 19) -> np.ndarray:
    """[n_bins, 2*n_bits] int32 flattened-patch indices: row b holds the
    2*n_bits BRIEF sample positions inside a flattened (2r+1)x(2r+1) patch
    under steering angle bin b (the ORB paper's 2*pi/30 discretization).
    Column q holds pt0 of bit q and column n_bits+q its pt1."""
    pat = brief_pattern(seed, patch_size)                  # (n_bits, 2, 2)
    size = 2 * radius + 1
    px = np.concatenate([pat[:, 0, 0], pat[:, 1, 0]]).astype(np.float64)
    py = np.concatenate([pat[:, 0, 1], pat[:, 1, 1]]).astype(np.float64)
    idx = np.zeros((n_bins, 2 * n_bits), np.int32)
    for b in range(n_bins):
        a = 2.0 * np.pi * b / n_bins
        ca, sa = np.cos(a), np.sin(a)
        rx = np.clip(np.round(px * ca - py * sa), -radius, radius)
        ry = np.clip(np.round(px * sa + py * ca), -radius, radius)
        idx[b] = ((ry + radius) * size + (rx + radius)).astype(np.int32)
    return idx


def _level_budget(n_total: int, n_levels: int, scale: float) -> list[int]:
    """Per-level feature budget, geometric in 1/scale (ORBextractor ctor
    logic, ORBextractor.cc:68-90)."""
    inv = 1.0 / scale
    w = np.array([inv ** i for i in range(n_levels)])
    w = w / w.sum()
    out = np.floor(w * n_total).astype(int)
    out[0] += n_total - out.sum()
    return out.tolist()
