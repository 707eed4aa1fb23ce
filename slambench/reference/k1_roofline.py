"""Kernel K1's least time on an H100: the larger of the bytes it must move
over the card's memory rate and the operations it must do over the card's
rate for them.  A copy of chip_smoke.py's `k1_bound_ms` and its
constants, so the yardstick stays put when the program changes.

K1 is the fused dense FAST-9/16 at two thresholds, blend and 3x3
non-maximum suppression over every level of a frame's pyramid, one launch
per frame (the program's ops/fast_nms.py, csrc/fast_nms.cu).

Bytes: each pixel read once, both outputs written once (12 B/pixel).
Operations, per pixel: 16 circle differences; for each of them and each
polarity a compare, a subtract, a conditional add and a mask insert
(128); two run-of-9 tests of 4 shifts, 4 ANDs and a test (18); the low
score, the blend and sad_lo (6); 8 max, a compare and a select for the
NMS (10).  Where a low-threshold arc exists (counted from the frame), one
polarity again at the high threshold: 16 x 4, a run-of-9 test, a select
(75).  None of these fuse into multiply-adds, so the rate is one
operation per lane and clock: half of the 67 TFLOP/s float32 peak of
NVIDIA's data sheet (SXM, 700 W), which counts a multiply-add as two.
"""

from __future__ import annotations

import torch

from slambench.reference import orb

BYTES_PER_PIXEL = 12
OPS_PER_PIXEL = 16 + 128 + 18 + 6 + 10
OPS_PER_ARC = 64 + 9 + 2
H100_BYTES_PER_S = 3.35e12
H100_SIMPLE_OPS_PER_S = 67e12 / 2


def counts(levels, th_hi: float, th_lo: float) -> tuple[int, int]:
    """(pixels, pixels with a low-threshold arc) of K1's input levels."""
    n_px = sum(x.numel() for x in levels)
    n_arc = sum(int((orb.fast_scores2(x, th_hi, th_lo)[1] > 0).sum())
                for x in levels)
    return n_px, n_arc


def bound_s(n_px: int, n_arc: int) -> tuple[float, str]:
    """(least seconds, what binds: "bytes" or "operations")."""
    t_bytes = BYTES_PER_PIXEL * n_px / H100_BYTES_PER_S
    t_ops = (OPS_PER_PIXEL * n_px + OPS_PER_ARC * n_arc) / H100_SIMPLE_OPS_PER_S
    return max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops else "operations")


def frame_levels(images: torch.Tensor, p: orb.OrbParams, n_out: int):
    """K1's input for one u8 frame [ncam, H, W]: the float32 pyramid
    levels that have a feature budget, as the extractor builds them."""
    ncam, H, W = images.shape
    resize = orb._tables(H, W, p, images.device, torch.float32)[0]
    pyr = orb.build_pyramid(images.to(torch.float32), resize)
    budgets = orb.level_budget(n_out, p.n_levels, p.scale_factor)
    return [pyr[l] for l, b in enumerate(budgets) if b > 0]
