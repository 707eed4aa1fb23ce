"""Kernel K1: fused dense FAST-9/16 (two thresholds) + blend + 3x3 NMS.

Replaces the TPU kernel orbslam2_dualcam_tpu/ops/pallas_kernels.py
(`fast_nms_pallas`).  On the card, `fast_nms` launches the hand-written
CUDA kernel in csrc/fast_nms.cu; for a tensor on the CPU it runs the plain
torch version, `fast_nms_reference` (= the reference's `fast_scores2` +
blend + `nms3x3`, orb.py:625-629).  A CUDA tensor never takes the plain
version: the kernel launches or the wrapper raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from orbslam2_dualcam_tpu_torch import _build
from orbslam2_dualcam_tpu_torch.ops.orb_tables import FAST_OFFSETS

NMS_BONUS = 1e4    # high-threshold preference bonus (orb.py:629)


# ---------------------------------------------------------------------------
# plain torch version
# ---------------------------------------------------------------------------

def _circle_views(img: torch.Tensor) -> list[torch.Tensor]:
    """The 16 circle-shifted copies of img [..., H, W]: out[k][..., y, x] =
    img[..., y + dy_k, x + dx_k], zero outside the image."""
    pad = 3
    H, W = img.shape[-2:]
    p = F.pad(img, (pad, pad, pad, pad))
    return [p[..., pad + int(dy): pad + int(dy) + H,
              pad + int(dx): pad + int(dx) + W] for dx, dy in FAST_OFFSETS]


def _arc_mask(flags: list[torch.Tensor]) -> torch.Tensor:
    """Cyclic run-of->=9 test on a 16-bit ring, bit-parallel per pixel:
    pack the ring into one int32 per pixel and AND it with 8 successive
    cyclic rotations; a bit survives iff it starts a run of 9."""
    m = torch.zeros(flags[0].shape, dtype=torch.int32, device=flags[0].device)
    for k, f in enumerate(flags):
        m = m | (f.to(torch.int32) << k)
    x = m
    for _ in range(8):
        x = x & (((x >> 1) | (x << 15)) & 0xFFFF)
    return x > 0


def fast_scores2(img: torch.Tensor, th_hi: float, th_lo: float):
    """Dense FAST-9/16 corner responses at two thresholds in one pass over
    img [..., H, W] f32.  Returns (score_hi, score_lo, sad_lo), where
    sad_lo is the ungated thresholded-SAD surface at th_lo (the sub-pixel
    fit's input).  The SADs are summed over the circle in order k = 0..15,
    the order of the TPU kernel and of csrc/fast_nms.cu."""
    d = [c - img for c in _circle_views(img)]

    def score_at(t):
        is_b = _arc_mask([dk > t for dk in d])
        is_d = _arc_mask([dk < -t for dk in d])
        sb = torch.zeros_like(img)
        sd = torch.zeros_like(img)
        for dk in d:
            sb = sb + torch.clamp(dk - t, min=0.0)
            sd = sd + torch.clamp(-dk - t, min=0.0)
        zero = torch.zeros_like(img)
        return (torch.where(is_b, sb, zero) + torch.where(is_d, sd, zero),
                sb + sd)

    s_hi, _ = score_at(th_hi)
    s_lo, sad_lo = score_at(th_lo)
    return s_hi, s_lo, sad_lo


def nms3x3(score: torch.Tensor) -> torch.Tensor:
    """Keep only local maxima (>= the 3x3 neighbourhood max, -inf outside
    the image) of score [..., H, W]."""
    H, W = score.shape[-2:]
    m = F.max_pool2d(score.reshape(-1, 1, H, W), 3, stride=1, padding=1)
    m = m.reshape(score.shape)
    return torch.where(score >= m, score, torch.zeros_like(score))


def fast_nms_reference(img: torch.Tensor, th_hi: float, th_lo: float):
    """Plain torch version of K1: (s_nms, sad_lo) for img [..., H, W]."""
    s_hi, s_lo, sad_lo = fast_scores2(img, th_hi, th_lo)
    return nms3x3(torch.where(s_hi > 0, s_hi + NMS_BONUS, s_lo)), sad_lo


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------

def fast_nms(img: torch.Tensor, th_hi: float, th_lo: float):
    """Fused FAST(th_hi, th_lo) + blend + 3x3 NMS over img [ncam, H, W] or
    (H, W), f32 and contiguous.  Returns (s_nms, sad_lo) of img's shape.

    CPU tensors run `fast_nms_reference`; CUDA tensors launch the kernel
    (one launch per call, counted in `fast_nms.launches`) or raise."""
    if img.device.type == "cpu":
        return fast_nms_reference(img, th_hi, th_lo)
    if img.device.type != "cuda":
        raise ValueError(f"fast_nms: unsupported device {img.device}")
    if img.dtype != torch.float32:
        raise TypeError(f"fast_nms: expected float32, got {img.dtype}")
    if img.dim() not in (2, 3) or img.numel() == 0:
        raise ValueError(f"fast_nms: expected a non-empty [ncam, H, W] or "
                         f"(H, W) image, got shape {tuple(img.shape)}")
    if not img.is_contiguous():
        raise ValueError("fast_nms: input must be contiguous")
    x = img if img.dim() == 3 else img[None]
    ncam, H, W = x.shape
    s = torch.empty_like(x)
    sad = torch.empty_like(x)
    lib = _build.load_library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        status = lib.fast_nms_f32(x.data_ptr(), s.data_ptr(), sad.data_ptr(),
                                  ncam, H, W, float(th_hi), float(th_lo),
                                  stream)
    _build.check_status(lib, status, "fast_nms")
    fast_nms.launches += 1
    return s.view(img.shape), sad.view(img.shape)


fast_nms.launches = 0
