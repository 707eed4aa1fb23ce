"""ORB feature extraction in torch.

Port of orbslam2_dualcam_tpu/ops/orb.py, following the reference's CPU
branch on every device: the pyramid and the 7-tap blur are banded matrix
products against host-built tables, dense FAST + NMS is kernel K1
(ops/fast_nms.py, one launch for the whole pyramid), keypoints are picked
by the tiered cell-winner top-k, and the sparse phase reads exact patches
around each keypoint for the sub-pixel fit, the intensity-centroid angle
and the 30-bin steered BRIEF.

Cameras are a leading batch axis throughout: images [ncam, H, W] ->
Features with leading ncam.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from orbslam2_dualcam_tpu_torch.utils.config import OrbConfig
from orbslam2_dualcam_tpu_torch.ops.fast_nms import (  # noqa: F401
    NMS_BONUS, fast_nms_levels, fast_scores2, nms3x3)
from orbslam2_dualcam_tpu_torch.ops.orb_tables import (
    _blur_matrix, _level_budget, _resize_matrix, _steered_sampling_indices,
    ic_angle_masks)

N_BINS = 30          # steering-angle bins of the BRIEF pattern
BRIEF_RADIUS = 19    # radius of the blurred patch the steered samples reach


class Features(NamedTuple):
    """Fixed-size feature set for one image, or [ncam, ...] for a rig
    frame; `valid` masks padding slots."""

    uv: torch.Tensor        # [N, 2] undistorted pixel coords (x, y), level-0 scale
    uv_raw: torch.Tensor    # [N, 2] distorted/raw pixel coords
    level: torch.Tensor     # [N] int64 pyramid level
    angle: torch.Tensor     # [N] float32 radians
    response: torch.Tensor  # [N] float32 FAST score
    desc: torch.Tensor      # [N, 8] int32 words with the bits of the
    #                         reference's uint32 packed 256-bit BRIEF
    valid: torch.Tensor     # [N] bool


class _Tables(NamedTuple):
    """Device copies of the host tables one extraction shape needs."""

    resize: tuple          # per level l >= 1: (R_h [h, hp], R_w^T [wp, w])
    blur: tuple            # per level: (B_h [h, h], B_w^T [w, w])
    ic_xs: torch.Tensor    # [P, P] intensity-centroid x weights
    ic_ys: torch.Tensor
    sampling: torch.Tensor  # [N_BINS, 512] int64 steered sample indices
    scales: torch.Tensor   # [n_levels] f32 level scale factors


@functools.lru_cache(maxsize=8)
def _tables(H: int, W: int, cfg: OrbConfig, device: torch.device) -> _Tables:
    def dev(a, dtype=torch.float32):
        return torch.as_tensor(a, dtype=dtype, device=device)

    shapes = level_shapes(H, W, cfg.n_levels, cfg.scale_factor)
    resize = tuple((dev(_resize_matrix(hp, h)), dev(_resize_matrix(wp, w).T))
                   for (hp, wp), (h, w) in zip(shapes[:-1], shapes[1:]))
    blur = tuple((dev(_blur_matrix(h)), dev(_blur_matrix(w).T))
                 for h, w in shapes)
    xs, ys, _ = ic_angle_masks((cfg.patch_size - 1) // 2)
    seed = -1 if cfg.brief_learned else cfg.brief_seed
    return _Tables(resize=resize, blur=blur, ic_xs=dev(xs), ic_ys=dev(ys),
                   sampling=dev(_steered_sampling_indices(seed, cfg.patch_size),
                                torch.int64),
                   scales=dev(cfg.scale_factors))


def level_shapes(H: int, W: int, n_levels: int,
                 scale: float) -> list[tuple[int, int]]:
    """(Hl, Wl) of every pyramid level: int(round(H / scale**l))."""
    return [(H, W)] + [(int(round(H / scale ** l)), int(round(W / scale ** l)))
                       for l in range(1, n_levels)]


# ---------------------------------------------------------------------------
# spatially-uniform top-k selection (quad-tree replacement)
# ---------------------------------------------------------------------------

def select_keypoints(score: torch.Tensor, n_keep: int, cell: int = 30,
                     border: int = 16):
    """Pick <= n_keep spatially-distributed maxima from dense score maps
    [..., H, W]: every grid cell's best corner gets a tiered priority bonus
    (cells of `cell`, cell/2 and max(cell/4, 4) px), then one top-k takes
    the budget.

    The order is the reference's `lax.top_k` order made explicit: larger
    key first, and on equal keys the lower flat index first.  The key's
    float bits (non-negative, so ordered like the floats) and the reversed
    flat index form one unique int64, so torch.topk has no ties to break.

    Returns (yx int64 [..., n_keep, 2], score [..., n_keep]); invalid slots
    have score 0."""
    H, W = score.shape[-2:]
    dev = score.device
    iy = torch.arange(H, device=dev)[:, None]
    ix = torch.arange(W, device=dev)[None, :]
    inb = (iy >= border) & (iy < H - border) & (ix >= border) & (ix < W - border)
    score = torch.where(inb, score, torch.zeros_like(score))

    def cell_best(c):
        pad_h, pad_w = (-H) % c, (-W) % c
        sp = F.pad(score, (0, pad_w, 0, pad_h), value=-1.0)
        cm = F.max_pool2d(sp.reshape(-1, 1, H + pad_h, W + pad_w), c, stride=c)
        cm = cm.repeat_interleave(c, -2).repeat_interleave(c, -1)
        cm = cm.reshape(*score.shape[:-2], H + pad_h, W + pad_w)[..., :H, :W]
        return ((score >= cm) & (score > 0.0)).to(score.dtype)

    bonus = (4e7 * cell_best(cell) + 2e7 * cell_best(cell // 2) +
             1e7 * cell_best(max(cell // 4, 4)))
    valid = score > 0.0
    key = torch.where(valid, score + bonus, torch.zeros_like(score))
    flat_valid = valid.flatten(-2)
    bits = key.flatten(-2).view(torch.int32).to(torch.int64)
    n = H * W
    shift = n.bit_length()
    rev = (1 << shift) - 1 - torch.arange(n, device=dev)
    ukey = (torch.where(flat_valid, bits, torch.zeros_like(bits)) << shift) | rev
    top = torch.topk(ukey, n_keep, dim=-1).indices
    ksc = torch.gather(score.flatten(-2), -1, top)
    ksc = torch.where(torch.gather(flat_valid, -1, top), ksc,
                      torch.zeros_like(ksc))
    return torch.stack([top // W, top % W], dim=-1), ksc


# ---------------------------------------------------------------------------
# sparse phase: patches, sub-pixel, orientation, BRIEF
# ---------------------------------------------------------------------------

def _gather_patches(img: torch.Tensor, yx: torch.Tensor,
                    radius: int) -> torch.Tensor:
    """(2r+1)^2 patches around integer keypoints: img [B, H, W], yx
    [B, N, 2] -> [B, N, 2r+1, 2r+1].  Out-of-bounds reads clamp to the
    edge."""
    B = img.shape[0]
    p = F.pad(img[:, None], (radius,) * 4, mode="replicate")[:, 0]
    ar = torch.arange(2 * radius + 1, device=img.device)
    rows = yx[..., 0, None] + ar                       # [B, N, P] padded rows
    cols = yx[..., 1, None] + ar
    b = torch.arange(B, device=img.device)[:, None, None, None]
    return p[b, rows[..., :, None], cols[..., None, :]]


def _subpixel_from_patches(p: torch.Tensor) -> torch.Tensor:
    """Closed-form 2-D quadratic peak fit on [..., 3, 3] neighbourhoods;
    returns [..., 2] (dy, dx) clipped to +-0.6, 0 where the fit is not a
    genuine interior maximum."""
    gy = 0.5 * (p[..., 2, 1] - p[..., 0, 1])
    gx = 0.5 * (p[..., 1, 2] - p[..., 1, 0])
    hyy = p[..., 2, 1] - 2.0 * p[..., 1, 1] + p[..., 0, 1]
    hxx = p[..., 1, 2] - 2.0 * p[..., 1, 1] + p[..., 1, 0]
    hxy = 0.25 * (p[..., 2, 2] - p[..., 2, 0] - p[..., 0, 2] + p[..., 0, 0])
    det = hxx * hyy - hxy * hxy
    safe = torch.where(det.abs() > 1e-9, det, torch.ones_like(det))
    dy = -(hxx * gy - hxy * gx) / safe
    dx = -(hyy * gx - hxy * gy) / safe
    ok = (hxx < 0) & (hyy < 0) & (det > 1e-9)
    off = torch.clamp(torch.stack([dy, dx], dim=-1), -0.6, 0.6)
    return torch.where(ok[..., None], off, torch.zeros_like(off))


def _ic_from_patches(patches: torch.Tensor, xs: torch.Tensor,
                     ys: torch.Tensor) -> torch.Tensor:
    """Intensity-centroid angle from [..., P, P] patches."""
    m10 = (patches * xs).sum(dim=(-2, -1))
    m01 = (patches * ys).sum(dim=(-2, -1))
    return torch.atan2(m01, m10)


def _brief_from_patches(patches: torch.Tensor, angles: torch.Tensor,
                        sampling: torch.Tensor) -> torch.Tensor:
    """Steered BRIEF-256 from blurred [..., N, 39, 39] patches.

    Each keypoint's angle picks one of 30 bins; the bin's row of the
    sampling table holds its 512 flattened-patch sample positions (all
    first test points, then all second ones).  The reference selected them
    with a one-hot matmul over all 30 bins, an exact copy made for the
    TPU's matrix unit; here each keypoint gathers its own row directly.
    Returns [..., N, 8] int32 words with the reference's uint32 bits."""
    two_pi = 2.0 * math.pi
    bins = torch.round(torch.remainder(angles, two_pi) / two_pi * N_BINS)
    bins = bins.to(torch.int64) % N_BINS
    flat = patches.flatten(-2)
    vals = torch.gather(flat, -1, sampling[bins])        # [..., N, 512]
    n_bits = vals.shape[-1] // 2
    bits = (vals[..., :n_bits] < vals[..., n_bits:]).to(torch.int64)
    bits = bits.reshape(*bits.shape[:-1], n_bits // 32, 32)
    weights = 1 << torch.arange(32, device=bits.device, dtype=torch.int64)
    words = (bits * weights).sum(-1)
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32)


# ---------------------------------------------------------------------------
# full extractor
# ---------------------------------------------------------------------------

def gaussian_blur7(img: torch.Tensor, Bh: torch.Tensor,
                   BwT: torch.Tensor) -> torch.Tensor:
    """Separable 7x7 Gaussian blur (sigma 2, edge clamp) of img [..., H, W]
    as two banded matrix products with the host-built _blur_matrix."""
    return torch.matmul(torch.matmul(Bh, img), BwT)


def build_pyramid(img: torch.Tensor, resize: tuple) -> list[torch.Tensor]:
    """Levels [..., Hl, Wl]: each one the previous level resized as two
    banded matrix products (R_h @ img @ R_w^T) with the host-built
    antialiased bilinear _resize_matrix."""
    pyr = [img]
    for Rh, RwT in resize:
        pyr.append(torch.matmul(torch.matmul(Rh, pyr[-1]), RwT))
    return pyr


def extract_orb_rig(images: torch.Tensor, cfg: OrbConfig,
                    n_out: int) -> Features:
    """Up to n_out ORB features per camera from images [ncam, H, W] float32
    in [0, 255]; fixed output shapes [ncam, n_out, ...]."""
    # K1's wrapper runs its plain version only for CPU tensors; on the card
    # it always launches the kernel, so the unfused path is not offered there
    if images.is_cuda and not cfg.pallas_fast:
        raise ValueError("extract_orb_rig: OrbConfig.pallas_fast=False is not "
                         "supported on CUDA tensors (K1 always runs there)")
    ncam, H, W = images.shape
    dev = images.device
    tb = _tables(H, W, cfg, dev)
    budgets = _level_budget(n_out, cfg.n_levels, cfg.scale_factor)
    pyr = build_pyramid(images, tb.resize)
    ic_radius = (cfg.patch_size - 1) // 2
    th_hi, th_lo = float(cfg.ini_th_fast), float(cfg.min_th_fast)

    # high-threshold corners preferred, low-threshold fill-in: K1, one
    # launch over every level that has a budget
    used = [l for l, budget in enumerate(budgets) if budget > 0]
    scores = dict(zip(used, fast_nms_levels(
        [pyr[l].contiguous() for l in used], th_hi, th_lo)))

    yxs, lvls, resps, offs, angs, descs = [], [], [], [], [], []
    for l in used:
        im, budget = pyr[l], budgets[l]
        s, sad_lo = scores[l]
        yx, sc = select_keypoints(s, budget, cell=cfg.cell_size,
                                  border=cfg.edge_threshold)
        yxs.append(yx)
        lvls.append(torch.full((ncam, budget), l, dtype=torch.int64,
                               device=dev))
        resps.append(torch.where(sc > NMS_BONUS, sc - NMS_BONUS, sc))
        # quadratic sub-pixel refinement on the dense (arc-ungated) SAD
        offs.append(_subpixel_from_patches(_gather_patches(sad_lo, yx, 1)))
        ang = _ic_from_patches(_gather_patches(im, yx, ic_radius),
                               tb.ic_xs, tb.ic_ys)
        angs.append(ang)
        blurred = gaussian_blur7(im, *tb.blur[l])
        descs.append(_brief_from_patches(
            _gather_patches(blurred, yx, BRIEF_RADIUS), ang, tb.sampling))

    yx = torch.cat(yxs, dim=1)                         # [ncam, N, 2] level-local
    lvl = torch.cat(lvls, dim=1)
    resp = torch.cat(resps, dim=1)
    # pixel-center convention of the resize: x0 = (xl + 0.5) * s - 0.5
    scales = tb.scales[lvl]
    yx_f = yx.to(torch.float32) + torch.cat(offs, dim=1)
    uv = (yx_f.flip(-1) + 0.5) * scales[..., None] - 0.5
    return Features(uv=uv, uv_raw=uv, level=lvl, angle=torch.cat(angs, dim=1),
                    response=resp, desc=torch.cat(descs, dim=1),
                    valid=resp > 0)


def extract_orb(img: torch.Tensor, cfg: OrbConfig, n_out: int) -> Features:
    """Up to n_out ORB features from one grayscale image (H, W)."""
    f = extract_orb_rig(img[None], cfg, n_out)
    return Features(*(x[0] for x in f))
