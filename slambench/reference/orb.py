"""Plain ORB extraction: the benchmark's reference for what the program
extracts from a frame.

A frozen copy of the plain path of the port's extractor
(ops/orb.py `extract_orb_rig`, ops/fast_nms.py `fast_nms_reference`,
ops/orb_tables.py, ops/camera.py `undistort`, and frontend.py's keypoint
undistortion): an 8-level pyramid and a 7-tap blur as banded matrix
products, dense FAST-9/16 at two thresholds with the high-threshold bonus
and a 3x3 non-maximum suppression in plain torch, the tiered cell-winner
top-k, the quadratic sub-pixel fit, the intensity-centroid angle and the
30-bin steered BRIEF, then undistortion of the keypoints.  It imports
nothing of the program.

`dtype` is the floating type of the image arithmetic: float32 is the
reference; bfloat16 is the control, the reference one precision lower.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

NMS_BONUS = 1e4
N_BINS = 30
BRIEF_RADIUS = 19
FAST_OFFSETS = np.array([
    (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
    (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
], np.int32)  # (dx, dy)


class OrbParams(NamedTuple):
    """The extractor's settings, as a configuration states them."""

    n_levels: int = 8
    scale_factor: float = 1.2
    ini_th_fast: float = 20.0
    min_th_fast: float = 7.0
    cell_size: int = 30
    patch_size: int = 31
    edge_threshold: int = 19
    brief_seed: int = 0x12345678

    @property
    def scale_factors(self) -> np.ndarray:
        return self.scale_factor ** np.arange(self.n_levels)


class Keypoints(NamedTuple):
    """[ncam, N] keypoints in the program's slot order."""

    uv: np.ndarray       # [ncam, N, 2] undistorted pixels, float64
    level: np.ndarray    # [ncam, N] int64
    desc: np.ndarray     # [ncam, N, 8] uint32
    valid: np.ndarray    # [ncam, N] bool


# ---------------------------------------------------------------------------
# host tables
# ---------------------------------------------------------------------------

def brief_pattern(seed: int, patch_size: int = 31,
                  n_bits: int = 256) -> np.ndarray:
    """(n_bits, 2, 2) int offsets: the isotropic Gaussian BRIEF test
    pattern drawn from `seed`, clipped to the patch."""
    rng = np.random.default_rng(seed)
    half = patch_size // 2
    pts = rng.normal(0.0, patch_size / 5.0, size=(n_bits, 2, 2))
    pts = np.clip(np.round(pts), -half + 2, half - 2).astype(np.int32)
    same = np.all(pts[:, 0] == pts[:, 1], axis=-1)
    pts[same, 1, 0] += 1
    return pts


def ic_angle_masks(radius: int = 15):
    ys, xs = np.mgrid[-radius:radius + 1, -radius:radius + 1]
    mask = (xs * xs + ys * ys) <= radius * radius
    return (xs * mask).astype(np.float32), (ys * mask).astype(np.float32)


def blur_matrix(n: int, sigma: float = 2.0, r: int = 3) -> np.ndarray:
    """[n, n] 1-D Gaussian (sigma 2, 7 taps) with edge clamp: out = B @ v."""
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    k = (k / k.sum()).astype(np.float32)
    B = np.zeros((n, n), np.float32)
    for i in range(n):
        for t, w in zip(range(i - r, i + r + 1), k):
            B[i, min(max(t, 0), n - 1)] += w
    return B


def resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] antialiased bilinear resize with half-pixel centres."""
    R = np.zeros((n_out, n_in), np.float32)
    scale = n_in / n_out
    s = max(scale, 1.0)
    for i in range(n_out):
        x = (i + 0.5) * scale - 0.5
        ts = np.arange(int(np.floor(x - s)), int(np.ceil(x + s)) + 1)
        w = np.maximum(0.0, 1.0 - np.abs(ts - x) / s)
        w = w / w.sum()
        for t, wt in zip(ts, w):
            R[i, min(max(t, 0), n_in - 1)] += wt
    return R


def sampling_indices(seed: int, patch_size: int = 31) -> np.ndarray:
    """[N_BINS, 512] flattened-patch indices of the steered BRIEF samples:
    all first test points of a bin's rotation, then all second ones."""
    pat = brief_pattern(seed, patch_size)
    size = 2 * BRIEF_RADIUS + 1
    px = np.concatenate([pat[:, 0, 0], pat[:, 1, 0]]).astype(np.float64)
    py = np.concatenate([pat[:, 0, 1], pat[:, 1, 1]]).astype(np.float64)
    idx = np.zeros((N_BINS, px.size), np.int64)
    for b in range(N_BINS):
        a = 2.0 * np.pi * b / N_BINS
        ca, sa = np.cos(a), np.sin(a)
        rx = np.clip(np.round(px * ca - py * sa), -BRIEF_RADIUS, BRIEF_RADIUS)
        ry = np.clip(np.round(px * sa + py * ca), -BRIEF_RADIUS, BRIEF_RADIUS)
        idx[b] = ((ry + BRIEF_RADIUS) * size + (rx + BRIEF_RADIUS)).astype(np.int64)
    return idx


def level_budget(n_total: int, n_levels: int, scale: float) -> list[int]:
    w = np.array([(1.0 / scale) ** i for i in range(n_levels)])
    out = np.floor(w / w.sum() * n_total).astype(int)
    out[0] += n_total - out.sum()
    return out.tolist()


def level_shapes(H: int, W: int, n_levels: int, scale: float):
    return [(H, W)] + [(int(round(H / scale ** l)), int(round(W / scale ** l)))
                       for l in range(1, n_levels)]


@functools.lru_cache(maxsize=8)
def _tables(H: int, W: int, p: OrbParams, device, dtype):
    def dev(a, dt=dtype):
        return torch.as_tensor(a, device=device).to(dt)

    shapes = level_shapes(H, W, p.n_levels, p.scale_factor)
    resize = [(dev(resize_matrix(hp, h)), dev(resize_matrix(wp, w).T))
              for (hp, wp), (h, w) in zip(shapes[:-1], shapes[1:])]
    blur = [(dev(blur_matrix(h)), dev(blur_matrix(w).T)) for h, w in shapes]
    xs, ys = ic_angle_masks((p.patch_size - 1) // 2)
    return (resize, blur, dev(xs), dev(ys),
            dev(sampling_indices(p.brief_seed, p.patch_size), torch.int64))


# ---------------------------------------------------------------------------
# dense phase
# ---------------------------------------------------------------------------

def build_pyramid(img: torch.Tensor, resize) -> list[torch.Tensor]:
    pyr = [img]
    for Rh, RwT in resize:
        pyr.append(torch.matmul(torch.matmul(Rh, pyr[-1]), RwT))
    return pyr


def _circle_views(img: torch.Tensor) -> list[torch.Tensor]:
    H, W = img.shape[-2:]
    p = F.pad(img, (3, 3, 3, 3))
    return [p[..., 3 + int(dy): 3 + int(dy) + H, 3 + int(dx): 3 + int(dx) + W]
            for dx, dy in FAST_OFFSETS]


def _arc_mask(flags: list[torch.Tensor]) -> torch.Tensor:
    """A cyclic run of at least 9 set flags on the 16-pixel ring."""
    m = torch.zeros(flags[0].shape, dtype=torch.int32, device=flags[0].device)
    for k, f in enumerate(flags):
        m = m | (f.to(torch.int32) << k)
    x = m
    for _ in range(8):
        x = x & (((x >> 1) | (x << 15)) & 0xFFFF)
    return x > 0


def fast_scores2(img: torch.Tensor, th_hi: float, th_lo: float):
    """(score_hi, score_lo, sad_lo): FAST-9/16 responses at both thresholds
    (sums over the ring in order k = 0..15) and the ungated SAD at th_lo."""
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


def fast_nms(img: torch.Tensor, th_hi: float, th_lo: float):
    """(s_nms, sad_lo): the blended score kept where it is a 3x3 maximum."""
    s_hi, s_lo, sad_lo = fast_scores2(img, th_hi, th_lo)
    s = torch.where(s_hi > 0, s_hi + NMS_BONUS, s_lo)
    H, W = s.shape[-2:]
    m = F.max_pool2d(s.reshape(-1, 1, H, W), 3, stride=1, padding=1)
    return torch.where(s >= m.reshape(s.shape), s, torch.zeros_like(s)), sad_lo


def select_keypoints(score: torch.Tensor, n_keep: int, cell: int,
                     border: int):
    """The tiered cell-winner top-k: (yx int64 [..., n_keep, 2], score)."""
    score = score.to(torch.float32)
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

    bonus = (4e7 * cell_best(cell) + 2e7 * cell_best(cell // 2)
             + 1e7 * cell_best(max(cell // 4, 4)))
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
    ksc = torch.where(torch.gather(flat_valid, -1, top), ksc, torch.zeros_like(ksc))
    return torch.stack([top // W, top % W], dim=-1), ksc


# ---------------------------------------------------------------------------
# sparse phase
# ---------------------------------------------------------------------------

def _patches(img: torch.Tensor, yx: torch.Tensor, radius: int) -> torch.Tensor:
    """[B, N, 2r+1, 2r+1] patches, reads clamped to the edge."""
    B = img.shape[0]
    p = F.pad(img[:, None].to(torch.float32), (radius,) * 4,
              mode="replicate")[:, 0].to(img.dtype)
    ar = torch.arange(2 * radius + 1, device=img.device)
    rows = yx[..., 0, None] + ar
    cols = yx[..., 1, None] + ar
    b = torch.arange(B, device=img.device)[:, None, None, None]
    return p[b, rows[..., :, None], cols[..., None, :]]


def _subpixel(p: torch.Tensor) -> torch.Tensor:
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


def _brief(patches: torch.Tensor, angles: torch.Tensor,
           sampling: torch.Tensor) -> torch.Tensor:
    """[..., N, 8] uint32-valued int64 words of the steered BRIEF-256."""
    two_pi = 2.0 * math.pi
    bins = torch.round(torch.remainder(angles.to(torch.float32), two_pi)
                       / two_pi * N_BINS).to(torch.int64) % N_BINS
    vals = torch.gather(patches.flatten(-2), -1, sampling[bins])
    nb = vals.shape[-1] // 2
    bits = (vals[..., :nb] < vals[..., nb:]).to(torch.int64)
    bits = bits.reshape(*bits.shape[:-1], nb // 32, 32)
    return (bits << torch.arange(32, device=bits.device)).sum(-1)


def undistort(xd: np.ndarray, dist: np.ndarray, iters: int = 8) -> np.ndarray:
    """Normalized coordinates [..., 2] undistorted by `iters` fixed-point
    steps (the program's iteration count), float64."""
    k1, k2, p1, p2, k3 = (float(d) for d in dist)
    xy = xd
    for _ in range(iters):
        x, y = xy[..., 0], xy[..., 1]
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        dx = 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        dy = p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
        xy = np.stack([(xd[..., 0] - dx) / radial, (xd[..., 1] - dy) / radial], -1)
    return xy


def extract(images: torch.Tensor, p: OrbParams, n_out: int, K: np.ndarray,
            dist: np.ndarray, dtype=torch.float32) -> Keypoints:
    """Up to n_out keypoints per camera of u8 or float images [ncam, H, W]
    on any device, in the program's slot order; K [ncam, 3, 3] and dist
    [ncam, 5] undistort them."""
    ncam, H, W = images.shape
    dev = images.device
    resize, blur, ic_xs, ic_ys, sampling = _tables(H, W, p, dev, dtype)
    budgets = level_budget(n_out, p.n_levels, p.scale_factor)
    pyr = build_pyramid(images.to(dtype), resize)
    ic_r = (p.patch_size - 1) // 2
    yxs, lvls, scs, offs, angs, descs = [], [], [], [], [], []
    for l, budget in enumerate(budgets):
        if budget <= 0:
            continue
        im = pyr[l]
        s, sad_lo = fast_nms(im, float(p.ini_th_fast), float(p.min_th_fast))
        yx, sc = select_keypoints(s, budget, p.cell_size, p.edge_threshold)
        yxs.append(yx)
        lvls.append(torch.full((ncam, budget), l, dtype=torch.int64, device=dev))
        scs.append(sc)
        offs.append(_subpixel(_patches(sad_lo, yx, 1)).to(torch.float32))
        pt = _patches(im, yx, ic_r)
        ang = torch.atan2((pt * ic_ys).sum(dim=(-2, -1)),
                          (pt * ic_xs).sum(dim=(-2, -1)))
        angs.append(ang)
        blurred = torch.matmul(torch.matmul(blur[l][0], im), blur[l][1])
        descs.append(_brief(_patches(blurred, yx, BRIEF_RADIUS), ang, sampling))
    yx = torch.cat(yxs, 1).to(torch.float32) + torch.cat(offs, 1)
    lvl = torch.cat(lvls, 1)
    scales = torch.as_tensor(p.scale_factors, dtype=torch.float32, device=dev)[lvl]
    uv = ((yx.flip(-1) + 0.5) * scales[..., None] - 0.5).cpu().numpy().astype(np.float64)
    Kinv = np.linalg.inv(K)
    xn = np.einsum('cij,cnj->cni', Kinv[:, :2, :2], uv) + Kinv[:, None, :2, 2]
    xu = np.stack([undistort(xn[c], dist[c]) for c in range(ncam)])
    uv = np.einsum('cij,cnj->cni', K[:, :2, :2], xu) + K[:, None, :2, 2]
    return Keypoints(uv=uv, level=lvl.cpu().numpy(),
                     desc=torch.cat(descs, 1).cpu().numpy().astype(np.uint32),
                     valid=(torch.cat(scs, 1) > 0).cpu().numpy())


def compare(prog: Keypoints, ref: Keypoints, uv_tol: float = 0.01):
    """(kp_mismatch, desc_bits): the share of the program's keypoint slots
    that the reference does not give (validity, level or a position more
    than uv_tol px away), and the share of descriptor bits that differ on
    the slots that agree."""
    both = prog.valid & ref.valid
    same = ((prog.valid == ref.valid)
            & (~both | ((prog.level == ref.level)
                        & (np.abs(prog.uv - ref.uv).max(-1) <= uv_tol))))
    n_slots = int(prog.valid.sum() + (ref.valid & ~prog.valid).sum())
    mismatch = float((~same).sum()) / max(n_slots, 1)
    agree = same & both
    x = np.bitwise_xor(prog.desc[agree], ref.desc[agree])
    nbits = int(np.unpackbits(x.view(np.uint8)).sum())
    return mismatch, nbits / max(256 * int(agree.sum()), 1)
