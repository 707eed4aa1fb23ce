"""Synthetic dual-camera world renderer, numpy only.

Copy of the parts of orbslam2_dualcam_tpu/utils/synthetic.py the tracking
smoke run needs (`make_box_world`, `render`, `render_rig`,
`orbit_trajectory`, `out_and_back_trajectory`), without jax and without OpenCV: a textured box room
rendered by a small raycaster with bilinear texture sampling.  The texture
recipe is the reference's (multi-octave smooth noise plus sparse
high-contrast rectangles, ellipses and lines) redrawn in numpy, so the
pixels are not the reference's.  `raycast_depth` adds the ray-box depth at
given pixels, and `seed_store` uses it to seed a map store from ground
truth.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np


def so3_exp(phi: np.ndarray) -> np.ndarray:
    """Rodrigues: axis-angle 3-vector -> rotation matrix (float64)."""
    phi = np.asarray(phi, np.float64)
    theta2 = float(phi @ phi)
    K = np.array([[0.0, -phi[2], phi[1]], [phi[2], 0.0, -phi[0]],
                  [-phi[1], phi[0], 0.0]])
    if theta2 > 1e-8:
        theta = np.sqrt(theta2)
        a, b = np.sin(theta) / theta, (1.0 - np.cos(theta)) / theta2
    else:
        a, b = 1.0 - theta2 / 6.0, 0.5 - theta2 / 24.0
    return np.eye(3) + a * K + b * (K @ K)


@dataclass
class World:
    """A textured box room: 6 inward-facing planes with noise textures."""

    half: float
    height: float
    origins: np.ndarray    # [6,3] face corner P0
    e1: np.ndarray         # [6,3] face axis 1 (world units)
    e2: np.ndarray         # [6,3] face axis 2
    normals: np.ndarray    # [6,3]
    offsets: np.ndarray    # [6] plane offsets (n.x = off)
    textures: list         # 6 float32 [Th,Tw] textures
    tex_scale: np.ndarray  # [6,2] texels per world unit along e1/e2


def _upsample_matrix(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] linear interpolation with half-pixel centers."""
    x = np.clip((np.arange(n_out) + 0.5) * n_in / n_out - 0.5, 0, n_in - 1)
    lo = np.floor(x).astype(int)
    hi = np.minimum(lo + 1, n_in - 1)
    f = x - lo
    U = np.zeros((n_out, n_in))
    U[np.arange(n_out), lo] += 1.0 - f
    U[np.arange(n_out), hi] += f
    return U


def _noise_texture(rng: np.random.Generator, size: int = 512,
                   lo: float = 25.0, hi: float = 230.0) -> np.ndarray:
    """Corner-rich, locally unique texture: multi-octave smooth noise (no
    octave finer than 4 texels, which would alias under minification) plus
    150 sparse high-contrast shapes that give BRIEF patches identity."""
    img = np.zeros((size, size))
    for octave, amp in [(16, 0.5), (64, 1.0), (128, 0.5)]:
        n = rng.uniform(0, 1, (octave, octave))
        U = _upsample_matrix(octave, size)
        img += amp * (U @ n @ U.T)
    img -= img.min()
    img /= max(img.max(), 1e-9)
    img = lo + (hi - lo) * img

    def window(x0, x1, y0, y1):
        """Pixel grid of the clipped box [x0, x1] x [y0, y1]."""
        x0, y0 = max(int(x0), 0), max(int(y0), 0)
        x1, y1 = min(int(x1) + 1, size), min(int(y1) + 1, size)
        yy, xx = np.mgrid[y0:y1, x0:x1]
        return (slice(y0, y1), slice(x0, x1)), xx, yy

    for _ in range(150):
        v = float(rng.uniform(lo, hi))
        x, y = int(rng.integers(0, size)), int(rng.integers(0, size))
        kind = rng.integers(0, 3)
        if kind < 2:       # rotated filled rectangle or ellipse
            if kind == 0:
                ax, ay = int(rng.integers(6, 40)) / 2, int(rng.integers(6, 40)) / 2
            else:
                ax, ay = int(rng.integers(4, 30)), int(rng.integers(4, 30))
            a = np.deg2rad(float(rng.uniform(0, 180)))
            r = np.hypot(ax, ay)
            box, xx, yy = window(x - r, x + r, y - r, y + r)
            u = (xx - x) * np.cos(a) + (yy - y) * np.sin(a)
            t = -(xx - x) * np.sin(a) + (yy - y) * np.cos(a)
            if kind == 0:
                m = (np.abs(u) <= ax) & (np.abs(t) <= ay)
            else:
                m = (u / ax) ** 2 + (t / ay) ** 2 <= 1.0
        else:              # thick line segment
            x2, y2 = int(rng.integers(0, size)), int(rng.integers(0, size))
            th = int(rng.integers(2, 6))
            box, xx, yy = window(min(x, x2) - th, max(x, x2) + th,
                                 min(y, y2) - th, max(y, y2) + th)
            d = np.array([x2 - x, y2 - y], np.float64)
            s = np.clip(((xx - x) * d[0] + (yy - y) * d[1]) / max(d @ d, 1e-9),
                        0.0, 1.0)
            m = (xx - x - s * d[0]) ** 2 + (yy - y - s * d[1]) ** 2 <= (th / 2) ** 2
        img[box][m] = v
    return img.astype(np.float32)


def make_box_world(rng: np.random.Generator, half: float = 8.0,
                   height: float = 3.0, tex_size: int = 512) -> World:
    """Box room around the origin."""
    h, y = half, height
    faces = [
        ([-h, -y, h], [2 * h, 0, 0], [0, 2 * y, 0]),     # z=+h wall
        ([h, -y, -h], [-2 * h, 0, 0], [0, 2 * y, 0]),    # z=-h wall
        ([h, -y, h], [0, 0, -2 * h], [0, 2 * y, 0]),     # x=+h wall
        ([-h, -y, -h], [0, 0, 2 * h], [0, 2 * y, 0]),    # x=-h wall
        ([-h, y, h], [2 * h, 0, 0], [0, 0, -2 * h]),     # ceiling y=+y
        ([-h, -y, -h], [2 * h, 0, 0], [0, 0, 2 * h]),    # floor y=-y
    ]
    origins = np.asarray([f[0] for f in faces], np.float64)
    e1 = np.asarray([f[1] for f in faces], np.float64)
    e2 = np.asarray([f[2] for f in faces], np.float64)
    normals = np.cross(e1, e2)
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    offsets = np.einsum('ij,ij->i', normals, origins)
    textures = [_noise_texture(rng, tex_size) for _ in range(6)]
    tex_scale = np.stack([
        [tex_size / np.linalg.norm(e1[i]), tex_size / np.linalg.norm(e2[i])]
        for i in range(6)])
    return World(half=half, height=height, origins=origins, e1=e1, e2=e2,
                 normals=normals, offsets=offsets, textures=textures,
                 tex_scale=tex_scale)


def _raycast(world: World, K: np.ndarray, T_cam_w: np.ndarray,
             uv: np.ndarray):
    """Nearest in-face hit along the rays through pixels uv [P, 2]:
    (ray parameter = camera-frame depth [P], face [P], u1 [P], u2 [P]);
    depth is inf and face -1 where no face is hit."""
    R = T_cam_w[:3, :3]
    c = -R.T @ T_cam_w[:3, 3]                        # camera center (world)
    rays = np.concatenate([uv, np.ones((len(uv), 1))], 1) @ np.linalg.inv(K).T
    d = rays @ R                                      # R^T * ray, world dirs
    best_t = np.full(len(uv), np.inf)
    face = np.full(len(uv), -1)
    u1s = np.zeros(len(uv))
    u2s = np.zeros(len(uv))
    for i in range(6):
        n = world.normals[i]
        dn = d @ n
        tt = (world.offsets[i] - c @ n) / np.where(np.abs(dn) > 1e-12, dn, 1e-12)
        hit = (tt > 0.05) & (tt < best_t)
        rel = c + tt[:, None] * d - world.origins[i]
        a1, a2 = world.e1[i], world.e2[i]
        u1 = (rel @ a1) / (a1 @ a1)
        u2 = (rel @ a2) / (a2 @ a2)
        inb = hit & (u1 >= 0) & (u1 < 1) & (u2 >= 0) & (u2 < 1)
        best_t[inb] = tt[inb]
        face[inb] = i
        u1s[inb] = u1[inb]
        u2s[inb] = u2[inb]
    return best_t, face, u1s, u2s


def render(world: World, K: np.ndarray, T_cam_w: np.ndarray, H: int = 480,
           W: int = 640, background: float = 35.0) -> np.ndarray:
    """Raycast-render one camera (T_cam_w: world->camera) with bilinear
    texture sampling: subpixel-exact, viewpoint-consistent."""
    us, vs = np.meshgrid(np.arange(W, dtype=np.float64),
                         np.arange(H, dtype=np.float64))
    _, face, u1, u2 = _raycast(world, K, T_cam_w,
                               np.stack([us.ravel(), vs.ravel()], 1))
    img = np.full(H * W, background, np.float32)
    for i in range(6):
        sel = face == i
        if not sel.any():
            continue
        tex = world.textures[i]
        Th, Tw = tex.shape
        tx = np.clip(u1[sel] * (Tw - 1), 0, Tw - 1.001)
        ty = np.clip(u2[sel] * (Th - 1), 0, Th - 1.001)
        x0 = tx.astype(np.int64)
        y0 = ty.astype(np.int64)
        fx = (tx - x0).astype(np.float32)
        fy = (ty - y0).astype(np.float32)
        img[sel] = (tex[y0, x0] * (1 - fx) * (1 - fy) + tex[y0, x0 + 1] * fx * (1 - fy)
                    + tex[y0 + 1, x0] * (1 - fx) * fy + tex[y0 + 1, x0 + 1] * fx * fy)
    return img.reshape(H, W)


def render_rig(world: World, rig_K: np.ndarray, rig_T_sc: np.ndarray,
               T_cw: np.ndarray, H: int = 480, W: int = 640) -> np.ndarray:
    """Render all rig cameras: [ncam, H, W]."""
    return np.stack([render(world, rig_K[c], rig_T_sc[c] @ T_cw, H, W)
                     for c in range(rig_K.shape[0])])


def raycast_depth(world: World, K: np.ndarray, T_cam_w: np.ndarray,
                  uv: np.ndarray) -> np.ndarray:
    """Camera-frame depth (z) of the box surface seen through pixels uv
    [P, 2] (undistorted, x then y); inf where the ray hits no face."""
    return _raycast(world, K, T_cam_w, np.asarray(uv, np.float64))[0]


class MapStore(NamedTuple):
    """A map store in the layout the tracking step takes (numpy)."""

    pos: np.ndarray      # [M, 3] float32 world positions
    desc: np.ndarray     # [M, 8] uint32 descriptors
    valid: np.ndarray    # [M] bool
    max_dist: np.ndarray  # [M] float32 scale-invariance band
    min_dist: np.ndarray  # [M] float32
    normal: np.ndarray   # [M, 3] float32 mean viewing direction
    slots: np.ndarray    # [ncam, N] int64 store slot of each keypoint (-1)


def seed_store(world: World, rig_K: np.ndarray, rig_T_sc: np.ndarray,
               T_cw: np.ndarray, uv: np.ndarray, level: np.ndarray,
               desc: np.ndarray, valid: np.ndarray,
               scale_factors: np.ndarray, cap: int) -> MapStore:
    """A store of `cap` slots seeded from one rig frame's keypoints with
    ground-truth depth: each valid keypoint (uv [ncam, N, 2] undistorted,
    level, desc uint32 [ncam, N, 8]) whose ray hits the room becomes a map
    point at the hit, with the distance band of models/map.py
    (max = distance x scale of its level, min = max / top-level scale).
    Each camera gets up to cap // ncam slots, keypoints in their order;
    unused slots are invalid, as the reference's DeviceMapStore leaves
    them."""
    ncam, N = valid.shape
    pos = np.zeros((cap, 3), np.float32)
    sdesc = np.zeros((cap, 8), np.uint32)
    svalid = np.zeros(cap, bool)
    dmax = np.full(cap, 1e9, np.float32)
    dmin = np.zeros(cap, np.float32)
    normal = np.zeros((cap, 3), np.float32)
    slots = np.full((ncam, N), -1, np.int64)
    nxt = 0
    for c in range(ncam):
        T_sw = rig_T_sc[c] @ T_cw
        R, t = T_sw[:3, :3], T_sw[:3, 3]
        depth = raycast_depth(world, rig_K[c], T_sw, uv[c])
        ok = np.nonzero(valid[c] & np.isfinite(depth))[0][:cap // ncam]
        ray = np.concatenate([uv[c][ok], np.ones((len(ok), 1))], 1) @ np.linalg.inv(rig_K[c]).T
        X = (ray * depth[ok, None] - t) @ R                 # R^T (x_cam - t)
        v = X - (-R.T @ t)
        dist = np.linalg.norm(v, axis=1)
        sl = np.arange(nxt, nxt + len(ok))
        nxt += len(ok)
        pos[sl] = X
        sdesc[sl] = desc[c][ok]
        svalid[sl] = True
        dmax[sl] = dist * scale_factors[level[c][ok]]
        dmin[sl] = dmax[sl] / scale_factors[-1]
        normal[sl] = v / dist[:, None]
        slots[c, ok] = sl
    return MapStore(pos, sdesc, svalid, dmax, dmin, normal, slots)


def orbit_trajectory(n_frames: int, radius: float = 2.0,
                     total_angle: float = 2 * np.pi,
                     wobble: float = 0.0) -> list[np.ndarray]:
    """Rig poses T_cw moving on a circle, looking tangentially (a loop).
    Returns list of 4x4 world->capture transforms."""
    poses = []
    for k in range(n_frames):
        a = total_angle * k / n_frames
        T_wc = np.eye(4)
        T_wc[:3, :3] = so3_exp(np.array([0.0, a, 0.0]))
        T_wc[:3, 3] = [radius * np.sin(a), wobble * np.sin(3 * a),
                       -radius * np.cos(a)]
        poses.append(np.linalg.inv(T_wc))
    return poses


def out_and_back_trajectory(n_out: int = 30, n_turn: int = 30,
                            n_back: int = 30, x0: float = -3.0,
                            x1: float = 3.0, turn_radius: float = 1.0,
                            n_turn2: int = 0,
                            n_out2: int = 0) -> list[np.ndarray]:
    """Crab-walk along x facing the +z wall, U-turn on an arc (rotation
    with baseline: an in-place rotation cannot be triangulated by a
    monocular front end), crab-walk back; with `n_turn2`/`n_out2` a second
    U-turn at the far end and a second leg out.  Returns 4x4 world->capture
    transforms."""
    poses = []

    def pose(x, z, yaw):
        T_wc = np.eye(4)
        T_wc[:3, :3] = so3_exp(np.array([0.0, yaw, 0.0]))
        T_wc[:3, 3] = [x, 0.0, z]
        return np.linalg.inv(T_wc)

    for k in range(n_out):
        poses.append(pose(x0 + (x1 - x0) * k / max(n_out - 1, 1), 0.0, 0.0))
    r = turn_radius
    for k in range(1, n_turn + 1):
        th = np.pi * k / n_turn
        poses.append(pose(x1 + r * np.sin(th), r * (1 - np.cos(th)), th))
    for k in range(1, n_back + 1):
        poses.append(pose(x1 + (x0 - x1) * k / n_back, 2 * r, np.pi))
    for k in range(1, n_turn2 + 1):
        th = np.pi * k / n_turn2
        poses.append(pose(x0 - r * np.sin(th), 2 * r + r * (1 - np.cos(th)),
                          np.pi + th))
    for k in range(1, n_out2 + 1):
        poses.append(pose(x0 + (x1 - x0) * k / n_out2, 4 * r, 0.0))
    return poses
