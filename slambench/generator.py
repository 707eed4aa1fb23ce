"""The benchmark's scene generator: a textured box room, rig paths through
it, and frames rendered on the device from the seed.

A PyTorch copy of the generator in the port's utils/synthetic.py
(`make_box_world`, `render`, `render_rig`, `orbit_trajectory`), kept here
so that the yardstick does not move when the program does.  Differences:

- the textures are drawn with a torch.Generator on the device (the same
  recipe: three octaves of smooth noise plus 150 high-contrast rectangles,
  ellipses and thick lines per face, later shapes painted over earlier
  ones), so the pixels are not those of the numpy recipe;
- rendering is one batched raycast per camera on the device;
- a camera with lens distortion is rendered through a per-pixel ray table
  (the distorted pixel's normalized coordinates undistorted by fixed-point
  iteration, once per camera), so the program has to undistort its
  keypoints as it does for a real lens.

Nothing here imports the program.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Sequence

import numpy as np
import torch

BACKGROUND = 35.0
N_SHAPES = 150


@dataclass
class Room:
    """Six inward-facing textured planes of a box around the origin, as
    float64 tensors on one device (textures float32)."""

    half: float
    height: float
    origins: torch.Tensor   # [6, 3] face corner
    e1: torch.Tensor        # [6, 3] face axis 1 (world units)
    e2: torch.Tensor        # [6, 3] face axis 2
    normals: torch.Tensor   # [6, 3]
    offsets: torch.Tensor   # [6] plane offsets (n.x = off)
    textures: torch.Tensor  # [6, T, T] float32


def _upsample_matrix(n_in: int, n_out: int, device) -> torch.Tensor:
    """[n_out, n_in] linear interpolation with half-pixel centers."""
    x = ((torch.arange(n_out, dtype=torch.float64, device=device) + 0.5)
         * n_in / n_out - 0.5).clamp(0, n_in - 1)
    lo = x.floor().long()
    hi = (lo + 1).clamp(max=n_in - 1)
    f = x - lo
    U = torch.zeros(n_out, n_in, dtype=torch.float64, device=device)
    r = torch.arange(n_out, device=device)
    U.index_put_((r, lo), 1.0 - f, accumulate=True)
    U.index_put_((r, hi), f, accumulate=True)
    return U


def make_textures(gen: torch.Generator, n: int, size: int, device,
                  lo: float = 25.0, hi: float = 230.0) -> torch.Tensor:
    """[n, size, size] float32 textures: multi-octave smooth noise scaled
    to [lo, hi], then N_SHAPES shapes per texture painted in order (each
    pixel takes the value of the last shape that covers it)."""
    img = torch.zeros(n, size, size, dtype=torch.float64, device=device)
    for octave, amp in ((16, 0.5), (64, 1.0), (128, 0.5)):
        noise = torch.rand(n, octave, octave, generator=gen,
                           dtype=torch.float64, device=device)
        U = _upsample_matrix(octave, size, device)
        img += amp * (U @ noise @ U.T)
    mn = img.amin(dim=(1, 2), keepdim=True)
    mx = img.amax(dim=(1, 2), keepdim=True)
    img = lo + (hi - lo) * (img - mn) / (mx - mn).clamp(min=1e-9)

    S = N_SHAPES

    def uni(a, b):
        return a + (b - a) * torch.rand(n, S, generator=gen,
                                        dtype=torch.float64, device=device)

    def ints(a, b):
        return torch.randint(a, b, (n, S), generator=gen, device=device
                             ).to(torch.float64)

    value = uni(lo, hi)
    cx, cy = ints(0, size), ints(0, size)
    kind = torch.randint(0, 3, (n, S), generator=gen, device=device)
    rect_ax, rect_ay = ints(6, 40) / 2, ints(6, 40) / 2
    ell_ax, ell_ay = ints(4, 30), ints(4, 30)
    ang = torch.deg2rad(uni(0.0, 180.0))
    x2, y2 = ints(0, size), ints(0, size)
    th = ints(2, 6)

    ar = torch.arange(size, dtype=torch.float64, device=device)
    owner = torch.full((n, size, size), -1, dtype=torch.long, device=device)
    for s in range(S):
        # [n, size, size] coverage of shape s on every texture at once
        xx = ar[None, None, :] - cx[:, s, None, None]
        yy = ar[None, :, None] - cy[:, s, None, None]
        ca, sa = torch.cos(ang[:, s, None, None]), torch.sin(ang[:, s, None, None])
        u = xx * ca + yy * sa
        t = -xx * sa + yy * ca
        rect = ((u.abs() <= rect_ax[:, s, None, None])
                & (t.abs() <= rect_ay[:, s, None, None]))
        ell = ((u / ell_ax[:, s, None, None]) ** 2
               + (t / ell_ay[:, s, None, None]) ** 2) <= 1.0
        dx = (x2[:, s] - cx[:, s])[:, None, None]
        dy = (y2[:, s] - cy[:, s])[:, None, None]
        dd = (dx * dx + dy * dy).clamp(min=1e-9)
        f = ((xx * dx + yy * dy) / dd).clamp(0.0, 1.0)
        line = ((xx - f * dx) ** 2 + (yy - f * dy) ** 2
                <= (th[:, s, None, None] / 2) ** 2)
        k = kind[:, s, None, None]
        cover = torch.where(k == 0, rect, torch.where(k == 1, ell, line))
        owner = torch.where(cover, torch.full_like(owner, s), owner)
    painted = torch.gather(value, 1, owner.clamp(min=0).reshape(n, -1)
                           ).reshape(n, size, size)
    img = torch.where(owner >= 0, painted, img)
    return img.to(torch.float32)


def make_room(gen: torch.Generator, device, half: float = 6.0,
              height: float = 3.0, tex_size: int = 512) -> Room:
    """The box room of utils/synthetic.make_box_world, textures from `gen`."""
    h, y = half, height
    faces = [
        ([-h, -y, h], [2 * h, 0, 0], [0, 2 * y, 0]),     # z=+h wall
        ([h, -y, -h], [-2 * h, 0, 0], [0, 2 * y, 0]),    # z=-h wall
        ([h, -y, h], [0, 0, -2 * h], [0, 2 * y, 0]),     # x=+h wall
        ([-h, -y, -h], [0, 0, 2 * h], [0, 2 * y, 0]),    # x=-h wall
        ([-h, y, h], [2 * h, 0, 0], [0, 0, -2 * h]),     # ceiling y=+y
        ([-h, -y, -h], [2 * h, 0, 0], [0, 0, 2 * h]),    # floor y=-y
    ]

    def f64(a):
        return torch.as_tensor(np.asarray(a, np.float64), device=device)

    origins = f64([f[0] for f in faces])
    e1 = f64([f[1] for f in faces])
    e2 = f64([f[2] for f in faces])
    normals = torch.linalg.cross(e1, e2)
    normals = normals / normals.norm(dim=1, keepdim=True)
    offsets = (normals * origins).sum(1)
    return Room(half=half, height=height, origins=origins, e1=e1, e2=e2,
                normals=normals, offsets=offsets,
                textures=make_textures(gen, 6, tex_size, device))


# ---------------------------------------------------------------------------
# cameras
# ---------------------------------------------------------------------------

def undistort_normalized(xd: torch.Tensor, dist: Sequence[float],
                         iters: int = 20) -> torch.Tensor:
    """Invert the radial-tangential distortion (k1, k2, p1, p2, k3) of
    normalized coordinates [..., 2] by fixed-point iteration."""
    k1, k2, p1, p2, k3 = (float(d) for d in dist)
    xy = xd
    for _ in range(iters):
        x, y = xy[..., 0], xy[..., 1]
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        dx = 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        dy = p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
        xy = torch.stack([(xd[..., 0] - dx) / radial,
                          (xd[..., 1] - dy) / radial], -1)
    return xy


def ray_table(K: np.ndarray, dist: Sequence[float], H: int, W: int,
              device) -> torch.Tensor:
    """[H*W, 3] float64 camera-frame ray (x, y, 1) through each pixel
    centre of a camera with intrinsics K and distortion `dist`."""
    v, u = torch.meshgrid(torch.arange(H, dtype=torch.float64, device=device),
                          torch.arange(W, dtype=torch.float64, device=device),
                          indexing="ij")
    xd = torch.stack([(u.reshape(-1) - K[0, 2]) / K[0, 0],
                      (v.reshape(-1) - K[1, 2]) / K[1, 1]], -1)
    xu = undistort_normalized(xd, dist) if any(dist) else xd
    return torch.cat([xu, torch.ones_like(xu[:, :1])], -1)


def render(room: Room, rays: torch.Tensor, T_cam_w: torch.Tensor, H: int,
           W: int) -> torch.Tensor:
    """Raycast one camera (T_cam_w: world -> camera, float64 [4, 4]) along
    `rays` [H*W, 3] with bilinear texture sampling: float32 [H, W]."""
    R = T_cam_w[:3, :3]
    c = -R.T @ T_cam_w[:3, 3]
    d = rays @ R                                   # R^T ray: world directions
    P = d.shape[0]
    best_t = torch.full((P,), math.inf, dtype=torch.float64, device=d.device)
    face = torch.full((P,), -1, dtype=torch.long, device=d.device)
    u1s = torch.zeros(P, dtype=torch.float64, device=d.device)
    u2s = torch.zeros_like(u1s)
    for i in range(6):
        n = room.normals[i]
        dn = d @ n
        tt = (room.offsets[i] - c @ n) / torch.where(dn.abs() > 1e-12, dn,
                                                     torch.full_like(dn, 1e-12))
        hit = (tt > 0.05) & (tt < best_t)
        rel = c + tt[:, None] * d - room.origins[i]
        a1, a2 = room.e1[i], room.e2[i]
        u1 = (rel @ a1) / (a1 @ a1)
        u2 = (rel @ a2) / (a2 @ a2)
        inb = hit & (u1 >= 0) & (u1 < 1) & (u2 >= 0) & (u2 < 1)
        best_t = torch.where(inb, tt, best_t)
        face = torch.where(inb, torch.full_like(face, i), face)
        u1s = torch.where(inb, u1, u1s)
        u2s = torch.where(inb, u2, u2s)
    tex = room.textures
    Th, Tw = tex.shape[1:]
    tx = (u1s * (Tw - 1)).clamp(0, Tw - 1.001)
    ty = (u2s * (Th - 1)).clamp(0, Th - 1.001)
    x0 = tx.long()
    y0 = ty.long()
    fx = (tx - x0).to(torch.float32)
    fy = (ty - y0).to(torch.float32)
    f = face.clamp(min=0)
    img = (tex[f, y0, x0] * (1 - fx) * (1 - fy) + tex[f, y0, x0 + 1] * fx * (1 - fy)
           + tex[f, y0 + 1, x0] * (1 - fx) * fy + tex[f, y0 + 1, x0 + 1] * fx * fy)
    img = torch.where(face >= 0, img, torch.full_like(img, BACKGROUND))
    return img.reshape(H, W)


class Rig:
    """The cameras the frames are rendered for: intrinsics K [ncam, 3, 3],
    distortion [ncam, 5] and extrinsics T_sc [ncam, 4, 4] (capture frame ->
    camera), all numpy float64, and each camera's ray table on `device`."""

    def __init__(self, K: np.ndarray, dist: np.ndarray, T_sc: np.ndarray,
                 H: int, W: int, device) -> None:
        self.K, self.dist, self.T_sc = K, dist, T_sc
        self.H, self.W = H, W
        self.device = device
        self.rays = [ray_table(K[c], dist[c], H, W, device)
                     for c in range(K.shape[0])]
        self._T_sc = torch.as_tensor(T_sc, device=device)

    @property
    def n_cameras(self) -> int:
        return self.K.shape[0]

    def render(self, room: Room, T_cw: np.ndarray) -> torch.Tensor:
        """All cameras at rig pose T_cw: float32 [ncam, H, W] on the device."""
        T = torch.as_tensor(np.asarray(T_cw, np.float64), device=self.device)
        return torch.stack([render(room, self.rays[c], self._T_sc[c] @ T,
                                   self.H, self.W)
                            for c in range(self.n_cameras)])

    def render_u8(self, room: Room, poses: Sequence[np.ndarray]) -> np.ndarray:
        """u8 [n, ncam, H, W] host frames of the rig poses, rounded as a
        camera's 8-bit output, copied to the host once."""
        out = torch.empty((len(poses), self.n_cameras, self.H, self.W),
                          dtype=torch.uint8, device=self.device)
        for k, T in enumerate(poses):
            out[k] = self.render(room, T).round().clamp(0, 255).to(torch.uint8)
        return out.cpu().numpy()


# ---------------------------------------------------------------------------
# paths
# ---------------------------------------------------------------------------

def so3_exp_y(a: float) -> np.ndarray:
    c, s = math.cos(a), math.sin(a)
    return np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])


def orbit_pose(radius: float, a: float) -> np.ndarray:
    """T_cw of the rig at angle `a` (radians) on the circle of
    utils/synthetic.orbit_trajectory: centre (r sin a, 0, -r cos a),
    turned by a about y."""
    T_wc = np.eye(4)
    T_wc[:3, :3] = so3_exp_y(a)
    T_wc[:3, 3] = [radius * math.sin(a), 0.0, -radius * math.cos(a)]
    return np.linalg.inv(T_wc)


def orbit_path(radius: float, start: float, step: float,
               n: int) -> List[np.ndarray]:
    """n poses on the orbit from angle `start`, `step` radians apart."""
    return [orbit_pose(radius, start + k * step) for k in range(n)]


def back_and_forth(radius: float, lo: float, hi: float, step: float,
                   n: int, start: float) -> List[np.ndarray]:
    """n poses on the orbit of `radius` sweeping between angles lo and hi
    at `step` radians per frame, from angle `start` going up first."""
    span = hi - lo
    out = []
    s = (start - lo) % (2 * span)
    for _ in range(n):
        a = lo + (s if s <= span else 2 * span - s)
        out.append(orbit_pose(radius, a))
        s = (s + step) % (2 * span)
    return out
