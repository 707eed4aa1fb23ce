"""Dataset loaders and the real-texture evaluation sequence.

The port's own copy of orbslam2_dualcam_tpu/utils/datasets.py: numpy and
cv2 (imported inside the functions that read or warp images), no torch
and no jax; a test holds it equal to the JAX package's on the same files.
The photograph is not part of the repository: `DEFAULT_PHOTO` names it
by its place in the original project's source tree, relative to the
working directory (the JAX package names an absolute path); pass your own
with `photo=`.

Two entry points:

* `TumRgbDataset` — reads the TUM RGB-D format the reference community
  evaluates on (rgb.txt timestamp/path index + groundtruth.txt
  `tx ty tz qx qy qz qw`), with nearest-timestamp association.  Matches
  SURVEY §6's eval plan (fr1/desk-class sequences).

* `planar_photo_sequence` — an OFFLINE eval sequence built from a real
  photograph: the image is mounted on walls of a room and every frame is
  produced by cv2.warpPerspective with the EXACT plane-induced homography
  of the ground-truth camera (planar scenes make the pinhole warp exact,
  so no in-repo renderer is involved).  This provides real image
  statistics — photographic gradients, JPEG texture, self-similar
  regions — for FAST/BRIEF and a known trajectory for ATE, in an
  environment with no dataset downloads (zero egress).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# TUM RGB(-D) format
# ---------------------------------------------------------------------------

@dataclass
class TumRgbDataset:
    """TUM RGB sequence: frames (timestamp, image path) + ground truth.

    Layout (vision.in.tum.de/data/datasets/rgbd-dataset/file_formats):
      rgb.txt          `timestamp filename` per line, '#' comments
      groundtruth.txt  `timestamp tx ty tz qx qy qz qw`
    """

    root: str
    frames: List[Tuple[float, str]]
    gt_t: np.ndarray       # [G] timestamps
    gt_pos: np.ndarray     # [G, 3]
    gt_quat: np.ndarray    # [G, 4] (qx, qy, qz, qw)

    @classmethod
    def load(cls, root: str) -> "TumRgbDataset":
        frames = []
        with open(os.path.join(root, "rgb.txt")) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                ts, path = line.split()[:2]
                frames.append((float(ts), os.path.join(root, path)))
        gt_t, gt_pos, gt_quat = [], [], []
        gt_file = os.path.join(root, "groundtruth.txt")
        if os.path.exists(gt_file):
            with open(gt_file) as f:
                for line in f:
                    line = line.strip()
                    if not line or line.startswith("#"):
                        continue
                    v = [float(x) for x in line.split()]
                    gt_t.append(v[0])
                    gt_pos.append(v[1:4])
                    gt_quat.append(v[4:8])
        return cls(root=root, frames=frames,
                   gt_t=np.asarray(gt_t),
                   gt_pos=np.asarray(gt_pos).reshape(-1, 3),
                   gt_quat=np.asarray(gt_quat).reshape(-1, 4))

    def read(self, i: int) -> np.ndarray:
        """Frame i as float32 grayscale [H, W]."""
        import cv2
        img = cv2.imread(self.frames[i][1], cv2.IMREAD_GRAYSCALE)
        if img is None:
            raise FileNotFoundError(self.frames[i][1])
        return img.astype(np.float32)

    def gt_center_at(self, ts: float) -> Optional[np.ndarray]:
        """Nearest-timestamp ground-truth camera center (<= 20 ms off)."""
        if len(self.gt_t) == 0:
            return None
        i = int(np.argmin(np.abs(self.gt_t - ts)))
        if abs(self.gt_t[i] - ts) > 0.02:
            return None
        return self.gt_pos[i]


# ---------------------------------------------------------------------------
# KITTI odometry format
# ---------------------------------------------------------------------------

@dataclass
class KittiOdometryDataset:
    """KITTI odometry grayscale sequence (SURVEY §6 eval plan, seq 00).

    Layout (cvlibs.net/datasets/kitti/eval_odometry.php):
      image_0/NNNNNN.png   left grayscale frames
      times.txt            one timestamp per frame
      [poses.txt | <seq>.txt]  ground truth: 12 floats per line, the
                           row-major [3,4] T_w_cam matrix (cam->world)
    """

    root: str
    frames: List[str]
    times: np.ndarray          # [N]
    gt_T_wc: np.ndarray        # [G, 3, 4] (empty if no ground truth)

    @classmethod
    def load(cls, root: str,
             poses_file: Optional[str] = None) -> "KittiOdometryDataset":
        img_dir = os.path.join(root, "image_0")
        frames = [os.path.join(img_dir, f) for f in sorted(os.listdir(img_dir))
                  if f.endswith(".png")]
        times = []
        times_file = os.path.join(root, "times.txt")
        if os.path.exists(times_file):
            with open(times_file) as f:
                times = [float(line) for line in f if line.strip()]
        else:
            times = [i * 0.1 for i in range(len(frames))]   # 10 Hz nominal
        if poses_file is None:
            for cand in ("poses.txt", os.path.basename(root.rstrip("/"))
                         + ".txt"):
                p = os.path.join(root, cand)
                if os.path.exists(p):
                    poses_file = p
                    break
        gt = []
        if poses_file is not None and os.path.exists(poses_file):
            with open(poses_file) as f:
                for line in f:
                    v = [float(x) for x in line.split()]
                    if len(v) == 12:
                        gt.append(np.asarray(v).reshape(3, 4))
        return cls(root=root, frames=frames,
                   times=np.asarray(times, np.float64),
                   gt_T_wc=np.asarray(gt).reshape(-1, 3, 4))

    def read(self, i: int) -> np.ndarray:
        import cv2
        img = cv2.imread(self.frames[i], cv2.IMREAD_GRAYSCALE)
        if img is None:
            raise FileNotFoundError(self.frames[i])
        return img.astype(np.float32)

    def gt_center(self, i: int) -> Optional[np.ndarray]:
        """Ground-truth camera center of frame i (poses are cam->world,
        so the center is the translation column directly)."""
        if i >= len(self.gt_T_wc):
            return None
        return self.gt_T_wc[i][:3, 3]


# ---------------------------------------------------------------------------
# real-texture planar-room sequence
# ---------------------------------------------------------------------------

DEFAULT_PHOTO = "doc/dual_camera_model.jpg"


def _photo_tile(path: str, size: int, rng: np.random.Generator) -> np.ndarray:
    """A [size, size] texture mosaicked from random crops of a real photo.

    Each cell takes a crop at a random scale/rotation/flip with a random
    gain+bias: the PLACES stay visually distinct (crucial — building every
    wall from near-identical crops of one photo creates worst-case
    perceptual aliasing that defeats any place recognizer, including the
    reference's) while every pixel keeps real photographic statistics."""
    import cv2
    img = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
    if img is None:
        raise FileNotFoundError(path)
    img = img.astype(np.float32)
    H, W = img.shape
    cell = size // 4
    tile = np.zeros((size, size), np.float32)
    for y in range(0, size, cell):
        for x in range(0, size, cell):
            c = int(rng.integers(cell // 2, min(H, W) - 1))
            yy = int(rng.integers(0, H - c))
            xx = int(rng.integers(0, W - c))
            crop = img[yy:yy + c, xx:xx + c]
            crop = cv2.resize(crop, (cell, cell),
                              interpolation=cv2.INTER_AREA)
            crop = np.rot90(crop, int(rng.integers(4)))
            if rng.uniform() < 0.5:
                crop = crop[:, ::-1]
            gain = rng.uniform(0.55, 1.15)
            bias = rng.uniform(-25.0, 25.0)
            crop = np.clip(crop * gain + bias, 0.0, 255.0)
            tile[y:y + cell, x:x + cell] = crop
    return tile


@dataclass(frozen=True)
class _Plane:
    """Textured world plane: X(u, v) = P0 + u * e1 + v * e2, with the
    texture image spanning (u, v) in [0, 1]^2."""

    P0: np.ndarray
    e1: np.ndarray
    e2: np.ndarray
    tex: np.ndarray      # [th, tw] float32


def _render_plane(plane: _Plane, K: np.ndarray, T_cw: np.ndarray,
                  H: int, W: int):
    """Exact pinhole image of a textured plane via the plane-induced
    homography, warped by cv2 (no in-repo ray tracing).  Returns
    (image [H, W], depth [H, W]) with depth = +inf where the plane does
    not project."""
    import cv2
    th, tw = plane.tex.shape
    R, t = T_cw[:3, :3], T_cw[:3, 3]
    # texture pixel (x, y) -> world: P0 + (x/(tw-1)) e1 + (y/(th-1)) e2
    A = np.stack([plane.e1 / (tw - 1), plane.e2 / (th - 1), plane.P0], 1)
    Hmat = K @ (R @ A + np.outer(t, [0.0, 0.0, 1.0]))   # tex -> image
    img = cv2.warpPerspective(
        plane.tex, Hmat.astype(np.float64), (W, H),
        flags=cv2.INTER_LINEAR,
        borderMode=cv2.BORDER_CONSTANT, borderValue=-1.0)
    # per-pixel depth of the plane: z(u) solved from the inverse warp
    Hinv = np.linalg.inv(Hmat)
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float64)
    ones = np.ones_like(xs)
    q = np.stack([xs, ys, ones], -1) @ Hinv.T           # tex homogeneous
    w = q[..., 2]
    with np.errstate(divide="ignore", invalid="ignore"):
        u = q[..., 0] / w
        v = q[..., 1] / w
        Xw = (plane.P0[None, None] + u[..., None] * plane.e1[None, None] /
              (tw - 1) + v[..., None] * plane.e2[None, None] / (th - 1))
        Xc = Xw @ R.T + t
        depth = Xc[..., 2]
    valid = (img >= 0) & (depth > 1e-6) & np.isfinite(depth)
    return np.where(valid, img, 0.0).astype(np.float32), \
        np.where(valid, depth, np.inf)


def photo_room_planes(photo: str = DEFAULT_PHOTO, half: float = 6.0,
                      height: float = 3.0, tex: int = 1024,
                      seed: int = 0) -> List[_Plane]:
    """Four real-textured walls of a box room (same geometry as the
    synthetic box world, texture from a real photograph)."""
    rng = np.random.default_rng(seed)
    h, y = half, height
    walls = [
        ([-h, -y, h], [2 * h, 0, 0], [0, 2 * y, 0]),     # z=+h
        ([h, -y, -h], [-2 * h, 0, 0], [0, 2 * y, 0]),    # z=-h
        ([h, -y, h], [0, 0, -2 * h], [0, 2 * y, 0]),     # x=+h
        ([-h, -y, -h], [0, 0, 2 * h], [0, 2 * y, 0]),    # x=-h
        ([-h, y, -h], [2 * h, 0, 0], [0, 0, 2 * h]),     # floor y=+h
        ([-h, -y, -h], [2 * h, 0, 0], [0, 0, 2 * h]),    # ceiling y=-h
    ]
    return [_Plane(P0=np.asarray(p, np.float64),
                   e1=np.asarray(e1, np.float64),
                   e2=np.asarray(e2, np.float64),
                   tex=_photo_tile(photo, tex, rng))
            for (p, e1, e2) in walls]


def planar_photo_sequence(poses: List[np.ndarray], K: np.ndarray,
                          H: int = 240, W: int = 320,
                          planes: Optional[List[_Plane]] = None,
                          photo: str = DEFAULT_PHOTO,
                          noise: float = 0.0,
                          seed: int = 0):
    """Yield (image [H, W] float32, T_cw) frames of the real-textured room
    along ground-truth `poses`, composed per-plane by z-buffer."""
    if planes is None:
        planes = photo_room_planes(photo, seed=seed)
    rng = np.random.default_rng(seed + 1)
    for T_cw in poses:
        img = np.zeros((H, W), np.float32)
        depth = np.full((H, W), np.inf)
        for pl in planes:
            im, d = _render_plane(pl, K, T_cw, H, W)
            closer = d < depth
            img = np.where(closer, im, img)
            depth = np.where(closer, d, depth)
        if noise > 0:
            img = img + rng.normal(0.0, noise, img.shape)
        yield np.clip(img, 0, 255).astype(np.float32), T_cw


def _render_photo_frame(planes: List[_Plane], K: np.ndarray,
                        T_cw: np.ndarray, H: int, W: int) -> np.ndarray:
    img = np.zeros((H, W), np.float32)
    depth = np.full((H, W), np.inf)
    for pl in planes:
        im, d = _render_plane(pl, K, T_cw, H, W)
        closer = d < depth
        img = np.where(closer, im, img)
        depth = np.where(closer, d, depth)
    return np.clip(img, 0, 255).astype(np.float32)


def planar_photo_rig_sequence(poses: List[np.ndarray], rig_K: np.ndarray,
                              rig_T_sc: np.ndarray, H: int = 240,
                              W: int = 320,
                              planes: Optional[List[_Plane]] = None,
                              photo: str = DEFAULT_PHOTO, seed: int = 0):
    """Dual(N)-camera version of `planar_photo_sequence`: yields
    (images [ncam, H, W], T_cw) with camera c rendered at T_sc[c] @ T_cw —
    the real-texture analog of synthetic.render_rig, and this repo's
    equivalent of the reference's dual indoor_lab_loop.avi input
    (Examples/Dual/dual_slam_video.cpp:68-86 splits one wide frame into
    the two rig views)."""
    if planes is None:
        planes = photo_room_planes(photo, seed=seed)
    ncam = len(rig_K)
    for T_cw in poses:
        ims = np.stack([
            _render_photo_frame(planes, np.asarray(rig_K[c]),
                                np.asarray(rig_T_sc[c]) @ T_cw, H, W)
            for c in range(ncam)])
        yield ims, T_cw
