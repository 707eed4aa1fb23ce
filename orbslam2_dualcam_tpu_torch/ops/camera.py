"""Camera rig model: intrinsics, distortion, extrinsics, projection.

Port of orbslam2_dualcam_tpu/ops/camera.py.  The rig is a NamedTuple of
stacked per-camera tensors ``[ncam, ...]`` on one device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from orbslam2_dualcam_tpu_torch.utils.config import SystemConfig
from orbslam2_dualcam_tpu_torch.utils.device import resolve_device
from orbslam2_dualcam_tpu_torch.ops import lie


class CameraRig(NamedTuple):
    """Stacked rig calibration. All leaves have leading dim ncam.

    T_sc maps rig-capture-frame (camera 0) points into sibling camera s:
    ``x_s = T_sc[s] @ x_c``, so camera s's world pose is
    ``T_sw = T_sc[s] @ T_cw``."""

    K: torch.Tensor          # [ncam, 3, 3] intrinsics
    K_inv: torch.Tensor      # [ncam, 3, 3]
    dist: torch.Tensor       # [ncam, 5] k1 k2 p1 p2 k3
    T_sc: torch.Tensor       # [ncam, 4, 4] capture -> sibling
    T_cs: torch.Tensor       # [ncam, 4, 4] sibling -> capture (inverse)
    adj_sc: torch.Tensor     # [ncam, 6, 6] Adjoint(T_sc)
    bounds: torch.Tensor     # [ncam, 4] undistorted (min_x, max_x, min_y, max_y)
    wh: torch.Tensor         # [ncam, 2] pixel width,height

    @property
    def n_cameras(self) -> int:
        return self.K.shape[0]


def make_rig(cfg: SystemConfig, device=None, dtype=torch.float32) -> CameraRig:
    """The rig of `cfg.cameras` on `device` (None: the current CUDA device)."""
    device = resolve_device(device)
    Ks, dists, Tscs, whs = [], [], [], []
    for cam in cfg.cameras:
        Ks.append(np.array([[cam.fx, 0, cam.cx], [0, cam.fy, cam.cy],
                            [0, 0, 1]], np.float64))
        dists.append(np.asarray(cam.dist, np.float64))
        q = np.asarray(cam.q_sc, np.float64)
        q /= np.linalg.norm(q)
        w, x, y, z = q
        R = np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ])
        T = np.eye(4)
        T[:3, :3] = R
        T[:3, 3] = cam.t_sc
        Tscs.append(T)
        whs.append((cam.width, cam.height))

    def dev(a):
        return torch.as_tensor(np.stack(a), dtype=dtype, device=device)

    K = dev(Ks)
    T_sc = dev(Tscs)
    rig = CameraRig(
        K=K, K_inv=torch.linalg.inv(K), dist=dev(dists), T_sc=T_sc,
        T_cs=torch.stack([lie.se3_inv(T) for T in T_sc]),
        adj_sc=torch.stack([lie.se3_adjoint(T) for T in T_sc]),
        bounds=torch.zeros((K.shape[0], 4), dtype=dtype, device=device),
        wh=dev(whs))
    return rig._replace(bounds=_compute_bounds(rig))


# ---------------------------------------------------------------------------
# distortion
# ---------------------------------------------------------------------------

def undistort(xd: torch.Tensor, dist: torch.Tensor,
              iters: int = 8) -> torch.Tensor:
    """Invert the radial-tangential distortion of normalized coords (..., 2)
    by fixed-point iteration (cv::undistortPoints-style).  `dist` is [5]
    or broadcastable [..., 5] against xd's leading axes."""
    k1, k2, p1, p2, k3 = dist.unbind(-1)
    xy = xd
    for _ in range(iters):
        x, y = xy[..., 0], xy[..., 1]
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        dx = 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        dy = p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
        xy = torch.stack([(xd[..., 0] - dx) / radial,
                          (xd[..., 1] - dy) / radial], dim=-1)
    return xy


def undistort_pixels(uv: torch.Tensor, K: torch.Tensor, K_inv: torch.Tensor,
                     dist: torch.Tensor) -> torch.Tensor:
    """Pixel coords (..., 2) -> undistorted pixel coords under the same K."""
    xn = uv @ K_inv[:2, :2].T + K_inv[:2, 2]
    xu = undistort(xn, dist)
    return xu @ K[:2, :2].T + K[:2, 2]


def _compute_bounds(rig: CameraRig) -> torch.Tensor:
    """Undistorted image bounds per camera (Frame.cc:454-484)."""
    out = []
    for c in range(rig.n_cameras):
        w, h = rig.wh[c, 0], rig.wh[c, 1]
        z = torch.zeros_like(w)
        corners = torch.stack([torch.stack([z, z]), torch.stack([w, z]),
                               torch.stack([z, h]), torch.stack([w, h])])
        cu = undistort_pixels(corners, rig.K[c], rig.K_inv[c], rig.dist[c])
        out.append(torch.stack([cu[:, 0].min(), cu[:, 0].max(),
                                cu[:, 1].min(), cu[:, 1].max()]))
    return torch.stack(out)


# ---------------------------------------------------------------------------
# projection
# ---------------------------------------------------------------------------

def project_rig(rig: CameraRig, cam, T_cw: torch.Tensor,
                x_world: torch.Tensor):
    """Project world points through rig pose into camera `cam` (an int or
    an int tensor broadcastable against the points' leading axes).

    Returns (uv, z) where z is the depth in the sibling camera frame."""
    T_sw = rig.T_sc[cam] @ T_cw
    x_cam = (torch.einsum('...ij,...j->...i', T_sw[..., :3, :3], x_world)
             + T_sw[..., :3, 3])
    K = rig.K[cam]
    z = x_cam[..., 2]
    zc = torch.where(z.abs() > 1e-9, z, torch.full_like(z, 1e-9))
    u = K[..., 0, 0] * x_cam[..., 0] / zc + K[..., 0, 2]
    v = K[..., 1, 1] * x_cam[..., 1] / zc + K[..., 1, 2]
    return torch.stack([u, v], dim=-1), z


def in_image(rig: CameraRig, cam, uv: torch.Tensor) -> torch.Tensor:
    """Inside undistorted image bounds (Frame.cc:265-272 semantics)."""
    b = rig.bounds[cam]
    return ((uv[..., 0] >= b[..., 0]) & (uv[..., 0] <= b[..., 1]) &
            (uv[..., 1] >= b[..., 2]) & (uv[..., 1] <= b[..., 3]))
