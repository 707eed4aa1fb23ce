"""Two-view epipolar geometry: triangulation, fundamental matrices,
epipolar checks.

Port of orbslam2_dualcam_tpu/ops/epipolar.py: the reference's per-point
cv::SVD DLT triangulation (Initializer.cc:752-765, LocalMapping.cc:384-420)
and the cross-keyframe fundamental-matrix composition ComputeF12
(LocalMapping.cc:812-873) as batched closed-form tensor code.
"""

from __future__ import annotations

import torch

from orbslam2_dualcam_tpu_torch.ops import lie


def triangulate_dlt(P1: torch.Tensor, P2: torch.Tensor, uv1: torch.Tensor,
                    uv2: torch.Tensor) -> torch.Tensor:
    """Linear DLT triangulation for point batches.

    P1, P2: (3, 4) projection matrices (K [R|t]); uv1, uv2: (..., 2) pixels.
    Returns (..., 3) world points: the smallest right singular vector of
    the row-normalized 4x4 DLT system (the normal-equation shortcut A^T A
    squares the condition number, which float32 cannot afford).  The sign
    of the singular vector cancels in the dehomogenization."""
    def row(P, u, axis):
        return u[..., None] * P[2] - P[axis]

    A = torch.stack([
        row(P1, uv1[..., 0], 0),
        row(P1, uv1[..., 1], 1),
        row(P2, uv2[..., 0], 0),
        row(P2, uv2[..., 1], 1),
    ], dim=-2)                                    # (..., 4, 4)
    A = A / torch.clamp(torch.linalg.vector_norm(A, dim=-1, keepdim=True),
                        min=1e-12)
    _, _, Vt = torch.linalg.svd(A)
    X = Vt[..., 3, :]                             # smallest singular vector
    wcomp = X[..., 3]
    wsafe = torch.where(wcomp.abs() > 1e-12, wcomp,
                        torch.full_like(wcomp, 1e-12))
    return X[..., :3] / wsafe[..., None]


def projection_matrix(K: torch.Tensor, T_cw: torch.Tensor) -> torch.Tensor:
    """K [R|t] from intrinsics and world->camera transform."""
    return K @ T_cw[:3, :4]


def _inv_K(K: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of an upper-triangular pinhole matrix
    [[fx, s, cx], [0, fy, cy], [0, 0, 1]] (no host-side singularity check,
    unlike torch.linalg.inv)."""
    fx, fy, s = K[0, 0], K[1, 1], K[0, 1]
    cx, cy = K[0, 2], K[1, 2]
    z = torch.zeros_like(fx)
    o = torch.ones_like(fx)
    return torch.stack([
        torch.stack([1.0 / fx, -s / (fx * fy), (s * cy - cx * fy) / (fx * fy)]),
        torch.stack([z, 1.0 / fy, -cy / fy]),
        torch.stack([z, z, o])])


def fundamental_from_poses(K1: torch.Tensor, T_1w: torch.Tensor,
                           K2: torch.Tensor, T_2w: torch.Tensor) -> torch.Tensor:
    """F12 such that x1^T F12 x2 = 0 for corresponding pixels.

    Matches LocalMapping::ComputeF12 (LocalMapping.cc:812-873): with
    T_12 = T_1w inv(T_2w), F12 = K1^-T [t12]x R12 K2^-1."""
    T_12 = T_1w @ lie.se3_inv(T_2w)
    E = lie.hat(T_12[:3, 3]) @ T_12[:3, :3]
    return _inv_K(K1).T @ E @ _inv_K(K2)


def epipolar_dist2(F12: torch.Tensor, uv1: torch.Tensor,
                   uv2: torch.Tensor) -> torch.Tensor:
    """Squared distance of x2 to the epipolar line of x1 (ORBmatcher.cc
    CheckDistEpipolarLine semantics)."""
    x1 = torch.cat([uv1, torch.ones_like(uv1[..., :1])], dim=-1)
    line = x1 @ F12                                  # l2 = F12^T x1  (a,b,c)
    num = line[..., 0] * uv2[..., 0] + line[..., 1] * uv2[..., 1] + line[..., 2]
    den = line[..., 0] ** 2 + line[..., 1] ** 2
    return num * num / torch.where(den > 1e-12, den, torch.full_like(den, 1e-12))


def triangulation_checks(T_1w: torch.Tensor, T_2w: torch.Tensor,
                         X: torch.Tensor, K1: torch.Tensor, K2: torch.Tensor,
                         uv1: torch.Tensor, uv2: torch.Tensor,
                         sigma2_1: torch.Tensor, sigma2_2: torch.Tensor,
                         chi2: float = 5.991,
                         min_parallax_cos: float = 0.9998) -> torch.Tensor:
    """Cheirality, parallax, and reprojection gates used when creating new
    map points (LocalMapping.cc:384-470).  Returns a bool mask."""
    c1 = -T_1w[:3, :3].T @ T_1w[:3, 3]
    c2 = -T_2w[:3, :3].T @ T_2w[:3, 3]
    ray1 = X - c1
    ray2 = X - c2
    cosp = (ray1 * ray2).sum(-1) / (
        torch.linalg.vector_norm(ray1, dim=-1) *
        torch.linalg.vector_norm(ray2, dim=-1) + 1e-12)
    x1 = lie.se3_apply(T_1w, X)
    x2 = lie.se3_apply(T_2w, X)

    def reproj_err2(K, xc, uv):
        z = torch.where(xc[..., 2] > 1e-9, xc[..., 2],
                        torch.full_like(xc[..., 2], 1e-9))
        u = K[0, 0] * xc[..., 0] / z + K[0, 2]
        v = K[1, 1] * xc[..., 1] / z + K[1, 2]
        return (u - uv[..., 0]) ** 2 + (v - uv[..., 1]) ** 2

    ok = (x1[..., 2] > 0) & (x2[..., 2] > 0)
    ok = ok & (cosp < min_parallax_cos)
    ok = ok & (reproj_err2(K1, x1, uv1) < chi2 * sigma2_1)
    ok = ok & (reproj_err2(K2, x2, uv2) < chi2 * sigma2_2)
    return ok
