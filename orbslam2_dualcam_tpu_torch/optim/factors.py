"""Reprojection factors with analytic Jacobians, including the dual-camera
extrinsic-adjoint factor.

Port of orbslam2_dualcam_tpu/optim/factors.py, the reference's modified g2o
edge types (Thirdparty/g2o/g2o/types/types_six_dof_expmap.cpp:103-247):

    error    = obs - pi_c( T_sc[c] * T_cw * X )
    J_pose   = (standard SE3 reprojection Jacobian at x_s) @ Adj(T_sc)

One pose vertex per rig (camera-0 frame) while each observation may come
from any sibling camera; the chain rule through the fixed extrinsic is a
right-multiplication by the 6x6 SE3 adjoint of T_sc.

Every function takes any leading axes (the reference writes them per edge
and vmaps).  Tangent convention: xi = [rho, phi], update
T_cw <- exp(xi) * T_cw (g2o's VertexSE3Expmap::oplusImpl).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from orbslam2_dualcam_tpu_torch.ops import lie


def _apply(T: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """T [..., 4, 4] applied to x [..., 3], edge by edge."""
    return (T[..., :3, :3] @ x[..., None])[..., 0] + T[..., :3, 3]


def _safe_z(z: torch.Tensor) -> torch.Tensor:
    return torch.where(z.abs() > 1e-9, z, torch.full_like(z, 1e-9))


def reproject_error(T_cw: torch.Tensor, X: torch.Tensor, uv: torch.Tensor,
                    T_sc: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Residual e = uv - pi(K, T_sc T_cw X).  [..., 2]"""
    x_s = _apply(T_sc, _apply(T_cw, X))
    z = _safe_z(x_s[..., 2])
    u = K[..., 0, 0] * x_s[..., 0] / z + K[..., 0, 2]
    v = K[..., 1, 1] * x_s[..., 1] / z + K[..., 1, 2]
    return uv - torch.stack([u, v], -1)


def _proj_jacobian(x_s: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """d(pi)/d(x_s): [..., 2, 3] pinhole projection Jacobian."""
    fx, fy = K[..., 0, 0], K[..., 1, 1]
    x, y = x_s[..., 0], x_s[..., 1]
    iz = 1.0 / _safe_z(x_s[..., 2])
    iz2 = iz * iz
    zeros = torch.zeros_like(iz)
    return torch.stack([
        torch.stack([fx * iz, zeros, -fx * x * iz2], -1),
        torch.stack([zeros, fy * iz, -fy * y * iz2], -1)], -2)


def reproject_jacobians(T_cw: torch.Tensor, X: torch.Tensor,
                        T_sc: torch.Tensor, adj_sc: torch.Tensor,
                        K: torch.Tensor):
    """Analytic Jacobians of the residual: (J_pose [..., 2, 6],
    J_point [..., 2, 3]).

    J_pose is the derivative w.r.t. the left-multiplicative rig-pose update
    exp(xi) T_cw: the standard unary SE3 Jacobian at x_s = T_sc T_cw X,
    -J_pi [I | -hat(x_s)], right-multiplied by Adj(T_sc)
    (types_six_dof_expmap.cpp:144-159)."""
    x_s = _apply(T_sc, _apply(T_cw, X))
    Jpi = _proj_jacobian(x_s, K)
    J_std = torch.cat([-Jpi, Jpi @ lie.hat(x_s)], -1)      # [..., 2, 6]
    J_pose = J_std @ adj_sc
    R_sw = T_sc[..., :3, :3] @ T_cw[..., :3, :3]
    J_point = -Jpi @ R_sw
    return J_pose, J_point


def huber_weight(chi2: torch.Tensor, delta2: float) -> torch.Tensor:
    """IRLS weight of the Huber kernel on squared error: w = 1 inside,
    delta/sqrt(chi2) outside (g2o RobustKernelHuber semantics)."""
    return torch.where(chi2 <= delta2, torch.ones_like(chi2),
                       torch.sqrt(delta2 / torch.clamp(chi2, min=1e-12)))


class Edges(NamedTuple):
    """Padded observation table for BA problems (replaces g2o edge lists).

    One row = one (keyframe, mappoint, camera) observation."""

    kf: torch.Tensor       # [E] int64 pose index
    mp: torch.Tensor       # [E] int64 point index
    cam: torch.Tensor      # [E] int64 camera index in the rig
    uv: torch.Tensor       # [E, 2] measured undistorted pixels
    inv_sigma2: torch.Tensor  # [E] information scalar (1/sigma^2 per level)
    valid: torch.Tensor    # [E] bool


def edge_residuals_jacobians(poses: torch.Tensor, points: torch.Tensor,
                             edges: Edges, T_sc: torch.Tensor,
                             adj_sc: torch.Tensor, Ks: torch.Tensor):
    """Residual + Jacobian evaluation over all edges.

    poses [K,4,4], points [M,3]; T_sc/adj_sc/Ks indexed by edges.cam.
    Returns (r [E,2], J_pose [E,2,6], J_point [E,2,3])."""
    T = poses[edges.kf]
    X = points[edges.mp]
    Tsc = T_sc[edges.cam]
    K = Ks[edges.cam]
    r = reproject_error(T, X, edges.uv, Tsc, K)
    Jp, Jx = reproject_jacobians(T, X, Tsc, adj_sc[edges.cam], K)
    return r, Jp, Jx
