"""SO3 / SE3 operations on torch tensors (the subset the tracking step uses).

Port of orbslam2_dualcam_tpu/ops/lie.py with the same conventions: 4x4
homogeneous transforms, ``T @ [x;1]`` maps source -> destination, and se3
tangents ordered ``[rho(3), phi(3)]`` (g2o's SE3Quat::exp layout).  Every
function is unbatched on its trailing axes, as in the reference.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def hat(v: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix of a 3-vector: hat(v) @ x == cross(v, x)."""
    z = torch.zeros((), dtype=v.dtype, device=v.device)
    return torch.stack([
        torch.stack([z, -v[2], v[1]]),
        torch.stack([v[2], z, -v[0]]),
        torch.stack([-v[1], v[0], z]),
    ])


def so3_exp(phi: torch.Tensor) -> torch.Tensor:
    """Rodrigues: axis-angle 3-vector -> rotation matrix (Taylor-safe)."""
    theta2 = torch.dot(phi, phi)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    K = hat(phi)
    small = theta2 <= _EPS
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / theta2)
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device)
    return eye + a * K + b * (K @ K)


def se3(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Assemble a 4x4 transform from R (3,3) and t (3,)."""
    T = torch.eye(4, dtype=R.dtype, device=R.device)
    T[:3, :3] = R
    T[:3, 3] = t
    return T


def se3_inv(T: torch.Tensor) -> torch.Tensor:
    R = T[:3, :3]
    t = T[:3, 3]
    return se3(R.T, -R.T @ t)


def _V_matrix(phi: torch.Tensor) -> torch.Tensor:
    """Left Jacobian of SO3 (the 'V' in se3 exp)."""
    theta2 = torch.dot(phi, phi)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    K = hat(phi)
    small = theta2 <= _EPS
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / theta2)
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta)) / (theta2 * theta))
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device)
    return eye + b * K + c * (K @ K)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """se3 tangent [rho, phi] -> 4x4 transform (g2o SE3Quat::exp layout)."""
    rho, phi = xi[:3], xi[3:6]
    return se3(so3_exp(phi), _V_matrix(phi) @ rho)


def se3_adjoint(T: torch.Tensor) -> torch.Tensor:
    """6x6 adjoint with the reference's block layout [[R, hat(t) R], [0, R]]
    (rows/cols ordered [trans, rot]); satisfies
    se3_exp(Adj(T) @ xi) == T @ se3_exp(xi) @ inv(T)."""
    R = T[:3, :3]
    t = T[:3, 3]
    top = torch.cat([R, hat(t) @ R], dim=1)
    bot = torch.cat([torch.zeros_like(R), R], dim=1)
    return torch.cat([top, bot], dim=0)
