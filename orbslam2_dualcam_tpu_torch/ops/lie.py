"""SO3 / SE3 / Sim3 Lie-group operations on torch tensors.

Port of orbslam2_dualcam_tpu/ops/lie.py with the same conventions: 4x4
homogeneous transforms, ``T @ [x;1]`` maps source -> destination;
quaternions are (w, x, y, z); se3 tangents are ``[rho(3), phi(3)]`` (g2o's
SE3Quat::exp layout) and sim3 tangents ``[rho(3), phi(3), sigma(1)]`` with
scale ``s = exp(sigma)``.

hat, the SO3 and Sim3 functions, quat_to_rot and se3_exp work over any
leading axes: a single transform is the case of none, where the reference
would vmap.  The rest is unbatched on its trailing axes, as in the
reference.

The reference selects its series and closed forms with ``jnp.where``,
which evaluates both sides; here too both sides are computed and selected
with ``torch.where``, with the reference's guards, so neither side is ever
NaN or inf and nothing is read back to the host.  The Sim3 functions are
free of in-place writes and of Python branches on data, so
``torch.func.jacfwd`` traces them.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def hat(v: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix of 3-vectors, [..., 3] -> [..., 3, 3]:
    hat(v) @ x == cross(v, x)."""
    z = torch.zeros_like(v[..., 0])
    return torch.stack([
        torch.stack([z, -v[..., 2], v[..., 1]], -1),
        torch.stack([v[..., 2], z, -v[..., 0]], -1),
        torch.stack([-v[..., 1], v[..., 0], z], -1)], -2)


def _so3_coeffs(phi: torch.Tensor):
    """(a, b, c) [..., 1, 1] of R = I + a K + b K^2 and of the left Jacobian
    V = I + b K + c K^2, Taylor-safe at 0."""
    theta2 = (phi * phi).sum(-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    small = theta2 <= _EPS
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / theta2)
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta)) / (theta2 * theta))
    return a[..., None, None], b[..., None, None], c[..., None, None]


def so3_exp(phi: torch.Tensor) -> torch.Tensor:
    """Rodrigues: axis-angle [..., 3] -> rotation matrices [..., 3, 3]."""
    a, b, _ = _so3_coeffs(phi)
    K = hat(phi)
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device)
    return eye + a * K + b * (K @ K)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrices [..., 3, 3] -> axis-angle [..., 3] (principal
    branch).

    cos is clipped strictly inside (-1, 1), as in the reference (where it
    keeps the arccos derivative finite at the identity)."""
    diagR = torch.diagonal(R, dim1=-2, dim2=-1)
    cos_t = torch.clamp((diagR.sum(-1) - 1.0) * 0.5, -1.0 + 1e-7, 1.0 - 1e-7)
    theta = torch.acos(cos_t)
    w = torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], -1)
    # theta / (2 sin theta), series-safe near 0
    sin_t = torch.sin(theta)
    scale = torch.where(sin_t.abs() > 1e-5, theta / (2.0 * sin_t + _EPS),
                        0.5 + theta * theta / 12.0)
    small = scale[..., None] * w
    # near pi |w| ~ 0 but the rotation is large.  R + R^T =
    # 2cos(t) I + 2(1-cos t) nn^T, so the off-diagonal sums give the sign
    # pattern n_i n_j: anchor the largest-magnitude component positive and
    # read the other signs from its row of (R + R^T)
    diag = torch.clamp((diagR - cos_t[..., None])
                       / (1.0 - cos_t[..., None] + _EPS), min=0.0)
    axis_mag = torch.sqrt(diag + _EPS)
    is_k = (torch.arange(3, device=R.device)
            == torch.argmax(diag, dim=-1, keepdim=True))
    row_k = ((R + R.transpose(-1, -2)) * is_k[..., :, None].to(R.dtype)).sum(-2)
    signs = torch.where(is_k, torch.ones_like(row_k), torch.sign(row_k + _EPS))
    big = theta[..., None] * axis_mag * signs
    return torch.where((theta < 3.0)[..., None], small, big)


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternions (w,x,y,z) [..., 4] -> rotation matrices [..., 3, 3]."""
    q = q / (torch.linalg.vector_norm(q, dim=-1, keepdim=True) + _EPS)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], -2)


def rot_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> unit quaternion (w,x,y,z), branchless Shepperd."""
    t = torch.trace(R)
    qw = torch.sqrt(torch.clamp(1.0 + t, min=_EPS)) * 0.5
    qx = torch.sqrt(torch.clamp(1.0 + R[0, 0] - R[1, 1] - R[2, 2], min=_EPS)) * 0.5
    qy = torch.sqrt(torch.clamp(1.0 - R[0, 0] + R[1, 1] - R[2, 2], min=_EPS)) * 0.5
    qz = torch.sqrt(torch.clamp(1.0 - R[0, 0] - R[1, 1] + R[2, 2], min=_EPS)) * 0.5
    qx = qx * torch.sign(R[2, 1] - R[1, 2] + _EPS)
    qy = qy * torch.sign(R[0, 2] - R[2, 0] + _EPS)
    qz = qz * torch.sign(R[1, 0] - R[0, 1] + _EPS)
    q = torch.stack([qw, qx, qy, qz])
    return q / (torch.linalg.vector_norm(q) + _EPS)


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


def se3_apply(T: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Apply to points with trailing dim 3; x may be (..., 3)."""
    return x @ T[:3, :3].T + T[:3, 3]


def _V_matrix(phi: torch.Tensor) -> torch.Tensor:
    """Left Jacobian of SO3 (the 'V' in se3 exp), [..., 3] -> [..., 3, 3]."""
    _, b, c = _so3_coeffs(phi)
    K = hat(phi)
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device)
    return eye + b * K + c * (K @ K)


def _pack(A: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3], [..., 3] -> [..., 4, 4] = [[A, t], [0, 1]], by
    concatenation: no in-place write (torch.func traces it) and no scalar
    fill (which synchronizes the host on a CUDA tensor)."""
    top = torch.cat([A, t[..., :, None]], dim=-1)
    bot = torch.cat([torch.zeros_like(top[..., :1, :3]),
                     torch.ones_like(top[..., :1, :1])], dim=-1)
    return torch.cat([top, bot], dim=-2)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """se3 tangents [..., 6] = [rho, phi] -> transforms [..., 4, 4] (g2o
    SE3Quat::exp layout)."""
    rho, phi = xi[..., :3], xi[..., 3:6]
    return _pack(so3_exp(phi), (_V_matrix(phi) @ rho[..., None])[..., 0])


def se3_log(T: torch.Tensor) -> torch.Tensor:
    phi = so3_log(T[:3, :3])
    rho = torch.linalg.solve(_V_matrix(phi), T[:3, 3])
    return torch.cat([rho, phi])


def se3_adjoint(T: torch.Tensor) -> torch.Tensor:
    """6x6 adjoint with the reference's block layout [[R, hat(t) R], [0, R]]
    (rows/cols ordered [trans, rot]); satisfies
    se3_exp(Adj(T) @ xi) == T @ se3_exp(xi) @ inv(T)."""
    R = T[:3, :3]
    t = T[:3, 3]
    top = torch.cat([R, hat(t) @ R], dim=1)
    bot = torch.cat([torch.zeros_like(R), R], dim=1)
    return torch.cat([top, bot], dim=0)


# 3x3 determinant and inverse in closed form

def det3(A: torch.Tensor) -> torch.Tensor:
    """Determinant of [..., 3, 3] by cofactors."""
    return (A[..., 0, 0] * (A[..., 1, 1] * A[..., 2, 2] - A[..., 1, 2] * A[..., 2, 1])
            - A[..., 0, 1] * (A[..., 1, 0] * A[..., 2, 2] - A[..., 1, 2] * A[..., 2, 0])
            + A[..., 0, 2] * (A[..., 1, 0] * A[..., 2, 1] - A[..., 1, 1] * A[..., 2, 0]))


def inv3(A: torch.Tensor) -> torch.Tensor:
    """Inverse of [..., 3, 3] by the adjugate; inf/nan where singular (no
    host-side singularity check, unlike torch.linalg.inv)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    c00, c01, c02 = e * i - f * h, c * h - b * i, b * f - c * e
    c10, c11, c12 = f * g - d * i, a * i - c * g, c * d - a * f
    c20, c21, c22 = d * h - e * g, b * g - a * h, a * e - b * d
    det = a * c00 + b * c10 + c * c20
    adj = torch.stack([torch.stack([c00, c01, c02], -1),
                       torch.stack([c10, c11, c12], -1),
                       torch.stack([c20, c21, c22], -1)], -2)
    return adj / det[..., None, None]


# ---------------------------------------------------------------------------
# Sim3, over leading axes
# ---------------------------------------------------------------------------

def sim3(R: torch.Tensor, t: torch.Tensor, s) -> torch.Tensor:
    """[..., 3, 3], [..., 3], [...] -> [..., 4, 4] = [[sR, t], [0, 1]]."""
    if not torch.is_tensor(s):
        s = torch.full((), float(s), dtype=R.dtype, device=R.device)
    return _pack(s[..., None, None] * R, t)


def sim3_parts(S: torch.Tensor):
    """Unpack [[sR, t],[0,1]] [..., 4, 4] -> (R [..., 3, 3], t [..., 3],
    s [...])."""
    sR = S[..., :3, :3]
    s = torch.exp(torch.log(det3(sR) + _EPS) / 3.0)
    return sR / s[..., None, None], S[..., :3, 3], s


def sim3_inv(S: torch.Tensor) -> torch.Tensor:
    R, t, s = sim3_parts(S)
    Rt = R.transpose(-1, -2)
    return sim3(Rt, -(Rt @ t[..., :, None])[..., 0] / s[..., None], 1.0 / s)


def sim3_apply(S: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return x @ S[:3, :3].T + S[:3, 3]


def _sim3_W(phi: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """The closed-form W of sim3_exp, t = W rho (Ethan Eade's Lie-group
    notes): phi [..., 3], sigma [...] -> [..., 3, 3]."""
    s = torch.exp(sigma)
    theta2 = (phi * phi).sum(-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    K = hat(phi)
    # coefficients of W = A I + b K + c K^2
    sig2 = sigma * sigma
    small_sig = sigma.abs() < 1e-4
    small_th = theta2 < _EPS
    one = torch.ones_like(sigma)
    A = torch.where(small_sig, 1.0 + sigma / 2.0 + sig2 / 6.0,
                    (s - 1.0) / torch.where(small_sig, one, sigma))
    # b, c terms mixing sigma and theta (series-safe)
    denom = sig2 + theta2 + _EPS * _EPS
    esin = s * torch.sin(theta)
    ecos = s * torch.cos(theta)
    b_big = (sigma * esin + theta * (1.0 - ecos)) / (theta * denom + _EPS)
    c_big = (A - (ecos - 1.0) * sigma / denom - esin * theta / denom) / (theta2 + _EPS)
    b_small = torch.where(small_sig, 0.5 + sigma / 3.0,
                          (sigma * s - s + 1.0) / torch.where(small_sig, one, sig2))
    c_small = torch.where(
        small_sig, 1.0 / 6.0 + sigma / 8.0,
        (s * (0.5 * sig2 - sigma + 1.0) - 1.0)
        / torch.where(small_sig, one, sig2 * sigma + _EPS))
    b = torch.where(small_th, b_small, b_big)
    c = torch.where(small_th, c_small, c_big)
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device)
    return (A[..., None, None] * eye + b[..., None, None] * K
            + c[..., None, None] * (K @ K))


def sim3_exp(xi: torch.Tensor) -> torch.Tensor:
    """sim3 tangents [..., 7] = [rho, phi, sigma] -> similarities
    [..., 4, 4]."""
    rho, phi, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    W = _sim3_W(phi, sigma)
    return sim3(so3_exp(phi), (W @ rho[..., :, None])[..., 0], torch.exp(sigma))


def sim3_log(S: torch.Tensor) -> torch.Tensor:
    """Inverse of sim3_exp, [..., 4, 4] -> [..., 7]: W is rebuilt from
    (phi, sigma) and inverted by the adjugate (no host-side singularity
    check)."""
    R, t, s = sim3_parts(S)
    phi = so3_log(R)
    sigma = torch.log(s)
    rho = (inv3(_sim3_W(phi, sigma)) @ t[..., :, None])[..., 0]
    return torch.cat([rho, phi, sigma[..., None]], dim=-1)
