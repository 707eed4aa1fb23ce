"""Motion-only pose optimization (frame-to-map).

Port of orbslam2_dualcam_tpu/optim/pose_opt.py: unary reprojection edges
through the extrinsic adjoint, run as `pose_rounds` x `pose_iters`
Levenberg-Marquardt with Huber weights and chi-square re-classification
between rounds; the robust kernel is dropped in the final round.  The LM
loop keeps the reference's deferred acceptance: each iteration evaluates
residuals once, at the trial pose, and steps from the best state so far.

Everything stays on the device: acceptance is a tensor select, never a
host branch.  On the card this is a few thousand tiny kernels per call,
so it is bound by launch latency, not by arithmetic.
"""

from __future__ import annotations

import torch

from orbslam2_dualcam_tpu_torch.utils.config import BAConfig
from orbslam2_dualcam_tpu_torch.ops import lie
from orbslam2_dualcam_tpu_torch.optim import factors


def chol_solve6(H: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cholesky solve of the 6x6 damped SPD normal system, column by
    column (the pivot is clamped at 1e-12 as in the reference)."""
    L = torch.zeros_like(H)
    for j in range(6):
        d = torch.sqrt(torch.clamp(H[j, j] - (L[j, :j] * L[j, :j]).sum(),
                                   min=1e-12))
        L[j, j] = d
        L[j + 1:, j] = (H[j + 1:, j] - L[j + 1:, :j] @ L[j, :j]) / d
    y = torch.zeros_like(b)
    for i in range(6):
        y[i] = (b[i] - L[i, :i] @ y[:i]) / L[i, i]
    x = torch.zeros_like(b)
    for i in reversed(range(6)):
        x[i] = (y[i] - L[i + 1:, i] @ x[i + 1:]) / L[i, i]
    return x


def optimize_pose(T_cw0: torch.Tensor, X: torch.Tensor, uv: torch.Tensor,
                  cam: torch.Tensor, inv_sigma2: torch.Tensor,
                  valid: torch.Tensor, T_sc: torch.Tensor,
                  adj_sc: torch.Tensor, Ks: torch.Tensor,
                  cfg: BAConfig = BAConfig()):
    """Optimize one rig pose against fixed 3D points.

    T_cw0 [4,4]; X [N,3] world points; uv [N,2]; cam [N] camera index;
    inv_sigma2 [N]; valid [N] bool; T_sc/adj_sc/Ks [ncam,...] rig tables.
    Returns (T_cw, inlier [N] bool, n_inliers)."""
    Tsc_e = T_sc[cam]
    Adj_e = adj_sc[cam]
    K_e = Ks[cam]
    delta2 = cfg.huber_delta ** 2
    fx, fy = K_e[:, 0, 0], K_e[:, 1, 1]
    cx, cy = K_e[:, 0, 2], K_e[:, 1, 2]
    R_sc = Tsc_e[:, :3, :3]
    t_sc = Tsc_e[:, :3, 3]
    eye6 = torch.eye(6, dtype=X.dtype, device=X.device)

    def safe_z(x_s):
        z = x_s[:, 2]
        return torch.where(z.abs() > 1e-9, z, torch.full_like(z, 1e-9))

    def resid_xs(T):
        """Residuals and sibling-camera points at pose T, in one pass."""
        x_c = X @ T[:3, :3].T + T[:3, 3]                           # [N,3]
        x_s = torch.einsum('nij,nj->ni', R_sc, x_c) + t_sc         # [N,3]
        z = safe_z(x_s)
        u = fx * x_s[:, 0] / z + cx
        v = fy * x_s[:, 1] / z + cy
        return uv - torch.stack([u, v], -1), x_s

    def jac_from_xs(x_s):
        """Pose Jacobian [N,2,6] from cached sibling-camera points."""
        iz = 1.0 / safe_z(x_s)
        iz2 = iz * iz
        zeros = torch.zeros_like(iz)
        Jpi = torch.stack([
            torch.stack([fx * iz, zeros, -fx * x_s[:, 0] * iz2], -1),
            torch.stack([zeros, fy * iz, -fy * x_s[:, 1] * iz2], -1)], 1)
        # J_std = -Jpi @ [I | -hat(x_s)]; then right-multiplied by Adj
        hat_xs = torch.stack([
            torch.stack([zeros, -x_s[:, 2], x_s[:, 1]], -1),
            torch.stack([x_s[:, 2], zeros, -x_s[:, 0]], -1),
            torch.stack([-x_s[:, 1], x_s[:, 0], zeros], -1)], 1)
        J_std = torch.cat([-Jpi, torch.einsum('nri,nij->nrj', Jpi, hat_xs)], -1)
        return torch.einsum('nri,nij->nrj', J_std, Adj_e)

    def chi2_of(r, mask):
        c = (r * r).sum(-1) * inv_sigma2
        return c, torch.where(mask, c, torch.zeros_like(c)).sum()

    def step_from(T_b, x_s, c, r, lam, inlier, robust):
        """One damped normal-equation step from the current best state."""
        w = inv_sigma2 * factors.huber_weight(c, delta2) if robust else inv_sigma2
        w = torch.where(inlier, w, torch.zeros_like(w))
        J = jac_from_xs(x_s)
        H = torch.einsum('nri,n,nrj->ij', J, w, J)
        b = torch.einsum('nri,n,nr->i', J, w, r)
        dx = -chol_solve6(H + lam * torch.diag(torch.diagonal(H)) + 1e-9 * eye6,
                          b)
        return lie.se3_exp(dx) @ T_b

    def lm_round(T, r0, xs0, c0, cost0, inlier, robust):
        """cfg.pose_iters trial evaluations on the current inliers; a
        rejected trial reuses the cached best-state residuals and points."""
        # filled on the device: a tensor built from a host value would
        # synchronize the host with the card
        lam = torch.full((), cfg.lm_lambda_init, dtype=X.dtype, device=X.device)
        T_b, r_b, xs_b, c_b, cost_b = T, r0, xs0, c0, cost0
        T_t = step_from(T, xs0, c0, r0, lam, inlier, robust)
        for it in range(cfg.pose_iters):
            r, x_s = resid_xs(T_t)
            c, cost = chi2_of(r, inlier)
            accept = cost < cost_b
            T_b = torch.where(accept, T_t, T_b)
            r_b = torch.where(accept, r, r_b)
            xs_b = torch.where(accept, x_s, xs_b)
            c_b = torch.where(accept, c, c_b)
            cost_b = torch.where(accept, cost, cost_b)
            lam = torch.where(accept, lam / cfg.lm_lambda_factor,
                              lam * cfg.lm_lambda_factor).clamp(1e-8, 1e6)
            # the reference also computes a last trial after the final
            # evaluation and discards it
            if it + 1 < cfg.pose_iters:
                T_t = step_from(T_b, xs_b, c_b, r_b, lam, inlier, robust)
        return T_b, r_b, xs_b, c_b

    T = T_cw0
    inlier = valid
    r, x_s = resid_xs(T)
    for i in range(cfg.pose_rounds):
        robust = i < cfg.pose_rounds - 1
        c, cost = chi2_of(r, inlier)
        T, r, x_s, c = lm_round(T, r, x_s, c, cost, inlier, robust)
        # re-classify against the full valid set each round
        inlier = valid & (c <= cfg.chi2_mono)
    return T, inlier, inlier.sum()
