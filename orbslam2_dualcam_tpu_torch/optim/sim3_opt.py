"""Sim3 refinement between two keyframes (loop-closure geometry).

Port of orbslam2_dualcam_tpu/optim/sim3_opt.py (Optimizer::OptimizeSim3,
src/Optimizer.cc:976-1178, in the original): a single Sim3 vertex with
paired forward/inverse projection edges, point j of KF2 projected into KF1
through S12 and point i of KF1 projected into KF2 through S12^-1,
optimized in two Levenberg-Marquardt stages with a chi2 outlier pass in
between (th2 = 9.210 sigma^2, bFixScale for stereo rigs).

The reference takes the [N, 2, 7] Jacobians with `jax.jacfwd` of the exact
residual.  Here `torch.func.jacfwd` differentiates the residual, written
over the point axis, with respect to the one 7-vector tangent; the tangent
and the similarity inside carry a leading axis of 1, so that no value is
0-d (where `jacfwd` would give float64 tangents, see optim/pose_graph.py).  The
7x7 normal system is solved by `torch.linalg.solve_ex` and each step is
accepted by a device-side select: nothing is read back.
"""

from __future__ import annotations

import torch

from orbslam2_dualcam_tpu_torch.ops import lie


def _project(K, x):
    z = torch.where(x[..., 2].abs() > 1e-9, x[..., 2],
                    torch.full_like(x[..., 2], 1e-9))
    return torch.stack([K[0, 0] * x[..., 0] / z + K[0, 2],
                        K[1, 1] * x[..., 1] / z + K[1, 2]], -1)


def optimize_sim3(S12_0: torch.Tensor, P1: torch.Tensor, P2: torch.Tensor,
                  uv1: torch.Tensor, uv2: torch.Tensor,
                  inv_sigma2_1: torch.Tensor, inv_sigma2_2: torch.Tensor,
                  valid: torch.Tensor, K1: torch.Tensor, K2: torch.Tensor,
                  fix_scale: bool = False, iters: int = 10,
                  chi2_th: float = 9.210):
    """Refine S12 (maps KF2-camera points into KF1's camera frame).

    P1/P2 [N, 3] matched map points in the two camera frames; uv1/uv2 their
    pixel measurements.  Returns (S12, inlier_mask, n_inliers), all on the
    device of S12_0."""
    dtype, dev = S12_0.dtype, S12_0.device
    # fix_scale zeroes the tangent's scale component
    tmask = torch.ones(7, dtype=dtype, device=dev)
    if fix_scale:
        tmask = torch.cat([tmask[:6], torch.zeros_like(tmask[6:])])
    zero = torch.zeros(7, dtype=dtype, device=dev)
    eye7 = torch.eye(7, dtype=dtype, device=dev)

    def apply(S, X):                      # S [1, 4, 4], X [N, 3]
        return (X @ S[..., :3, :3].transpose(-1, -2) + S[..., None, :3, 3])[0]

    def residuals(xi, S0):
        S = lie.sim3_exp((xi * tmask)[None]) @ S0           # [1, 4, 4]
        r1 = _project(K1, apply(S, P2)) - uv1               # [N, 2]
        r2 = _project(K2, apply(lie.sim3_inv(S), P1)) - uv2
        return r1, r2

    def chi2_of(S0, mask):
        r1, r2 = residuals(zero, S0)
        c1 = (r1 * r1).sum(-1) * inv_sigma2_1
        c2 = (r2 * r2).sum(-1) * inv_sigma2_2

        def rho(c):  # Huber cost for step acceptance
            return torch.where(c <= chi2_th, c,
                               2.0 * torch.sqrt(chi2_th * torch.clamp(c, min=0.0))
                               - chi2_th)

        cost = torch.where(mask, rho(c1) + rho(c2), torch.zeros_like(c1)).sum()
        return c1, c2, cost

    def lm_stage(S, mask, n_iters):
        _, _, cost = chi2_of(S, mask)
        lam = torch.full((), 1e-5, dtype=dtype, device=dev)
        for _ in range(n_iters):
            def f(xi):
                r = residuals(xi, S)
                return r, r

            (J1, J2), (r1, r2) = torch.func.jacfwd(f, has_aux=True)(zero)
            # Huber weights (deltaHuber = sqrt(th2), Optimizer.cc:1054)
            c1 = (r1 * r1).sum(-1) * inv_sigma2_1
            c2 = (r2 * r2).sum(-1) * inv_sigma2_2
            h1 = torch.where(c1 <= chi2_th, torch.ones_like(c1),
                             torch.sqrt(chi2_th / torch.clamp(c1, min=1e-12)))
            h2 = torch.where(c2 <= chi2_th, torch.ones_like(c2),
                             torch.sqrt(chi2_th / torch.clamp(c2, min=1e-12)))
            w1 = torch.where(mask, inv_sigma2_1 * h1, torch.zeros_like(h1))
            w2 = torch.where(mask, inv_sigma2_2 * h2, torch.zeros_like(h2))
            H = (torch.einsum('nri,n,nrj->ij', J1, w1, J1) +
                 torch.einsum('nri,n,nrj->ij', J2, w2, J2))
            b = (torch.einsum('nri,n,nr->i', J1, w1, r1) +
                 torch.einsum('nri,n,nr->i', J2, w2, r2))
            A = H + lam * torch.diag(torch.diagonal(H)) + 1e-8 * eye7
            dx = -torch.linalg.solve_ex(A, b).result * tmask
            S_new = lie.sim3_exp(dx[None])[0] @ S
            _, _, new_cost = chi2_of(S_new, mask)
            accept = new_cost < cost
            S = torch.where(accept, S_new, S)
            lam = torch.clamp(torch.where(accept, lam * 0.3, lam * 5.0),
                              1e-9, 1e6)
            cost = torch.where(accept, new_cost, cost)
        return S

    # stage 1 on all matches, outlier pass, stage 2 on survivors
    # (Optimizer.cc:1100-1160)
    S = lm_stage(S12_0, valid, iters)
    c1, c2, _ = chi2_of(S, valid)
    inl = valid & (c1 < chi2_th) & (c2 < chi2_th)
    S = lm_stage(S, inl, iters)
    c1, c2, _ = chi2_of(S, inl)
    inl = valid & (c1 < chi2_th) & (c2 < chi2_th)
    return S, inl, inl.sum()
