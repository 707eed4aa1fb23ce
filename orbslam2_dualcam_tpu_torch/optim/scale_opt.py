"""Global metric-scale optimization over cross-camera edges.

Port of orbslam2_dualcam_tpu/optim/scale_opt.py: the edge gathering and
`bootstrap_scale` are that module's numpy host code (float64); the cost
curve is one tensor expression on the rig's device, over exactly the E
edges (no padding, so the result cannot depend on one).

The monocular reprojection cost is exactly invariant to a global similarity
rescale (points x alpha, pose translations x alpha) — that gauge freedom is
why plain LM crawls along the scale direction.  The ONLY residuals that
break the invariance are cross-camera observations, whose camera ray is
offset by the metric extrinsic translation t_sc (the reference's
nCrossCamEdges, Optimizer.cc:111-142; see also SURVEY §7 "scale handling").

For such an edge, the observing camera's coordinates of the point under a
global rescale alpha are LINEAR in alpha:

    x_cam(alpha) = T_sc (alpha * T_kf X) = alpha * a_e + t_sc,
    a_e = R_sc (R_kf X + t_kf)

so the whole-map scale reduces to a 1-DoF robust optimization evaluated
over the cross edges alone.  We solve it by a dense log-spaced grid sweep
(one [A, E] broadcast on the device, no iteration) plus a parabolic
refinement, then apply alpha to every keyframe translation and map point.

The reference has no equivalent — it relies on the g2o BA slowly settling
scale through the same edges; the explicit 1-DoF solve reaches in one step
what costs LM hundreds of iterations.
"""

from __future__ import annotations

from typing import Optional, Tuple

import math

import numpy as np
import torch

from orbslam2_dualcam_tpu_torch.models.map import Map
from orbslam2_dualcam_tpu_torch.utils.device import to_host, upload


def _scale_cost_curve(a: torch.Tensor, b: torch.Tensor, uv: torch.Tensor,
                      fxy: torch.Tensor, cxy: torch.Tensor,
                      inv_sigma2: torch.Tensor, valid: torch.Tensor,
                      alphas: torch.Tensor, delta2: float) -> torch.Tensor:
    """Robust total cost for each candidate alpha.

    a [E,3] linear coefficient, b [E,3] extrinsic offset, uv [E,2]
    observations, fxy/cxy [E,2] per-edge intrinsics, alphas [A].
    Returns [A] cost."""
    x = alphas[:, None, None] * a[None] + b[None]          # [A,E,3]
    z = x[..., 2]
    behind = z < 1e-6
    zsafe = torch.where(behind, torch.ones_like(z), z)
    proj = x[..., :2] / zsafe[..., None] * fxy[None] + cxy[None]
    r2 = ((proj - uv[None]) ** 2).sum(-1) * inv_sigma2[None]       # [A,E]
    # Huber rho; cheirality violations cost the (large) linear cap
    rho = torch.where(r2 > delta2,
                      2.0 * torch.sqrt(delta2 * torch.clamp(r2, min=0.0))
                      - delta2, r2)
    rho = torch.where(behind,
                      torch.full_like(rho, 2.0 * math.sqrt(delta2 * 1e6)),
                      rho)
    return torch.where(valid[None], rho, torch.zeros_like(rho)).sum(-1)


def optimal_map_scale(m: Map, rig, level_sigma2: np.ndarray,
                      alpha_lo: float = 0.25, alpha_hi: float = 4.0,
                      n_grid: int = 97, min_edges: int = 30,
                      delta2: float = 5.991) -> Optional[Tuple[float, int]]:
    """Estimate the global rescale alpha* that best explains the map's
    cross-camera observations.  Returns (alpha, n_edges) or None.  The
    cost curve runs on the device the rig's tensors lie on."""
    device = rig.K.device
    T_sc, Ks = to_host((rig.T_sc, rig.K))
    a_l, b_l, uv_l, fxy_l, cxy_l, is2_l = [], [], [], [], [], []
    for mp in m.points.values():
        for kid, row in mp.obs.items():
            cam = mp.obs_cam.get(kid, 0)
            if cam == mp.first_view_cam:
                continue
            kf = m.keyframes.get(kid)
            if kf is None:
                continue
            Rk, tk = kf.T_cw[:3, :3], kf.T_cw[:3, 3]
            a_l.append(T_sc[cam][:3, :3] @ (Rk @ mp.pos + tk))
            b_l.append(T_sc[cam][:3, 3])
            uv_l.append(kf.uv[row])
            K = Ks[cam]
            fxy_l.append((K[0, 0], K[1, 1]))
            cxy_l.append((K[0, 2], K[1, 2]))
            is2_l.append(1.0 / level_sigma2[int(kf.level[row])])
    E = len(a_l)
    if E < min_edges:
        return None

    def dev(x):
        return upload(np.asarray(x, np.float32), device)

    alphas = np.geomspace(alpha_lo, alpha_hi, n_grid).astype(np.float32)
    cost = to_host((_scale_cost_curve(
        dev(a_l), dev(b_l), dev(uv_l), dev(fxy_l), dev(cxy_l), dev(is2_l),
        torch.ones(E, dtype=torch.bool, device=device), dev(alphas),
        float(delta2)),))[0]
    i = int(np.argmin(cost))
    # parabolic refinement in log-alpha
    la = np.log(alphas)
    if 0 < i < n_grid - 1:
        c0, c1, c2 = cost[i - 1], cost[i], cost[i + 1]
        denom = c0 - 2 * c1 + c2
        off = 0.5 * (c0 - c2) / denom if abs(denom) > 1e-12 else 0.0
        off = float(np.clip(off, -1.0, 1.0))
        lbest = la[i] + off * (la[1] - la[0])
    else:
        lbest = la[i]
    return float(np.exp(lbest)), E


def bootstrap_scale(anchors, T_sc1: np.ndarray,
                    sigma_odo: float = 0.002,
                    sigma_c1: float = 0.004,
                    irls_rounds: int = 3) -> Optional[Tuple[float, float, int]]:
    """Unbiased global metric scale from cross-reloc anchors.

    The reference's per-reloc estimator s = |t_sc| / |C1 - C0|
    (Tracking.cc:1014-1029) divides NORMS: when the camera-center noise is
    comparable to the tiny baseline signal, E|signal + noise| >> |signal|,
    so the estimate is systematically biased toward small scale regardless
    of averaging (NUM_FRAME_IN_SECONDMAP).  This estimator keeps the
    VECTOR equation instead.  Physics: for a rig at orientation R the
    secondary camera sits at the metric offset o(R) = C1 - C0 (a rotated
    copy of t_sc); in map units that offset appears shrunk by the map's
    scale error alpha:

        C1_i - C0_i = o(R_i) / alpha            (map units)

    Differencing two anchors cancels the common-mode tracking error:

        u_ij := (C1_i - C1_j) - (C0t_i - C0t_j) = (o_i - o_j) / alpha

    where C1 comes from the refined cross-camera relocalization (accurate
    relative to the mapped structure) and C0t from tracked odometry.  A
    weighted least-squares over all anchor pairs in gamma = 1/alpha is
    linear, and noise orthogonal to (o_i - o_j) never biases it.  The
    signal |o_i - o_j| = 2 sin(dtheta/2) |t_sc| grows with the
    orientation diversity the bootstrap trajectory provides — with a
    single rig orientation scale is fundamentally unobservable (disjoint
    FOVs share no structure; see the scale-observability design note).

    `anchors`: list of dicts {T1w: [4,4] refined reloc camera-1 pose,
    T_track: [4,4] tracked rig pose, frame_id: int}.  Returns
    (alpha, rel_sigma, n_pairs): the scale to multiply the map by, its
    relative 1-sigma from the weighted residuals, and the pair count.
    """
    A = len(anchors)
    if A < 2:
        return None
    c1 = np.zeros((A, 3))
    c0 = np.zeros((A, 3))
    o = np.zeros((A, 3))
    fid = np.zeros(A)
    for i, a in enumerate(anchors):
        T1, Tt = a["T1w"], a["T_track"]
        c1[i] = -T1[:3, :3].T @ T1[:3, 3]
        c0[i] = -Tt[:3, :3].T @ Tt[:3, 3]
        # metric extrinsic offset at this orientation: place a rig at the
        # tracked rotation and compose (only rotation matters)
        T1_of_track = T_sc1 @ Tt
        c1_of_track = -T1_of_track[:3, :3].T @ T1_of_track[:3, 3]
        o[i] = c1_of_track - c0[i]
        fid[i] = a["frame_id"]
    ii, jj = np.triu_indices(A, k=1)
    u = (c1[ii] - c1[jj]) - (c0[ii] - c0[jj])      # [P,3]
    w_vec = o[ii] - o[jj]                          # [P,3]
    gap = np.abs(fid[ii] - fid[jj])
    var = sigma_odo ** 2 * gap + 2 * sigma_c1 ** 2
    w_pair = 1.0 / var                             # [P]
    wp = w_pair.copy()
    gamma = None
    for _ in range(irls_rounds):
        num = float(np.einsum('p,pi,pi->', wp, w_vec, u))
        den = float(np.einsum('p,pi,pi->', wp, w_vec, w_vec))
        if den < 1e-12:
            return None
        gamma = num / den
        # Cauchy-style reweight on pair residuals
        r2 = ((u - gamma * w_vec) ** 2).sum(1) * w_pair
        med = np.median(r2) + 1e-12
        wp = w_pair / (1.0 + r2 / (9.0 * med))
    if gamma is None or gamma <= 1e-6:
        return None
    # studentized uncertainty of gamma from the weighted residual scatter
    r = u - gamma * w_vec
    dof = max(1, 3 * len(u) - 1)
    s2 = float(np.einsum('p,pi,pi->', wp, r, r)) / dof
    den = float(np.einsum('p,pi,pi->', wp, w_vec, w_vec))
    sigma_gamma = float(np.sqrt(s2 / max(den, 1e-12)))
    alpha = 1.0 / gamma
    rel_sigma = sigma_gamma / gamma
    return float(alpha), float(rel_sigma), int(len(u))


def apply_map_scale(m: Map, alpha: float) -> None:
    """Multiply every keyframe translation and point position by alpha
    (KeyFrame::SetScale / MapPoint::SetScale semantics, KeyFrame.cc:171-187)
    WITHOUT touching map_scaled bookkeeping — this is a refinement of an
    already-scaled map, not the bootstrap event."""
    for kf in m.keyframes.values():
        kf.T_cw = kf.T_cw.copy()
        kf.T_cw[:3, 3] *= alpha
    for mp in m.points.values():
        mp.pos = mp.pos * alpha
