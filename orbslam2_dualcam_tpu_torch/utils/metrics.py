"""Trajectory evaluation: Sim3/SE3 alignment + ATE RMSE.

The reference leaves evaluation to external TUM/evo scripts operating on
its saved ``x y z qx qy qz qw id`` files (SURVEY §4); we make it a
first-class utility."""

from __future__ import annotations

import numpy as np


def align_umeyama(est: np.ndarray, gt: np.ndarray, with_scale: bool = True):
    """Umeyama alignment est -> gt. est/gt [N,3]. Returns (R, t, s)."""
    mu_e = est.mean(0)
    mu_g = gt.mean(0)
    E = est - mu_e
    G = gt - mu_g
    C = G.T @ E / len(est)
    U, D, Vt = np.linalg.svd(C)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    var_e = (E * E).sum() / len(est)
    s = float(np.trace(np.diag(D) @ S) / var_e) if with_scale else 1.0
    t = mu_g - s * R @ mu_e
    return R, t, s


def ate_rmse(est_positions: np.ndarray, gt_positions: np.ndarray,
             with_scale: bool = True) -> float:
    """Absolute trajectory error RMSE after (Sim3 or SE3) alignment."""
    R, t, s = align_umeyama(est_positions, gt_positions, with_scale)
    aligned = (s * (est_positions @ R.T)) + t
    d = aligned - gt_positions
    return float(np.sqrt((d * d).sum(-1).mean()))


def trajectory_positions(trajectory) -> np.ndarray:
    """[(fid, ts, T_cw)] -> camera centers [N,3]."""
    out = []
    for _, _, T in trajectory:
        R = T[:3, :3]
        out.append(-R.T @ T[:3, 3])
    return np.asarray(out)
