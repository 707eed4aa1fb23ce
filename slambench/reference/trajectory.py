"""The published trajectory against the true one, in float64 numpy.

A monocular map has a scale and a frame of its own, so each map (the
poses published between two resets) is aligned to the true poses by the
similarity that fits its camera centres best (Umeyama; the arithmetic of
the port's utils/metrics.align_umeyama, copied), and then judged:

- traj_err: the RMS distance between the aligned and the true camera
  centres, as a share of the RMS distance of the true centres from their
  mean (the path's extent): 0 for a perfect trajectory, 1 for one that
  says nothing of where the rig went;
- traj_rot_deg: the RMS, over the pairs of consecutive published frames,
  of the angle between the published and the true rotation from one frame
  to the next (no alignment needed: rotations carry no scale).

Nothing here imports the program.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

MIN_FRAMES = 8        # a map with fewer published frames is not judged


def align_umeyama(est: np.ndarray, gt: np.ndarray) -> Tuple[np.ndarray, np.ndarray, float]:
    """Similarity (R, t, s) taking est [N, 3] onto gt [N, 3]."""
    mu_e, mu_g = est.mean(0), gt.mean(0)
    E, G = est - mu_e, gt - mu_g
    U, D, Vt = np.linalg.svd(G.T @ E / len(est))
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    var_e = (E * E).sum() / len(est)
    s = float(np.trace(np.diag(D) @ S) / var_e) if var_e > 0 else 1.0
    return R, mu_g - s * R @ mu_e, s


def centre(T_cw: np.ndarray) -> np.ndarray:
    return -T_cw[:3, :3].T @ T_cw[:3, 3]


def rot_angle_deg(R: np.ndarray) -> float:
    c = (np.trace(R) - 1.0) / 2.0
    return float(np.degrees(np.arccos(np.clip(c, -1.0, 1.0))))


def judge_map(est: Sequence[np.ndarray], gt: Sequence[np.ndarray]) -> Dict[str, float]:
    """One map's published poses (T_cw, in order) against the true ones."""
    pe = np.stack([centre(T) for T in est])
    pg = np.stack([centre(T) for T in gt])
    R, t, s = align_umeyama(pe, pg)
    d = (s * pe @ R.T + t) - pg
    extent = np.sqrt(((pg - pg.mean(0)) ** 2).sum(-1).mean())
    err = float(np.sqrt((d * d).sum(-1).mean()) / max(extent, 1e-12))
    rot = []
    for i in range(1, len(est)):
        Re = est[i][:3, :3] @ est[i - 1][:3, :3].T
        Rg = gt[i][:3, :3] @ gt[i - 1][:3, :3].T
        rot.append(rot_angle_deg(Re.T @ Rg))
    rot = np.asarray(rot if rot else [0.0])
    return {"traj_err": err, "traj_rot_deg": float(np.sqrt(np.mean(np.square(rot)))),
            "traj_rot_median_deg": float(np.median(rot)),
            "traj_rot_max_deg": float(rot.max()), "frames": len(est)}


def judge(maps: List[List[Tuple[np.ndarray, np.ndarray]]]) -> Dict[str, float]:
    """The widest of each number over the maps with MIN_FRAMES or more
    published frames; each map is [(published T_cw, true T_cw)]."""
    out: Dict[str, float] = {}
    for m in maps:
        if len(m) < MIN_FRAMES:
            continue
        r = judge_map([e for e, _ in m], [g for _, g in m])
        for k in ("traj_err", "traj_rot_deg", "traj_rot_median_deg", "traj_rot_max_deg"):
            out[k] = max(out.get(k, r[k]), r[k])
    return out
