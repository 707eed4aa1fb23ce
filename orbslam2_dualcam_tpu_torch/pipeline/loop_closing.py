"""Loop closing: the Sim3 window correction shared with the dual bootstrap.

Port of orbslam2_dualcam_tpu/pipeline/loop_closing.py lines 488-613 only:
`apply_sim3_correction` (numpy host code over the map, then the essential
graph on the device) is what the tracker's cross-camera anchoring calls.
Loop detection and closing (`LoopCloser`, Sim3 RANSAC and the Sim3
optimizer) are not ported yet; `LoopCloser` raises.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from orbslam2_dualcam_tpu_torch.models.map import (KeyFrame, Map,
                                                   update_point_stats)
from orbslam2_dualcam_tpu_torch.optim import pose_graph
from orbslam2_dualcam_tpu_torch.utils.device import to_host


class LoopCloser:
    """Loop detection, Sim3 verification and correction
    (src/LoopClosing.cc in the original)."""

    def __init__(self, *args, **kwargs) -> None:
        raise NotImplementedError(
            "LoopCloser is not ported yet: it waits for the loop-closing "
            "slice (Sim3 RANSAC, the Sim3 optimizer, loop detection)")


def _sim3_parts(S: np.ndarray):
    sR = S[:3, :3]
    s = float(np.cbrt(np.linalg.det(sR)))
    return sR / s, S[:3, 3].copy(), s


def _se3_of_sim3(S: np.ndarray) -> np.ndarray:
    """[R, t/s]: the SE3 whose pinhole projections equal the Sim3's
    (projection is invariant to scaling camera coordinates)."""
    R, t, s = _sim3_parts(S)
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = t / s
    return T


def apply_sim3_correction(m: Map, rig, kf: KeyFrame, loop_kf: KeyFrame,
                          Scw: np.ndarray, matched_mids,
                          fix_scale: bool = False,
                          pose_graph_iters: int = 40,
                          fuse_fn=None,
                          scale_factors: Optional[np.ndarray] = None) -> None:
    """Sim3 window correction + essential-graph propagation, shared by
    loop closing and the dual pipeline's cross-camera anchoring.

    `Scw` is the corrected Sim3 pose of `kf` (world -> kf camera-0 frame,
    scale included); `kf`'s covisible window is rigidly carried along, its
    map points are transformed per observing keyframe
    (LoopClosing.cc:503-610), a loop edge kf<->loop_kf is added, and the
    7-DoF essential graph redistributes the remaining discrepancy
    (Optimizer::OptimizeEssentialGraph)."""
    # snapshot pre-correction poses: the pose graph needs odometry-
    # consistent measurements (NonCorrectedSim3, LoopClosing.cc:520-540)
    old_poses = {kid: okf.T_cw.copy() for kid, okf in m.keyframes.items()}
    window = [kf.kid] + m.covisible_kfs(kf)
    corrections: Dict[int, np.ndarray] = {}
    T_kw = kf.T_cw
    for kid in window:
        okf = m.keyframes.get(kid)
        if okf is None:
            continue
        T_ik = okf.T_cw @ np.linalg.inv(T_kw)     # relative (SE3)
        S_iw = T_ik @ Scw                          # corrected Sim3
        corrections[kid] = S_iw
    # correct map points observed in the window through their
    # per-camera observer (LoopClosing.cc:574-593); remember which window
    # keyframe corrected each point (mnCorrectedByKF/mnCorrectedReference,
    # LoopClosing.cc:566-570) so the essential-graph remap moves it
    # exactly once
    corrected_mids: Dict[int, int] = {}
    for kid in window:
        okf = m.keyframes.get(kid)
        if okf is None:
            continue
        S_iw = corrections[kid]
        Ri, ti, si = _sim3_parts(S_iw)
        T_old = okf.T_cw
        for mid in okf.mp_idx[okf.mp_idx >= 0]:
            mid = int(mid)
            if mid in corrected_mids:
                continue
            mp = m.points.get(mid)
            if mp is None:
                continue
            corrected_mids[mid] = kid
            # x_cam(old) -> world(corrected): inv(S_iw) * T_old
            x_c = T_old[:3, :3] @ mp.pos + T_old[:3, 3]
            mp.pos = (Ri.T @ (x_c - ti)) / si
        # corrected SE3 pose: [R, t/s] (Optimizer.cc:962-967 convention)
        okf.T_cw = np.eye(4)
        okf.T_cw[:3, :3] = Ri
        okf.T_cw[:3, 3] = ti / si
    # merge matched loop points: current-KF point replaced by loop point.
    # The surviving loop-side point lives in old (loop) coordinates with a
    # loop-side reference KF, so it must NOT inherit the window's
    # corrected-by tag
    for mid_cur, mid_loop in matched_mids:
        a = m.points.get(mid_cur)
        b = m.points.get(mid_loop)
        if a is None or b is None or a.mid == b.mid:
            continue
        m.replace_point(a, b)
        corrected_mids.pop(a.mid, None)
    # refresh normals + scale-invariance distance bands of the corrected
    # points: their positions just scaled by 1/si, and the fuse below
    # gates on dmin/dmax (the reference calls UpdateNormalAndDepth per
    # corrected point, LoopClosing.cc:575-593)
    T_sc_np = to_host((rig.T_sc,))[0]
    sf = np.asarray(scale_factors) if scale_factors is not None else None
    if sf is not None:
        for mid in corrected_mids:
            mp = m.points.get(mid)
            if mp is not None:
                update_point_stats(mp, m, T_sc_np, sf)
    # caller-provided fusion over the now-corrected window (SearchAndFuse,
    # LoopClosing.cc:703-733) — runs between correction and the pose graph
    # exactly as in the reference (CorrectLoop:616 before :641)
    if fuse_fn is not None:
        fuse_fn()
    kf.loop_edges.add(loop_kf.kid)
    loop_kf.loop_edges.add(kf.kid)
    # pose graph over the essential graph, seeded with the full corrected
    # Sim3 of the window (vScw) so scale information survives
    pose_graph.optimize_essential_graph(
        m, rig, loop_kid=loop_kf.kid, cur_kid=kf.kid,
        old_poses=old_poses, fix_scale=fix_scale,
        iters=pose_graph_iters, corrected_sim=corrections,
        corrected_mids=corrected_mids)
    # the essential-graph remap moved EVERY point (and every pose): bring
    # all stats back in sync before tracking resumes against this map
    if sf is not None:
        for mp in m.points.values():
            if not mp.is_bad:
                update_point_stats(mp, m, T_sc_np, sf)
    m.geometry_epoch += 1
