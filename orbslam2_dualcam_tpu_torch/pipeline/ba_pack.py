"""Pack/unpack between the host map and device BAProblem tensors.

Port of orbslam2_dualcam_tpu/pipeline/ba_pack.py.  The reference builds a
fresh g2o graph per BA call (Optimizer.cc:78-140, 417-500); here the window
is packed into padded arrays and the optimized values are scattered back.
The padded sizes are the reference's x4 shape buckets: eager PyTorch does
not need them, but the truncation that goes with them is semantics, and
equal shapes keep the two packages comparable edge for edge."""

from __future__ import annotations

from typing import Dict, List, Sequence, Set

import numpy as np
import torch

from orbslam2_dualcam_tpu_torch.models.map import Map
from orbslam2_dualcam_tpu_torch.optim import ba
from orbslam2_dualcam_tpu_torch.optim.factors import Edges
from orbslam2_dualcam_tpu_torch.utils.device import resolve_device, to_host
from orbslam2_dualcam_tpu_torch.utils.profiling import span


def _bucket(n: int, lo: int = 256) -> int:
    # x4 growth: the reference's shape buckets (there every distinct
    # (K, M, E) triple is a separate compile).  The padded matvec is linear
    # in the bucket; padded rows are masked and add exactly zero.
    b = lo
    while b < n:
        b *= 4
    return b


def pack_problem(m: Map, kids: Sequence[int], fixed_kids: Set[int],
                 level_sigma2: np.ndarray, ncam: int,
                 max_points: int | None = None,
                 include_spectators: bool = True,
                 cross_weight: float = 2.0, device=None):
    """Build a BAProblem for the window `kids`.

    Points = all points observed by the window; spectator KFs (outside the
    window but observing those points) are added as fixed poses, mirroring
    LocalBundleAdjustment's lFixedCameras (Optimizer.cc:447-466).

    Cross-camera edges — observations through a camera other than the
    point's first-view camera — are the ONLY residuals through which the
    metric extrinsic baseline constrains map scale (the reference counts
    them as nCrossCamEdges, Optimizer.cc:111-142).  They are up-weighted by
    `cross_weight` and flagged in the edge meta so unpack can exempt them
    from chi2 erasure: right after the bootstrap rescale the map can still
    be a factor off metric, which makes exactly these edges look like
    outliers — erasing them would discard the scale signal (the Huber
    kernel already bounds their influence if truly wrong).

    The problem's tensors are placed on `device` (None: the current CUDA
    device).

    Returns (prob, kid_of_pslot, mid_of_slot, edge_meta) where edge_meta is
    (kid, mid, row, is_cross) per edge for outlier erasure.  The call is a
    span `ba.pack`."""
    with span("ba.pack"):
        kids = [k for k in kids if k in m.keyframes]
        kidset = set(kids)
        mids: List[int] = []
        midset: Set[int] = set()
        for kid in kids:
            kf = m.keyframes[kid]
            for mid in kf.mp_idx[kf.mp_idx >= 0]:
                mid = int(mid)
                if mid not in midset and mid in m.points:
                    midset.add(mid)
                    mids.append(mid)
        if max_points is not None and len(mids) > max_points:
            mids = mids[:max_points]
            midset = set(mids)

        spect: List[int] = []
        if include_spectators:
            for mid in mids:
                for kid in m.points[mid].obs:
                    if kid not in kidset and kid in m.keyframes:
                        kidset.add(kid)
                        spect.append(kid)
        all_kids = list(kids) + spect
        fixed = set(fixed_kids) | set(spect)

        K = _bucket(len(all_kids), 8)
        M = _bucket(len(mids), 256)
        poses = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
        pose_valid = np.zeros(K, bool)
        pose_fixed = np.zeros(K, bool)
        slot_of_kid: Dict[int, int] = {}
        for i, kid in enumerate(all_kids):
            poses[i] = m.keyframes[kid].T_cw
            pose_valid[i] = True
            pose_fixed[i] = kid in fixed
            slot_of_kid[kid] = i
        # windows with no fixed pose still need a gauge: anchor the OLDEST
        # keyframe (the best-estimated one), never the newest
        if not pose_fixed[:len(all_kids)].any() and all_kids:
            pose_fixed[slot_of_kid[min(all_kids)]] = True

        points = np.zeros((M, 3), np.float32)
        point_valid = np.zeros(M, bool)
        slot_of_mid: Dict[int, int] = {}
        for i, mid in enumerate(mids):
            points[i] = m.points[mid].pos
            point_valid[i] = True
            slot_of_mid[mid] = i

        ekf, emp, ecam, euv, esig, meta = [], [], [], [], [], []
        for mid in mids:
            mp = m.points[mid]
            for kid, row in mp.obs.items():
                if kid not in slot_of_kid:
                    continue
                kf = m.keyframes[kid]
                cam = mp.obs_cam.get(kid, 0)
                is_cross = cam != mp.first_view_cam
                ekf.append(slot_of_kid[kid])
                emp.append(slot_of_mid[mid])
                ecam.append(cam)
                euv.append(kf.uv[row])
                w = cross_weight if is_cross else 1.0
                esig.append(w / level_sigma2[int(kf.level[row])])
                meta.append((kid, mid, row, is_cross))
        E = _bucket(max(len(ekf), 1), 1024)
        pad = E - len(ekf)
        device = resolve_device(device)

        def dev(a):
            return torch.as_tensor(a).to(device, non_blocking=True)

        edges = Edges(
            kf=dev(np.asarray(ekf + [0] * pad, np.int64)),
            mp=dev(np.asarray(emp + [0] * pad, np.int64)),
            cam=dev(np.asarray(ecam + [0] * pad, np.int64)),
            uv=dev(np.asarray(euv + [[0.0, 0.0]] * pad,
                              np.float32).reshape(E, 2)),
            inv_sigma2=dev(np.asarray(esig + [0.0] * pad, np.float32)),
            valid=dev(np.asarray([True] * len(ekf) + [False] * pad)))

        prob = ba.BAProblem(
            poses=dev(poses), points=dev(points), edges=edges,
            pose_valid=dev(pose_valid), pose_fixed=dev(pose_fixed),
            point_valid=dev(point_valid))
        return prob, all_kids, mids, meta


def unpack_result(m: Map, res: ba.BAResult, all_kids: Sequence[int],
                  mids: Sequence[int], meta, chi2_th: float = 5.991,
                  erase_outliers: bool = True) -> int:
    """Write optimized poses/points back; erase high-chi2 observations
    (Optimizer.cc:641-673). Returns number of erased observations.  The
    call is a span `ba.unpack`; the result comes back in one readback."""
    with span("ba.unpack"):
        leaves = [res.poses, res.points] + ([res.edge_chi2] if erase_outliers
                                            else [])
        host = to_host(leaves)
        poses = host[0].astype(np.float64)
        points = host[1].astype(np.float64)
        for i, kid in enumerate(all_kids):
            kf = m.keyframes.get(kid)
            if kf is not None:
                kf.T_cw = poses[i].copy()
        for i, mid in enumerate(mids):
            mp = m.points.get(mid)
            if mp is not None:
                mp.pos = points[i].copy()
        n_erased = 0
        if erase_outliers:
            chi2 = host[2]
            for e, (kid, mid, row, is_cross) in enumerate(meta):
                if chi2[e] > chi2_th and not is_cross:
                    mp = m.points.get(mid)
                    if mp is not None and not mp.is_bad:
                        m.erase_observation(mp, kid)
                        n_erased += 1
        return n_erased
