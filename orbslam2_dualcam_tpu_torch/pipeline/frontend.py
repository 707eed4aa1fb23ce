"""The fused per-frame dual-camera tracking step and its batched form.

Port of orbslam2_dualcam_tpu/pipeline/frontend.py (make_track_fn,
make_track_batch_fn and what they call): extraction on both cameras + BoW quantization, stage-1
motion-model projection matching + pose optimization with the widened
retry, stage-2 local-map rematch + re-optimization, pose
re-orthonormalization and the velocity update.

The step never reads a value back to the host: the reference's widened
retry (a lax.cond) is a device-side select here, so a frame is one stream
of kernel launches (what a later CUDA graph capture needs).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from orbslam2_dualcam_tpu_torch.utils.config import BAConfig, SystemConfig
from orbslam2_dualcam_tpu_torch.ops import camera, matching, orb
from orbslam2_dualcam_tpu_torch.ops.camera import CameraRig
from orbslam2_dualcam_tpu_torch.optim import pose_opt
from orbslam2_dualcam_tpu_torch.utils.device import resolve_device
from orbslam2_dualcam_tpu_torch.vocab import bow


class FrameData(NamedTuple):
    """Per-frame device data, [ncam, N, ...] fixed shapes."""

    feats: orb.Features
    words: torch.Tensor      # [ncam, N] vocabulary word ids (or -1)
    nodes: torch.Tensor      # [ncam, N] direct-index node ids (or -1)


class FusedTrackOut(NamedTuple):
    """Result of the fused per-frame track step."""

    T_cw: torch.Tensor        # [4,4] final optimized rig pose
    V_new: torch.Tensor       # [4,4] updated velocity model T_cw @ T_last^-1
    mp_slots: torch.Tensor    # [ncam, N] final inlier store slot per kp (-1)
    n_stage1: torch.Tensor    # stage-1 (motion-model) inlier count
    n_final: torch.Tensor     # final matched-inlier count
    mp_visible: torch.Tensor  # [M] store slot frustum-visible in stage 2


class TrackResult(NamedTuple):
    T_cw: torch.Tensor        # optimized rig pose
    mp_ids: torch.Tensor      # [ncam, N] matched map-point slot per keypoint (-1)
    n_inliers: torch.Tensor
    mp_visible: torch.Tensor  # [M] map-point slot passed the frustum test in any cam


def _extract_frame_body(images: torch.Tensor, cfg: SystemConfig, n_feats: int,
                        voc: Optional[bow.Vocabulary],
                        rig: CameraRig) -> FrameData:
    """Extraction for one rig frame [ncam, H, W] (uint8 or float):
    ORB on every camera, keypoint undistortion, BoW quantization."""
    feats = orb.extract_orb_rig(images.to(torch.float32), cfg.orb, n_feats)
    # undistort once per camera (Frame::UndistortKeyPoints); the camera
    # axis of the rig tables broadcasts against the keypoint axis
    xn = (feats.uv @ rig.K_inv[:, :2, :2].transpose(-1, -2)
          + rig.K_inv[:, None, :2, 2])
    xu = camera.undistort(xn, rig.dist[:, None, :])
    uv = xu @ rig.K[:, :2, :2].transpose(-1, -2) + rig.K[:, None, :2, 2]
    feats = feats._replace(uv=uv, uv_raw=feats.uv)
    ncam, N = feats.valid.shape
    if voc is not None:
        w, n = bow.quantize(voc, feats.desc.reshape(ncam * N, 8))
        none = torch.full_like(feats.level, -1)
        words = torch.where(feats.valid, w.reshape(ncam, N), none)
        nodes = torch.where(feats.valid, n.reshape(ncam, N), none)
    else:
        words = torch.full_like(feats.level, -1)
        nodes = torch.full_like(feats.level, -1)
    return FrameData(feats=feats, words=words, nodes=nodes)


def project_and_match(T_pred, feats_uv, feats_desc, feats_level, feats_valid,
                      mp_pos, mp_desc, mp_valid, mp_max_dist, mp_min_dist,
                      mp_normal, rig: CameraRig, radius, level_scales,
                      max_hamming, view_cos_th, cam_enabled=None):
    """Project map points into every camera and match in scaled windows
    (SearchByProjection with frustum gating).  Cameras are the leading
    batch axis.  Returns (mp_of_kp [ncam, N] store slot or -1,
    vis_any [M])."""
    ncam, N = feats_valid.shape
    M = mp_pos.shape[0]
    dev = mp_pos.device
    if cam_enabled is None:
        cam_enabled = torch.ones(ncam, dtype=torch.bool, device=dev)
    T_sw = rig.T_sc @ T_pred                                    # [ncam,4,4]
    x_cam = torch.einsum('cij,mj->cmi', T_sw[:, :3, :3], mp_pos) + T_sw[:, None, :3, 3]
    z = x_cam[..., 2]
    zc = torch.where(z.abs() > 1e-9, z, torch.full_like(z, 1e-9))
    K = rig.K
    uv_proj = torch.stack([K[:, None, 0, 0] * x_cam[..., 0] / zc + K[:, None, 0, 2],
                           K[:, None, 1, 1] * x_cam[..., 1] / zc + K[:, None, 1, 2]],
                          dim=-1)                               # [ncam,M,2]
    # frustum: positive depth, in image, distance within scale band,
    # viewing angle (Frame.cc:265-297)
    cc = -(T_sw[:, :3, :3].transpose(-1, -2) @ T_sw[:, :3, 3:])[..., 0]  # [ncam,3]
    d = mp_pos - cc[:, None, :]
    dist = torch.linalg.vector_norm(d, dim=-1)
    b = rig.bounds[:, None, :]
    in_img = ((uv_proj[..., 0] >= b[..., 0]) & (uv_proj[..., 0] <= b[..., 1]) &
              (uv_proj[..., 1] >= b[..., 2]) & (uv_proj[..., 1] <= b[..., 3]))
    viewcos = (d * mp_normal).sum(-1) / torch.clamp(dist, min=1e-9)
    vis = (mp_valid & cam_enabled[:, None] & (z > 0) & in_img &
           (dist >= 0.8 * mp_min_dist) & (dist <= 1.2 * mp_max_dist) &
           (viewcos > view_cos_th))
    # predicted level from distance (MapPoint::PredictScale)
    ratio = torch.clamp(mp_max_dist, min=1e-9) / torch.clamp(dist, min=1e-9)
    pred_level = torch.clamp(torch.ceil(torch.log(ratio) / torch.log(level_scales[1])),
                             0, level_scales.shape[0] - 1).to(torch.int64)
    # per-point search radius scaled by predicted level
    r = radius * level_scales[pred_level]
    allow = matching.window_mask(uv_proj, feats_uv, r)
    allow = allow & matching.level_mask(pred_level, feats_level, -1, 1)
    res = matching.match_masked(mp_desc, feats_desc, allow=allow,
                                valid_a=vis, valid_b=feats_valid,
                                max_dist=max_hamming, ratio=0.9)
    # invert: per-keypoint map point (resolve camera conflicts by distance)
    idx = res.idx                                               # [ncam, M]
    ok = idx >= 0
    safe = torch.where(ok, idx, torch.zeros_like(idx))
    dd = torch.where(ok, res.dist, 1e9)
    best = torch.full((ncam, N), 1e9, device=dev).scatter_reduce(
        -1, safe, dd, "amin", include_self=True)
    mprange = torch.arange(M, device=dev).expand(ncam, M)
    first = torch.full((ncam, N), M, dtype=torch.int64, device=dev).scatter_reduce(
        -1, safe, torch.where(ok & (dd <= torch.gather(best, -1, safe)), mprange, M),
        "amin", include_self=True)
    win = ok & (torch.gather(first, -1, safe) == mprange)
    # losers write to a scratch column N that is sliced off
    kp_assign = torch.full((ncam, N + 1), -1, dtype=torch.int64, device=dev)
    kp_assign.scatter_(-1, torch.where(win, safe, N), torch.where(win, mprange, -1))
    return kp_assign[:, :N], vis.any(0)


def match_projection_pose(T_pred, feats_uv, feats_desc, feats_level,
                          feats_angle, feats_valid, mp_pos, mp_desc, mp_valid,
                          mp_max_dist, mp_min_dist, mp_normal, rig: CameraRig,
                          radius, level_scales, max_hamming, view_cos_th,
                          cam_enabled=None,
                          ba: Optional[BAConfig] = None) -> TrackResult:
    """Projection matching + pose optimization: the TrackWithMotionModel /
    TrackLocalMap hot path (Tracking.cc:1384-1520)."""
    ncam, N = feats_valid.shape
    mp_of_kp, mp_vis = project_and_match(
        T_pred, feats_uv, feats_desc, feats_level, feats_valid,
        mp_pos, mp_desc, mp_valid, mp_max_dist, mp_min_dist, mp_normal,
        rig, radius, level_scales, max_hamming, view_cos_th, cam_enabled)
    # pose-opt edge set: one edge per matched keypoint
    matched = mp_of_kp >= 0
    X = mp_pos[torch.where(matched, mp_of_kp, torch.zeros_like(mp_of_kp))]
    cam_e = torch.arange(ncam, device=mp_pos.device)[:, None].expand(ncam, N)
    inv_sigma2 = 1.0 / (level_scales[feats_level] ** 2)
    T_opt, inl, n = pose_opt.optimize_pose(
        T_pred, X.reshape(-1, 3), feats_uv.reshape(-1, 2), cam_e.reshape(-1),
        inv_sigma2.reshape(-1), matched.reshape(-1),
        rig.T_sc, rig.adj_sc, rig.K, cfg=BAConfig() if ba is None else ba)
    mp_final = torch.where(inl.reshape(ncam, N), mp_of_kp,
                           torch.full_like(mp_of_kp, -1))
    return TrackResult(T_cw=T_opt, mp_ids=mp_final, n_inliers=n,
                       mp_visible=mp_vis)


def _select(use_b: torch.Tensor, b: TrackResult, a: TrackResult) -> TrackResult:
    return TrackResult(*(torch.where(use_b, x, y) for x, y in zip(b, a)))


def _make_track_body(cfg: SystemConfig, n_feats: int,
                     voc: Optional[bow.Vocabulary], rig: CameraRig, device):
    level_scales = torch.as_tensor(np.asarray(cfg.orb.scale_factors, np.float32),
                                   device=device)

    def scalar(x):
        return torch.tensor(x, dtype=torch.float32, device=device)

    th_high = scalar(cfg.matcher.th_high)
    th_low = scalar(cfg.matcher.th_low)
    r_narrow, r_wide = scalar(15.0), scalar(30.0)
    r_dense, r_sparse = scalar(6.0), scalar(10.0)
    view_cos = scalar(0.5)
    min_motion = int(cfg.tracker.min_matches_motion)
    min_track = int(cfg.tracker.min_matches_track)

    def track_frame(images, T_last, V, prev_slots, cam_enabled, mp_pos,
                    mp_desc, mp_valid, mp_max, mp_min, mp_norm):
        M = mp_pos.shape[0]
        # stage-1 candidates: the previous frame's matched store slots
        stage1_mask = torch.zeros(M + 1, dtype=torch.bool, device=device).index_fill_(
            0, torch.where(prev_slots >= 0, prev_slots, M).reshape(-1), True)
        fd = _extract_frame_body(images, cfg, n_feats, voc, rig)
        f = fd.feats
        T_pred = V @ T_last

        def stage(T_seed, vmask, radius, ham):
            return match_projection_pose(
                T_seed, f.uv, f.desc, f.level, f.angle, f.valid,
                mp_pos, mp_desc, vmask, mp_max, mp_min, mp_norm,
                rig, radius, level_scales, ham, view_cos,
                cam_enabled, ba=cfg.ba)

        v1 = mp_valid & stage1_mask[:M]
        ra = stage(T_pred, v1, r_narrow, th_high)
        # widened retry on a thin result, keeping whichever is BETTER
        # (Tracking.cc:1407-1414).  The reference branches with lax.cond;
        # here both windows always run and a select keeps the wide one only
        # where the narrow one was thin and the wide one found more, which
        # gives the same result without a host sync
        rb = stage(T_pred, v1, r_wide, th_high)
        r1 = _select((ra.n_inliers < min_motion) & (rb.n_inliers > ra.n_inliers),
                     rb, ra)

        # stage 2: local-map rematch from the optimized pose; narrow window
        # when stage 1 was dense (Tracking.cc:1652-1657)
        r2rad = torch.where(r1.n_inliers >= 50, r_dense, r_sparse)
        r3 = stage(r1.T_cw, mp_valid, r2rad, th_low)
        ok3 = r3.n_inliers >= min_track
        T_f = torch.where(ok3, r3.T_cw, r1.T_cw)
        mp_f = torch.where(ok3, r3.mp_ids, r1.mp_ids)
        # re-orthonormalize the output rotation (Gram-Schmidt): the pose
        # chain multiplies f32 matrices every frame, and the rigid inverse
        # below assumes R in SO(3)
        c0 = T_f[:3, 0] / torch.linalg.vector_norm(T_f[:3, 0])
        c1 = T_f[:3, 1] - torch.dot(c0, T_f[:3, 1]) * c0
        c1 = c1 / torch.linalg.vector_norm(c1)
        c2 = torch.linalg.cross(c0, c1)
        T_f[:3, :3] = torch.stack([c0, c1, c2], dim=1)
        # rigid inverse of T_last for the velocity update (Tracking.cc:1466)
        R = T_last[:3, :3]
        Ti = torch.eye(4, dtype=T_last.dtype, device=device)
        Ti[:3, :3] = R.T
        Ti[:3, 3] = -R.T @ T_last[:3, 3]
        return fd, FusedTrackOut(
            T_cw=T_f, V_new=T_f @ Ti, mp_slots=mp_f, n_stage1=r1.n_inliers,
            n_final=(mp_f >= 0).sum(), mp_visible=r3.mp_visible)

    return track_frame


def _stack_leaves(items):
    """[NamedTuple of (nested) tensors] * D -> one NamedTuple of the same
    type with a leading axis D on every leaf."""
    first = items[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(items)
    return type(first)(*(_stack_leaves(list(xs)) for xs in zip(*items)))


def _checked_body(cfg: SystemConfig, n_feats: int,
                  voc: Optional[bow.Vocabulary], rig: CameraRig, device):
    """The step on `device` (None: the current CUDA device), after checking
    that the rig and the vocabulary lie there.

    Float32 matrix products on this path must run in full f32: TF32 is
    switched off for matmuls and cuDNN here."""
    device = resolve_device(device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    for t in rig:
        if t.device != device:
            raise ValueError(f"rig tensor on {t.device}, step on {device}")
    if voc is not None and any(c.device != device for c in voc.centroids):
        raise ValueError(f"vocabulary not on {device}")
    return _make_track_body(cfg, n_feats, voc, rig, device)


def make_track_fn(cfg: SystemConfig, n_feats: int,
                  voc: Optional[bow.Vocabulary], rig: CameraRig, device=None):
    """Build the fused per-frame tracking step on `device`; None means the
    current CUDA device, and raises where there is none.

    The returned function takes (images [ncam,H,W] u8 or f32, T_last [4,4],
    V [4,4], prev_slots [ncam,N] int64, cam_enabled [ncam] bool, mp_pos
    [M,3], mp_desc [M,8] int32, mp_valid [M], mp_max [M], mp_min [M],
    mp_norm [M,3]), all on `device`, and returns (FrameData,
    FusedTrackOut).  prev_slots are the previous frame's matched store
    slots (the reference's last-frame points); the store is the
    reference's device map store as flat tensors."""
    return _checked_body(cfg, n_feats, voc, rig, device)


def make_track_batch_fn(cfg: SystemConfig, n_feats: int,
                        voc: Optional[bow.Vocabulary], rig: CameraRig,
                        depth: int, device=None):
    """Depth-D batched variant of make_track_fn: the step run over a
    [D, ncam, H, W] image stack, chaining the pose, velocity and
    matched-slot carries on the device (the reference's lax.scan over the
    fused body, frontend.py:160-170).  Nothing is read back between
    frames, so the host queues all D frames without waiting for the card.

    The returned function takes the arguments of the one-frame step with
    images [D, ncam, H, W] and returns (carry, fds, outs): carry =
    (T_cw, V_new, mp_slots) after the last frame, fds a FrameData and outs
    a FusedTrackOut with a leading axis D on every leaf."""
    depth = int(depth)
    if depth < 1:
        raise ValueError(f"make_track_batch_fn: depth {depth} < 1")
    body = _checked_body(cfg, n_feats, voc, rig, device)

    def track_batch(images, T_last, V, prev_slots, cam_enabled, mp_pos,
                    mp_desc, mp_valid, mp_max, mp_min, mp_norm):
        if images.shape[0] != depth:
            raise ValueError(f"track_batch: built for depth {depth}, got "
                             f"{images.shape[0]} frames")
        carry = (T_last, V, prev_slots)
        fds, outs = [], []
        for img in images.unbind(0):
            fd, out = body(img, *carry, cam_enabled, mp_pos, mp_desc,
                           mp_valid, mp_max, mp_min, mp_norm)
            carry = (out.T_cw, out.V_new, out.mp_slots)
            fds.append(fd)
            outs.append(out)
        return carry, _stack_leaves(fds), _stack_leaves(outs)

    return track_batch
