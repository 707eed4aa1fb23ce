"""The per-frame device programs of the pipeline: extraction, the fused
dual-camera tracking step and its batched form, projection matching for
fusion, and keyframe-pair triangulation.

Port of orbslam2_dualcam_tpu/pipeline/frontend.py (make_extract_fn,
make_track_fn, make_track_batch_fn, project_and_match[_batch],
match_projection_pose, triangulate_pair[s_batch], match_bow_frame_kf,
match_desc_frame_kf).  The fused step: extraction on both cameras + BoW
quantization, stage-1 motion-model projection matching + pose optimization with the widened
retry, stage-2 local-map rematch + re-optimization, pose
re-orthonormalization and the velocity update.

The step never reads a value back to the host: the reference's widened
retry (a lax.cond) is a device-side select here, so a frame is one stream
of kernel launches.  On the card the step is that stream captured once as a
CUDA graph and replayed (GraphedStep): one graph launch per frame or per
batch instead of ~18,400 kernel launches from Python per frame.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional

import numpy as np
import torch

from orbslam2_dualcam_tpu_torch.utils.config import BAConfig, SystemConfig
from orbslam2_dualcam_tpu_torch.ops import (camera, epipolar, fast_nms, lie,
                                           matching, orb)
from orbslam2_dualcam_tpu_torch.ops.camera import CameraRig
from orbslam2_dualcam_tpu_torch.optim import pose_opt
from orbslam2_dualcam_tpu_torch.utils.device import resolve_device
from orbslam2_dualcam_tpu_torch.utils.profiling import span
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


def _checked_device(rig: CameraRig, voc: Optional[bow.Vocabulary],
                    device) -> torch.device:
    """`device` resolved (None: the current CUDA device), after checking
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
    return device


def _map_leaves(fn, tree):
    """`fn` over every tensor of a (nested) tuple or NamedTuple, in a tree
    of the same types."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    items = [_map_leaves(fn, t) for t in tree]
    return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)


class _Graph(NamedTuple):
    graph: "torch.cuda.CUDAGraph"
    inputs: list          # static input buffers, one per argument
    outputs: tuple        # the captured outputs, rewritten by each replay
    k1_launches: int      # K1 launches captured, so made by each replay
    keep: tuple           # cached tensors the graph reads by address


class GraphedStep:
    """A tracking step on the card, replayed from CUDA graphs of itself.

    The step is thousands of small kernels, so launching them from Python,
    not running them, sets its time.  Each key (the device, shape and dtype
    of every argument) runs its first call eagerly, which fills what the
    step caches (the ORB tables, cuBLAS's handles, K1's library).  Its
    second call captures the step on a side stream into a CUDA graph; that
    call and every later one copy the arguments into the graph's static
    inputs, replay the graph on the current stream, and return one fresh
    copy of each output leaf, which the caller owns: a later call never
    overwrites an earlier call's results.  A replay runs the eager call's
    kernels with the same arguments, K1 included (its launches are added to
    `fast_nms.launches` at each replay).

    The graphs of one step share a memory pool (their replays are
    serialized on the caller's stream).  Steps do not share one: a pool
    whose graphs have all been freed cannot take a new capture.

    A capture that raises leaves its key eager from then on; it is counted
    in `failures` and passed to `on_failure` (the tracker records it as an
    event).  On the CPU every call is the body's.

    `captures`, `replays` and `eager` count the calls of each kind; on the
    card each call is also a span `tracker.step` whose `graph` attribute is
    its kind."""

    _WARM, _FAILED = "warm", "failed"

    def __init__(self, body: Callable, device: torch.device,
                 constants: Optional[Callable] = None,
                 on_failure: Optional[Callable[[str], None]] = None) -> None:
        """`constants(*args)` returns the cached tensors outside `body`'s
        closure that the step reads, kept alive with the key's graph."""
        self.body = body
        self.device = device
        self._constants = constants
        self._on_failure = on_failure
        self.captures = self.replays = self.eager = 0
        self.failures: List[str] = []
        # key -> _WARM (its eager call ran), _FAILED (its capture raised)
        # or its _Graph
        self._keys: dict = {}
        self._pool = None           # the graphs' memory pool, made at need

    def __call__(self, *args):
        if self.device.type != "cuda":
            self.eager += 1
            return self.body(*args)
        key = tuple((a.device, a.dtype, tuple(a.shape)) for a in args)
        state = self._keys.get(key)
        mode = ("replay" if isinstance(state, _Graph) else
                "capture" if state == self._WARM else "eager")
        with span("tracker.step", graph=mode) as sp:
            if mode == "replay":
                self.replays += 1
                return self._replay(state, args)
            if mode == "capture":
                try:
                    g = self._capture(key, args)
                except Exception as exc:
                    self._fail(key, exc)
                    sp.set(graph="eager")
                else:
                    self.captures += 1
                    return self._replay(g, args)
            out = self.body(*args)
            self._keys.setdefault(key, self._WARM)
            self.eager += 1
            return out

    def _capture(self, key, args) -> _Graph:
        inputs = [a.clone() for a in args]
        keep = self._constants(*args) if self._constants is not None else ()
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        k1 = fast_nms.fast_nms.launches
        stream = torch.cuda.current_stream(self.device)
        try:
            # thread_local: the mapping thread may launch meanwhile
            with torch.cuda.device(self.device), torch.cuda.graph(
                    graph, pool=self._pool, capture_error_mode="thread_local"):
                outputs = self.body(*inputs)
        finally:
            n_k1 = fast_nms.fast_nms.launches - k1
            fast_nms.fast_nms.launches = k1     # nothing ran yet
            # a capture that fails to end leaves its side stream current
            torch.cuda.set_stream(stream)
        g = self._keys[key] = _Graph(graph, inputs, outputs, n_k1, keep)
        return g

    @staticmethod
    def _replay(g: _Graph, args):
        for buf, a in zip(g.inputs, args):
            buf.copy_(a)
        g.graph.replay()
        fast_nms.fast_nms.launches += g.k1_launches
        return _map_leaves(torch.clone, g.outputs)

    def _fail(self, key, exc: Exception) -> None:
        self._keys[key] = self._FAILED
        self._pool = None       # the next capture takes a pool of its own
        shapes = " ".join(f"{tuple(s)}:{str(d).replace('torch.', '')}"
                          for _, d, s in key)
        first = (str(exc).splitlines() or [""])[0]
        msg = f"graph capture failed ({shapes}): {type(exc).__name__}: {first}"
        self.failures.append(msg)
        if self._on_failure is not None:
            self._on_failure(msg)


def _step_constants(cfg: SystemConfig, voc: Optional[bow.Vocabulary]):
    """The cached tensors the step reads besides its arguments and its
    closure: the ORB tables of the image size, and the byte popcount table
    of the vocabulary's quantization."""
    def constants(images, *_):
        dev = images.device
        return (orb._tables(*images.shape[-2:], cfg.orb, dev),
                bow._byte_popcount(dev) if voc is not None else None)
    return constants


def make_extract_fn(cfg: SystemConfig, n_feats: int,
                    voc: Optional[bow.Vocabulary], rig: CameraRig,
                    device=None):
    """Build the per-frame extraction program on `device`; None means the
    current CUDA device, and raises where there is none.

    The returned function takes images [ncam, H, W] (u8 or f32) on `device`
    and returns the FrameData of `n_feats` keypoints per camera."""
    device = _checked_device(rig, voc, device)

    def extract_frame(images: torch.Tensor) -> FrameData:
        if images.device != device:
            raise ValueError(f"images on {images.device}, extraction on {device}")
        return _extract_frame_body(images, cfg, n_feats, voc, rig)

    return extract_frame


def make_track_fn(cfg: SystemConfig, n_feats: int,
                  voc: Optional[bow.Vocabulary], rig: CameraRig, device=None,
                  on_failure: Optional[Callable[[str], None]] = None):
    """Build the fused per-frame tracking step on `device`; None means the
    current CUDA device, and raises where there is none.

    The returned function takes (images [ncam,H,W] u8 or f32, T_last [4,4],
    V [4,4], prev_slots [ncam,N] int64, cam_enabled [ncam] bool, mp_pos
    [M,3], mp_desc [M,8] int32, mp_valid [M], mp_max [M], mp_min [M],
    mp_norm [M,3]), all on `device`, and returns (FrameData,
    FusedTrackOut).  prev_slots are the previous frame's matched store
    slots (the reference's last-frame points); the store is the
    reference's device map store as flat tensors.

    The function is a GraphedStep: on the card its calls after the first
    of a shape replay a CUDA graph of the step, and each returns tensors
    of its own; `on_failure` gets the message of a capture that failed.
    Its `body` is the step itself."""
    device = _checked_device(rig, voc, device)
    return GraphedStep(_make_track_body(cfg, n_feats, voc, rig, device),
                       device, _step_constants(cfg, voc), on_failure)


def make_track_batch_fn(cfg: SystemConfig, n_feats: int,
                        voc: Optional[bow.Vocabulary], rig: CameraRig,
                        depth: int, device=None,
                        on_failure: Optional[Callable[[str], None]] = None):
    """Depth-D batched variant of make_track_fn: the step run over a
    [D, ncam, H, W] image stack, chaining the pose, velocity and
    matched-slot carries on the device (the reference's lax.scan over the
    fused body, frontend.py:160-170).  Nothing is read back between
    frames, so the host queues all D frames without waiting for the card.

    The returned function takes the arguments of the one-frame step with
    images [D, ncam, H, W] and returns (carry, fds, outs): carry =
    (T_cw, V_new, mp_slots) after the last frame, fds a FrameData and outs
    a FusedTrackOut with a leading axis D on every leaf.  Like the
    one-frame step, it is a GraphedStep."""
    depth = int(depth)
    if depth < 1:
        raise ValueError(f"make_track_batch_fn: depth {depth} < 1")
    device = _checked_device(rig, voc, device)
    body = _make_track_body(cfg, n_feats, voc, rig, device)

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

    return GraphedStep(track_batch, device, _step_constants(cfg, voc),
                       on_failure)


def project_and_match_batch(T_preds, feats_uv, feats_desc, feats_level,
                            feats_valid, mp_pos, mp_desc, mp_valid,
                            mp_max_dist, mp_min_dist, mp_normal,
                            rig: CameraRig, radius, level_scales, max_hamming,
                            view_cos_th, cam_enabled):
    """project_and_match over a batch of target keyframes sharing one
    map-point set: the Fuse fan-out of SearchInNeighbors
    (LocalMapping.cc:492-570), which projects the same points into every
    covisible neighbour.  The reference vmaps; here the targets are a loop
    (each is already batched over cameras), so every row equals the
    one-target call exactly.

    Leading axis of T_preds/feats_* is the target keyframe; returns
    (mp_of_kp [B, ncam, N], vis_any [B, M])."""
    outs = [project_and_match(
        T_preds[i], feats_uv[i], feats_desc[i], feats_level[i],
        feats_valid[i], mp_pos, mp_desc, mp_valid, mp_max_dist, mp_min_dist,
        mp_normal, rig, radius, level_scales, max_hamming, view_cos_th,
        cam_enabled) for i in range(T_preds.shape[0])]
    return (torch.stack([o[0] for o in outs]),
            torch.stack([o[1] for o in outs]))


def triangulate_pair(T1, T2, cam: int, uv1, desc1, level1, free1,
                     uv2, desc2, level2, free2, rig: CameraRig,
                     level_scales, max_hamming):
    """New-map-point triangulation between two keyframes for one camera.

    LocalMapping::CreateNewMapPoints' inner loop (LocalMapping.cc:275-490):
    fundamental matrix from the two rig poses through camera `cam`'s
    extrinsic (ComputeF12, :812-873), epipolar-gated descriptor matching
    (SearchForTriangulation, ORBmatcher.cc:1253-1427), DLT triangulation
    and cheirality/parallax/reprojection checks.

    `cam` is a host int; free1/free2 mask keypoints not yet bound to a map
    point.  Returns (idx2_of_1 [N], X_world [N,3], good [N])."""
    K = rig.K[cam]
    T_sc = rig.T_sc[cam]
    T1c = T_sc @ T1
    T2c = T_sc @ T2
    F12 = epipolar.fundamental_from_poses(K, T1c, K, T2c)
    # epipole of camera 1 in image 2
    c1 = -T1c[:3, :3].T @ T1c[:3, 3]
    x2 = lie.se3_apply(T2c, c1)
    ez = torch.where(x2[2].abs() > 1e-9, x2[2], torch.full_like(x2[2], 1e-9))
    ep = torch.stack([K[0, 0] * x2[0] / ez + K[0, 2],
                      K[1, 1] * x2[1] / ez + K[1, 2]])
    sigma2_2 = level_scales[level2] ** 2
    allow = matching.epipolar_mask(F12, uv1, uv2, sigma2_2, ep, 100.0)
    # epipolar lines admit many repeated-texture candidates: require a
    # mutual best match and a ratio margin to keep association pure (the
    # reference gets the same effect from BoW-node restriction,
    # ORBmatcher.cc:1253-1427)
    res = matching.match_masked(desc1, desc2, allow=allow, valid_a=free1,
                                valid_b=free2, max_dist=max_hamming,
                                ratio=0.8, mutual=True)
    idx = res.idx
    m = idx >= 0
    sel = torch.where(m, idx, torch.zeros_like(idx))
    P1 = epipolar.projection_matrix(K, T1c)
    P2 = epipolar.projection_matrix(K, T2c)
    X = epipolar.triangulate_dlt(P1, P2, uv1, uv2[sel])
    s1 = level_scales[level1] ** 2
    s2 = sigma2_2[sel]
    good = m & epipolar.triangulation_checks(
        T1c, T2c, X, K, K, uv1, uv2[sel], s1, s2)
    return idx, X, good


def triangulate_pairs_batch(T1, T2, cam, uv1, desc1, level1, free1,
                            uv2, desc2, level2, free2, rig: CameraRig,
                            level_scales, max_hamming):
    """triangulate_pair over (neighbour, camera) pairs: the
    CreateNewMapPoints fan-out (LocalMapping.cc:275-490).  All arguments
    except rig/level_scales/max_hamming carry a leading pair axis (T1
    included: the current keyframe repeats); `cam` is a host sequence of
    ints.  A loop over the pairs, so every row equals the one-pair call
    exactly."""
    outs = [triangulate_pair(T1[i], T2[i], int(cam[i]), uv1[i], desc1[i],
                             level1[i], free1[i], uv2[i], desc2[i], level2[i],
                             free2[i], rig, level_scales, max_hamming)
            for i in range(T1.shape[0])]
    return tuple(torch.stack([o[j] for o in outs]) for j in range(3))


def match_bow_frame_kf(desc_f, nodes_f, angle_f, valid_f, desc_k, nodes_k,
                       angle_k, valid_k, max_dist, ratio: float):
    """SearchByBoWCrossCam Frame<->KF (ORBmatcher.cc:162-296): brute-force
    within equal direct-index nodes."""
    allow = matching.node_mask(nodes_f, nodes_k) & (nodes_f >= 0)[:, None]
    return matching.match_masked(
        desc_f, desc_k, allow=allow, valid_a=valid_f, valid_b=valid_k,
        max_dist=max_dist, ratio=ratio, angle_a=angle_f, angle_b=angle_k)


def match_desc_frame_kf(desc_f, angle_f, valid_f, desc_k, angle_k, valid_k,
                        max_dist, ratio: float):
    """Windowless descriptor-only Frame<->KF match: the fallback when the
    direct-index node mask of match_bow_frame_kf is too coarse (small
    training vocabularies collapse distinct features into one node's
    competition, or scatter true pairs across nodes).  The strict
    threshold, Lowe ratio, mutual-best and rotation histogram carry the
    outlier rejection instead."""
    return matching.match_masked(
        desc_f, desc_k, valid_a=valid_f, valid_b=valid_k,
        max_dist=max_dist, ratio=ratio, angle_a=angle_f, angle_b=angle_k,
        mutual=True)
