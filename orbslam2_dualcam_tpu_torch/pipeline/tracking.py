"""Tracking front end: per-frame state machine.

Port of orbslam2_dualcam_tpu/pipeline/tracking.py (src/Tracking.cc in the
original): the state machine, keyframe policy and map bookkeeping run on
the host over numpy mirrors; every per-frame numeric step (extraction,
projection matching, pose optimization, two-view initialization) is a
device program from pipeline/frontend.py and ops/, on the device the rig's
tensors lie on.

States: NOT_INITIALIZED -> OK -> (FULL once the dual map is scaled) / LOST.

What is ported: the synchronous mode, that is two-view initialization, the
fused one-readback frame with its host-stepped fallback cascade, keyframe
insertion, relocalization (by vocabulary and without one), localization
mode, and the dual-camera bootstrap: cross-camera relocalization, the
second map with its metric re-scaling by the known baseline, the FULL
state and its metric global BA; and the deferred mode
(`Tracker(deferred=True)`): frames are dispatched with the pose, velocity
and matched-slot carries left on the device, `pipeline_depth` frames per
dispatch (make_track_batch_fn) or one (lag 1), and the previous dispatch's
results are read back and processed while the new one runs.  With a
mesh (parallel/runtime.Mesh) the metric global BA goes through
`runtime.solve_ba_auto`, which shards a large problem over it.

Host <-> device traffic per tracked frame: one pinned upload of the u8
images, one pinned upload of the packed map store, and one readback of all
result leaves behind its own CUDA event (utils.device.Readback), so in the
deferred mode reading frame k-1 does not wait for frame k.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from orbslam2_dualcam_tpu_torch.models.kfdb import KeyFrameDatabase
from orbslam2_dualcam_tpu_torch.models.map import (KeyFrame, Map,
                                                   update_point_stats)
from orbslam2_dualcam_tpu_torch.ops import matching, ransac
from orbslam2_dualcam_tpu_torch.ops.camera import CameraRig
from orbslam2_dualcam_tpu_torch.optim import ba, scale_opt
from orbslam2_dualcam_tpu_torch.parallel import runtime
from orbslam2_dualcam_tpu_torch.pipeline import ba_pack, frontend
from orbslam2_dualcam_tpu_torch.pipeline.loop_closing import \
    apply_sim3_correction
from orbslam2_dualcam_tpu_torch.utils.config import SystemConfig
from orbslam2_dualcam_tpu_torch.utils.device import (Readback, resolve_device,
                                                      to_host, upload)
from orbslam2_dualcam_tpu_torch.utils.profiling import StageTimer, span
from orbslam2_dualcam_tpu_torch.vocab import bow


@dataclass
class HostFrame:
    """Numpy mirror of one frame's device features."""

    frame_id: int
    timestamp: float
    uv: np.ndarray        # [ncam, N, 2]
    level: np.ndarray     # [ncam, N]
    angle: np.ndarray
    desc: np.ndarray      # [ncam, N, 8] uint32
    valid: np.ndarray     # [ncam, N] bool
    words: np.ndarray
    nodes: np.ndarray
    T_cw: np.ndarray | None = None
    mp_ids: np.ndarray | None = None    # [ncam, N] map-point mid or -1
    response: np.ndarray | None = None  # [ncam, N] FAST score
    # device copies of (uv, desc, level, angle, valid), made on first use
    dev: tuple | None = None

    @property
    def ncam(self) -> int:
        return self.uv.shape[0]

    @property
    def n(self) -> int:
        return self.uv.shape[1]


class _Staging:
    """A reusable host buffer for uploads: pinned when the target is a CUDA
    device, so the copy does not block the host.  The buffer is rewritten
    only after the previous copy out of it has finished."""

    def __init__(self, shape, dtype: torch.dtype, device: torch.device) -> None:
        self.device = device
        self.buf = torch.empty(shape, dtype=dtype,
                               pin_memory=device.type == "cuda")
        self.np = self.buf.numpy()
        self._done = None

    def begin(self) -> np.ndarray:
        """The buffer as numpy, free to be rewritten."""
        if self._done is not None:
            with span("device.wait", kind="staging"):
                self._done.synchronize()
        return self.np

    def send(self) -> torch.Tensor:
        if self.device.type != "cuda":
            return self.buf.clone()
        out = self.buf.to(self.device, non_blocking=True)
        self._done = torch.cuda.Event()
        self._done.record(torch.cuda.current_stream(self.device))
        return out


# float32 columns of the packed store: pos 0:3, desc bits 3:11, normal
# 11:14, dmin 14, dmax 15, valid 16
_STORE_COLS = 17


class DeviceMapStore:
    """Device-resident padded SoA of the tracker's local map points,
    consumed by the fused track step (frontend.make_track_fn).

    The host repacks it once per tracked frame from the authoritative host
    map, which buys staleness-freedom (local BA rewrites point positions
    with no epoch signal the host could cheaply key off) while keeping the
    per-frame device traffic at one upload (the reference reads the live
    map under mMutexMapUpdate every stage, Tracking.cc:283).  The six
    arrays travel as one staging buffer and are cut apart on the device."""

    def __init__(self, cap: int, device=None) -> None:
        """`device` None is the current CUDA device."""
        self.cap = cap
        self.device = resolve_device(device)
        self.slot_mids = np.full(cap, -1, np.int64)
        self._sorted_mids = np.empty(0, np.int64)
        self._order = np.empty(0, np.int64)
        self.arrays = None   # (pos, desc, valid, dmax, dmin, normal)
        self._stage = _Staging((cap, _STORE_COLS), torch.float32, self.device)

    @property
    def n_valid(self) -> int:
        return int((self.slot_mids >= 0).sum())

    def refresh(self, m: Map, mids: np.ndarray, sticky: bool = False) -> None:
        """Repack from the host map.  sticky=True keeps surviving mids in
        their existing slots and fills freed slots with new mids (for a
        pipeline that dispatches frame k+1 before frame k's slot references
        are read back, where slot identity must survive refreshes)."""
        cap = self.cap
        mids = np.asarray(mids, np.int64)[:cap]
        if sticky and self.arrays is not None:
            keep = np.isin(self.slot_mids, mids) & (self.slot_mids >= 0)
            assigned = np.where(keep, self.slot_mids, -1)
            new = np.setdiff1d(mids, assigned[keep])
            free = np.nonzero(assigned < 0)[0]
            k = min(free.size, new.size)
            assigned[free[:k]] = new[:k]
            mids = assigned
        buf = self._stage.begin()
        buf[:] = 0.0
        buf[:, 15] = 1e9
        desc = buf[:, 3:11].view(np.uint32)
        slot_mids = np.full(cap, -1, np.int64)
        for i, mid in enumerate(mids):
            mp = m.points.get(int(mid))
            if mp is None or mp.is_bad:
                continue
            buf[i, 0:3] = mp.pos
            desc[i] = mp.desc
            buf[i, 11:14] = mp.normal
            buf[i, 14] = mp.min_dist
            buf[i, 15] = mp.max_dist if mp.max_dist > 0 else 1e9
            buf[i, 16] = 1.0
            slot_mids[i] = mid
        self.slot_mids = slot_mids
        self._order = np.argsort(slot_mids)
        self._sorted_mids = slot_mids[self._order]
        d = self._stage.send()
        self.arrays = (d[:, 0:3].contiguous(),
                       d[:, 3:11].contiguous().view(torch.int32),
                       d[:, 16] > 0.5, d[:, 15].contiguous(),
                       d[:, 14].contiguous(), d[:, 11:14].contiguous())

    def slots_of_mids(self, mids: np.ndarray) -> np.ndarray:
        """Vectorized mid -> store slot (-1 when absent).  -1 queries stay
        -1 (slot_mids uses -1 for empty slots, so a naive lookup would
        "find" them)."""
        mids = np.asarray(mids, np.int64)
        if self._sorted_mids.size == 0 or mids.size == 0:
            return np.full(mids.shape, -1, np.int64)
        j = np.clip(np.searchsorted(self._sorted_mids, mids), 0,
                    self._sorted_mids.size - 1)
        hit = (self._sorted_mids[j] == mids) & (mids >= 0)
        return np.where(hit, self._order[j], -1)

    def slots_to_mids(self, slots: np.ndarray) -> np.ndarray:
        out = np.full(slots.shape, -1, np.int64)
        ok = slots >= 0
        out[ok] = self.slot_mids[slots[ok]]
        return out


class Tracker:
    NOT_INITIALIZED = "NOT_INITIALIZED"
    OK = "OK"
    FULL = "FULL"
    LOST = "LOST"

    def __init__(self, cfg: SystemConfig, rig: CameraRig,
                 voc: Optional[bow.Vocabulary] = None,
                 slam_map: Optional[Map] = None,
                 kfdb: Optional[KeyFrameDatabase] = None,
                 local_mapper=None, mesh=None,
                 deferred: bool = False) -> None:
        """Runs on the device the rig's tensors lie on (the vocabulary must
        lie there too).  `deferred=True` selects the pipelined mode when
        the fused step is on (cfg.tracker.fused_tracking).  `mesh`: an
        optional parallel.runtime.Mesh for the metric global BA."""
        self.cfg = cfg
        self.rig = rig
        self.device = rig.K.device
        self.mesh = mesh
        self.voc = voc
        self.map = slam_map if slam_map is not None else Map()
        self.kfdb = kfdb
        self.local_mapper = local_mapper
        self.state = self.NOT_INITIALIZED

        self.extract = frontend.make_extract_fn(cfg, cfg.orb.n_track, voc,
                                                rig, device=self.device)
        # 2x feature budget while NOT_INITIALIZED (mpIniORBextractor,
        # Tracking.cc:204-207): a denser candidate pool makes the two-view
        # init both more likely to find 100 matches and better conditioned.
        # KeyFrames keep the uniform n_track shape: the init frames are
        # down-selected before KF creation (_shrink_frame)
        self.extract_init = (
            frontend.make_extract_fn(cfg, cfg.orb.n_init, voc, rig,
                                     device=self.device)
            if cfg.orb.n_init != cfg.orb.n_track else self.extract)
        # fused tracking (frontend.make_track_fn): the whole per-frame hot
        # path as one stream of launches + one batched readback
        # on the card both steps replay CUDA graphs; a failed capture
        # leaves its shape eager and is recorded as an event
        self._track_fused = (
            frontend.make_track_fn(cfg, cfg.orb.n_track, voc, rig,
                                   device=self.device,
                                   on_failure=self._graph_failed)
            if cfg.tracker.fused_tracking else None)
        self._store: Optional[DeviceMapStore] = None
        # deferred (pipelined) mode: dispatch frame k, then read and
        # process frame k-1's results while k runs on the device; the host
        # never waits for the frame it just dispatched
        self.deferred = deferred and self._track_fused is not None
        # in async+deferred mode the System hands us its map lock and we
        # take it only around map-touching host sections: the readback
        # wait runs unlocked so the mapping thread works during it (the
        # reference's LocalMapping-thread overlap, System.cc:126)
        self.map_lock = None
        # async back-pressure: when the mapping thread is behind, defer
        # keyframe insertion instead of queueing unboundedly (the
        # reference's idle check, Tracking.cc:1553-1560)
        self.mapper_busy: Optional[Callable[[], bool]] = None
        # async+deferred mode: returns once the mapping thread has put the
        # new points of every keyframe handed to it into the map (its
        # local BA may still run); called unlocked before the pipeline
        # re-packs the store the next dispatch tracks against
        self.mapper_sync: Optional[Callable[[], None]] = None
        self._pending = None    # in-flight dispatch (lag-1 or batch form)
        self._carry = None      # (T_cw, V, mp_slots) on the device
        self._batch: List[Tuple] = []   # buffered (u8 images, ts, fid)
        depth = max(1, int(cfg.tracker.pipeline_depth))
        self._depth = depth if self.deferred else 1
        self._track_batch = (
            frontend.make_track_batch_fn(cfg, cfg.orb.n_track, voc, rig,
                                         depth, device=self.device,
                                         on_failure=self._graph_failed)
            if self.deferred and depth > 1 else None)
        self.scale_factors = np.asarray(cfg.orb.scale_factors, np.float32)
        self._level_scales = torch.as_tensor(self.scale_factors,
                                             device=self.device)
        # host copies of the rig, read once
        self._T_sc_np, self._T_cs_np = to_host((rig.T_sc, rig.T_cs))
        # pinned upload buffers: "frame" for one frame's images, "batch"
        # for a deferred dispatch's [D, ncam, H, W] stack
        self._stages: Dict[str, _Staging] = {}

        self.frame_id = 0
        self.last: Optional[HostFrame] = None
        self.velocity: Optional[np.ndarray] = None
        self.ref_kid: int = -1
        self.last_kf_frame_id: int = -1
        self.init_frame: Optional[HostFrame] = None
        self.n_track_inliers = 0
        self._last_slot_mids = np.empty(0, np.int64)
        # RANSAC minimal sets are drawn on the CPU, so a run on the card and
        # a run on the CPU draw the same; `two_view_sampler` may be replaced
        # by a callable (n_hyp, valid) -> (idx_h, idx_f) to feed given sets
        self.gen = torch.Generator().manual_seed(int(cfg.vocab.seed))
        self.two_view_sampler = (
            lambda n_hyp, valid: ransac.two_view_samples(self.gen, n_hyp,
                                                         valid))
        # likewise for PnP: (n_hyp, valid) -> (idx6, idx4)
        self.pnp_sampler = (
            lambda n_hyp, valid: ransac.pnp_samples(self.gen, n_hyp, valid))
        # localization-only mode: track against the frozen map, no new
        # keyframes/mapping (ActivateLocalizationMode, System.cc:182-199)
        self.localization_only = False
        # manual fault injection (SetCompulsoryLost, System.cc:330-333)
        self._force_lost = False
        # dual-camera bootstrap state (Tracking.h:102-103 counters)
        self.cross_reloc_scales: List[float] = []
        self.pending_cross: List[Tuple] = []   # pre-scale reloc anchors
        self._last_xreloc: Optional[Tuple] = None
        self.next_cross_try: int = 0
        self.last_reloc_cam_pose: Optional[np.ndarray] = None  # for viz
        # cross-edge count at the last metric GBA: the periodic refresh
        # re-fires when the map has accumulated substantially more
        # scale-carrying observations (see _maybe_metric_refresh)
        self._xedges_at_gba: int = 0
        # diagnostics
        self.timer = StageTimer("tracker")
        self.trajectory: List[Tuple] = []
        self.events: List[str] = []
        self.n_fused_frames = 0      # frames whose pose came from the fused step
        self.n_stepped_frames = 0    # frames tracked by the host-stepped cascade
        self.n_pose_opt_calls = 0    # optimize_pose calls of the host-stepped path

    def reset_state(self) -> None:
        """Clear every per-run field (Tracking::Reset, Tracking.cc:1863-
        1918).  Kid numbering restarts at 0 after Map.clear(), so any
        stale bootstrap anchor or reloc handle would silently resolve
        against unrelated NEW keyframes with recycled ids."""
        self.state = self.NOT_INITIALIZED
        self.last = None
        self.velocity = None
        self.ref_kid = -1
        self.last_kf_frame_id = -1
        self.init_frame = None
        self.n_track_inliers = 0
        self.localization_only = False
        self._force_lost = False
        self.cross_reloc_scales.clear()
        self.pending_cross.clear()
        self._last_xreloc = None
        self.next_cross_try = 0
        self.last_reloc_cam_pose = None
        self._xedges_at_gba = 0
        self.trajectory.clear()
        self._pending = None
        self._carry = None
        self._store = None
        self._batch = []

    # ------------------------------------------------------------------
    def process(self, images: np.ndarray, timestamp: float) -> str:
        """Main per-frame entry (System::TrackDual -> Tracking::GrabImageDual,
        System.cc:153-180).  images [ncam, H, W] u8 or float grayscale.

        In deferred mode the returned state (and all bookkeeping) lags up
        to 2*depth-1 frames: frames are dispatched to the device in
        batches of `pipeline_depth`, and the previous batch's results are
        read and processed while the new one computes."""
        if self.deferred:
            r = self._process_deferred(images, timestamp)
            if r is not None:
                return r
        with self._lock():
            return self._process_sync(images, timestamp)

    def _lock(self):
        return (self.map_lock if self.map_lock is not None
                else contextlib.nullcontext())

    def _process_sync(self, images: np.ndarray, timestamp: float,
                      fid: Optional[int] = None) -> str:
        frame = None
        fused_out = None
        if self._can_fuse():
            with self.timer("fused"):
                r = self._dispatch_fused(images, timestamp, fid=fid)
            if r is not None:
                frame, fused_out = r
        if frame is None:
            with self.timer("extract"):
                ex = (self.extract_init
                      if self.state == self.NOT_INITIALIZED
                      else self.extract)
                fd = ex(self._stage_images(images))
                frame = self._pull(to_host(self._fd_leaves(fd)), timestamp,
                                   frame_id=fid)
        if fid is None:
            self.frame_id += 1

        if self._force_lost and self.state in (self.OK, self.FULL):
            self._force_lost = False
            self.state = self.LOST
            self.events.append(f"FORCED_LOST@{frame.frame_id}")
        if self.state == self.NOT_INITIALIZED:
            with self.timer("initialize"):
                self._monocular_initialization(frame)
        elif self.state in (self.OK, self.FULL):
            with self.timer("track"):
                ok = self._track(frame, fused=fused_out)
            if not ok:
                self.state = self.LOST
                self.events.append(f"LOST@{frame.frame_id}")
        if self.state == self.LOST:
            with self.timer("relocalize"):
                ok = self._relocalize(frame)
            if ok:
                self.state = self.OK
                self.events.append(f"RELOC@{frame.frame_id}")

        self._record_trajectory(frame, timestamp)
        self.last = frame
        return self.state

    def _record_trajectory(self, frame: HostFrame, timestamp: float) -> None:
        """Store the pose RELATIVE to the reference keyframe so later
        BA / loop corrections retro-apply at save time, as the
        reference's mlRelativeFramePoses does (System.cc:340-370)."""
        if frame.T_cw is None:
            return
        ref = self.map.keyframes.get(self.ref_kid)
        if ref is not None:
            T_rel = frame.T_cw @ np.linalg.inv(ref.T_cw)
            self.trajectory.append(
                (frame.frame_id, timestamp, self.ref_kid, T_rel,
                 frame.T_cw.copy()))

    # ------------------------------------------------------------------
    # fused tracking
    # ------------------------------------------------------------------
    def _can_fuse(self) -> bool:
        return (self._track_fused is not None
                and self.state in (self.OK, self.FULL)
                and not self._force_lost
                and self.last is not None and self.last.T_cw is not None
                and self.last.mp_ids is not None
                and int((self.last.mp_ids >= 0).sum()) >= 10)

    def _graph_failed(self, msg: str) -> None:
        self.events.append(f"GRAPHFAIL@{self.frame_id} {msg}")

    def _dispatch_fused(self, images: np.ndarray, ts: float,
                        fid: Optional[int] = None):
        """Run the whole tracked frame as one stream of launches + ONE
        batched readback (frontend.make_track_fn).  Returns (HostFrame,
        (out, slot_mids)) or None to fall back to the host-stepped path."""
        last = self.last
        # refreshed at dispatch time, under whatever map lock the caller
        # holds, so the packed snapshot is consistent with the host map
        self._refresh_store(last)
        st = self._store
        if st is None or st.n_valid < 10:
            return None
        prev_slots = st.slots_of_mids(last.mp_ids)
        V = self.velocity if self.velocity is not None else np.eye(4)
        fd, out = self._track_fused(
            self._stage_images(images),
            upload(last.T_cw.astype(np.float32), self.device),
            upload(V.astype(np.float32), self.device),
            upload(prev_slots, self.device),
            upload(self._cam_enabled(), self.device), *st.arrays)
        fd_leaves = self._fd_leaves(fd)
        host = to_host(fd_leaves + list(out))
        fd_h = host[:len(fd_leaves)]
        out_h = frontend.FusedTrackOut(*host[len(fd_leaves):])
        return (self._pull(fd_h, ts, frame_id=fid),
                (out_h, st.slot_mids.copy()))

    def _finish_fused(self, frame: HostFrame, out,
                      slot_mids: np.ndarray) -> bool:
        """Adopt the fused step's pose/matches and run the shared per-frame
        bookkeeping (the host half of TrackLocalMap, Tracking.cc:1478-
        1520).  `slot_mids` is the store slot->mid table as of this frame's
        dispatch."""
        cfg = self.cfg
        frame.T_cw = np.asarray(out.T_cw, np.float64)
        mp_slots = np.asarray(out.mp_slots)
        mids = np.full(mp_slots.shape, -1, np.int64)
        ok = mp_slots >= 0
        mids[ok] = slot_mids[mp_slots[ok]]
        frame.mp_ids = mids
        n_final = int(out.n_final)
        self.n_track_inliers = n_final
        if n_final < cfg.tracker.min_matches_track:
            frame.T_cw = None
            frame.mp_ids = np.full_like(frame.mp_ids, -1)
            return False
        found_mids = {int(mid) for mid in frame.mp_ids[frame.mp_ids >= 0]}
        vis_mids = set(found_mids)
        vis = np.asarray(out.mp_visible)
        vis_mids.update(
            int(m) for m in slot_mids[vis & (slot_mids >= 0)])
        for mid in vis_mids:
            mp = self.map.points.get(mid)
            if mp is not None:
                mp.n_visible += 1
                if mid in found_mids:
                    mp.n_found += 1
        self.n_fused_frames += 1
        return self._track_tail(frame)

    # ------------------------------------------------------------------
    # deferred (pipelined) mode
    # ------------------------------------------------------------------
    def _process_deferred(self, images: np.ndarray, ts: float):
        """Dispatch frame k with device-resident carries (pose, velocity,
        previous matched slots), then read & process frame k-1 while k
        computes.  Returns the state as of the last processed frame, or
        None to fall back to the synchronous path (pipeline drained).

        Map-touching sections run under self._lock(); the readback wait in
        _process_pending runs unlocked so the mapping thread works during
        the device wait."""
        if self._carry is None:
            self._sync_mapper()
        with self._lock():
            eligible = (self.state in (self.OK, self.FULL)
                        and not self._force_lost)
            if eligible and self._carry is None:
                # pipeline start: seed the carries from the last processed
                # frame
                last = self.last
                if (last is None or last.T_cw is None
                        or last.mp_ids is None
                        or int((last.mp_ids >= 0).sum()) < 10):
                    eligible = False
                else:
                    self._refresh_store(last, sticky=True)
                    st = self._store
                    if st is None or st.n_valid < 10:
                        eligible = False
                    else:
                        V = (self.velocity if self.velocity is not None
                             else np.eye(4))
                        # canonical [ncam, n_track] slot layout whatever the
                        # seed frame's feature budget (init frames carry 2x
                        # features; the carry's shape must be fixed)
                        sl = st.slots_of_mids(last.mp_ids)
                        sl = sl[sl >= 0]
                        seed = np.full(
                            (self.cfg.n_cameras, self.cfg.orb.n_track),
                            -1, np.int64)
                        seed.reshape(-1)[:sl.size] = sl[:seed.size]
                        self._carry = (
                            upload(last.T_cw.astype(np.float32), self.device),
                            upload(V.astype(np.float32), self.device),
                            upload(seed, self.device))
        if not eligible or self._store is None:
            self._drain_pending()
            return None

        st = self._store
        if self._depth > 1:
            # batched pipeline: buffer D frames, dispatch them as one
            # make_track_batch_fn call, and process the PREVIOUS batch
            # while the new one computes
            self._batch.append((self._to_u8(np.asarray(images)), ts,
                                self.frame_id))
            self.frame_id += 1
            if len(self._batch) < self._depth:
                return self.state
            imgs = np.stack([b[0] for b in self._batch])
            metas = [(b[1], b[2]) for b in self._batch]
            self._batch = []
            with self.timer("fused_dispatch"):
                carry, fds, outs = self._track_batch(
                    self._stage(imgs, "batch"), *self._carry,
                    upload(self._cam_enabled(), self.device), *st.arrays)
                readback = Readback(self._fd_leaves(fds) + list(outs))
            self._carry = carry
            pending = self._pending
            self._pending = ("batch", readback, metas, st.slot_mids.copy())
            if pending is None:
                return self.state
            return self._process_pending(pending)

        with self.timer("fused_dispatch"):
            fd, out = self._track_fused(
                self._stage_images(images), *self._carry,
                upload(self._cam_enabled(), self.device), *st.arrays)
            readback = Readback(self._fd_leaves(fd) + list(out))
        self._carry = (out.T_cw, out.V_new, out.mp_slots)
        fid = self.frame_id
        self.frame_id += 1
        pending = self._pending
        self._pending = ("one", readback, [(ts, fid)], st.slot_mids.copy())
        if pending is None:
            return self.state
        return self._process_pending(pending)

    @staticmethod
    def _split_host(host: list, d: Optional[int]):
        """A dispatch's read-back leaves -> (fd leaves, FusedTrackOut) of
        frame `d` of a batch (None: a one-frame dispatch)."""
        leaves = host if d is None else [a[d] for a in host]
        n_out = len(frontend.FusedTrackOut._fields)
        return leaves[:-n_out], frontend.FusedTrackOut(*leaves[-n_out:])

    def _process_pending(self, pending) -> str:
        """Read back and fully process previously dispatched frame(s)
        (the host half of the pipeline, running a batch behind)."""
        kind, readback, metas, slot_mids = pending
        with self.timer("fused_get"):
            host = readback.wait()
        items = [(*self._split_host(host, d if kind == "batch" else None),
                  ts, fid) for d, (ts, fid) in enumerate(metas)]
        with self._lock():
            for i, (fd_h, out_h, ts, fid) in enumerate(items):
                clean = self._process_one(fd_h, out_h, ts, fid, slot_mids)
                if not clean:
                    # later frames of this batch were computed with a
                    # carry this frame's processing just invalidated
                    # (failure or a cascade-recovered pose).  Their fused
                    # poses are garbage, but their EXTRACTION never
                    # depended on the carry: re-track each through the
                    # host cascade instead of dropping it, so the
                    # trajectory stays complete across pipeline aborts
                    for fd2, _, ts2, fid2 in items[i + 1:]:
                        self.events.append(f"RESCUE@{fid2}")
                        self._host_reprocess(fd2, ts2, fid2)
                    self._abort_pipeline(rescue=True)
                    return self.state
        self._sync_mapper()
        with self._lock():
            # repack (sticky) so the NEXT dispatch sees this batch's map
            # updates (new KFs / points / local BA)
            self._refresh_store(self.last, sticky=True)
            if self._store is None or self._store.n_valid < 10:
                self._abort_pipeline(rescue=True)
        return self.state

    def _sync_mapper(self) -> None:
        """With the mapping thread: wait (unlocked) until it has
        triangulated and fused the keyframes handed to it, so the store
        packed next holds their points.  Without the wait a tracker that
        outruns the mapper tracks against a map that falls ever further
        behind the camera and loses it; local BA still runs beside the
        tracker.  A span `tracker.mapper_wait`."""
        if self.mapper_sync is not None:
            with span("tracker.mapper_wait"):
                self.mapper_sync()

    def _relocalize_after_loss(self, frame: HostFrame) -> None:
        self.state = self.LOST
        self.events.append(f"LOST@{frame.frame_id}")
        with self.timer("relocalize"):
            ok = self._relocalize(frame)
        if ok:
            self.state = self.OK
            self.events.append(f"RELOC@{frame.frame_id}")

    def _host_reprocess(self, fd_h: list, ts: float, fid: int) -> None:
        """Track one already-extracted frame through the host cascade
        (used when a deferred batch's device carry chain is invalid:
        extraction is carry-independent, so the frame is still fully
        recoverable)."""
        with span("tracker.frame", frame=fid, path="host"):
            frame = self._pull(fd_h, ts, frame_id=fid)
            ok = False
            if self.state in (self.OK, self.FULL):
                with self.timer("track"):
                    ok = self._track(frame)
            if not ok:
                self._relocalize_after_loss(frame)
            self._record_trajectory(frame, ts)
            self.last = frame

    def _process_one(self, fd_h: list, out_h, ts: float, fid: int,
                     slot_mids: np.ndarray) -> bool:
        """Full host-side processing of one read-back frame.  Returns
        True iff the frame was cleanly accepted on the fused path (i.e.
        the device carry chain remains valid)."""
        with span("tracker.frame", frame=fid, path="fused"):
            frame = self._pull(fd_h, ts, frame_id=fid)
            n1 = int(out_h.n_stage1)
            n_final = int(out_h.n_final)
            if n1 < self.cfg.tracker.min_matches_motion:
                self.events.append(f"THIN@{fid} n1={n1} nf={n_final}")
            with self.timer("track"):
                # accept on a healthy stage-1 OR a stage-2 rescue: the local-
                # map rematch re-optimized against the FULL store, so a thin
                # motion-model start with a solid final count is a good frame;
                # only a thin FINAL count falls back to the host cascade (the
                # synchronous path's rule, _track, accepts stage 1 alone)
                ok = ((n1 >= self.cfg.tracker.min_matches_motion
                       or n_final >= self.cfg.tracker.min_matches_motion)
                      and self._finish_fused(frame, out_h, slot_mids))
                if not ok and self.state in (self.OK, self.FULL):
                    # host fallback cascade on the materialized frame before
                    # declaring LOST (same order as the sync path)
                    ok = self._track(frame)
            clean = ok and frame.T_cw is not None and np.allclose(
                frame.T_cw, np.asarray(out_h.T_cw, np.float64), atol=1e-5)
            if not ok:
                self._relocalize_after_loss(frame)
            self._record_trajectory(frame, ts)
            self.last = frame
            return clean and self.state in (self.OK, self.FULL)

    def flush(self) -> str:
        """Drain the deferred pipeline: process the in-flight frames (call
        before reading final trajectories / shutting down).  Nothing is in
        flight in the synchronous mode."""
        self._drain_pending()
        return self.state

    def _abort_pipeline(self, rescue: bool = False) -> None:
        """Invalidate the in-flight dispatch's carry chain.  With
        rescue=True the in-flight frames are read back and re-tracked
        through the host cascade (their extraction is carry-independent);
        otherwise they are dropped with a visible DROPFRAME event."""
        pending, self._pending = self._pending, None
        self._carry = None
        if pending is None:
            return
        kind, readback, metas, _ = pending
        if not rescue:
            for _, fid in metas:
                self.events.append(f"DROPFRAME@{fid}")
            return
        with self.timer("fused_get"):
            host = readback.wait()
        for d, (ts, fid) in enumerate(metas):
            fd_h, _ = self._split_host(host, d if kind == "batch" else None)
            self.events.append(f"RESCUE@{fid}")
            self._host_reprocess(fd_h, ts, fid)

    def _drain_pending(self) -> None:
        """Process any in-flight + buffered frames before leaving the
        pipelined mode (shutdown, reloc, state change)."""
        pending, self._pending = self._pending, None
        if pending is not None:
            self._process_pending(pending)
        buffered, self._batch = self._batch, []
        self._carry = None
        for img, ts, fid in buffered:
            with self._lock(), span("tracker.frame", frame=fid, path="sync"):
                self._process_sync(img, ts, fid=fid)

    def _to_u8(self, images: np.ndarray) -> np.ndarray:
        if images.dtype == np.uint8 or not self.cfg.tracker.images_u8:
            return images.astype(np.float32, copy=False) \
                if images.dtype != np.uint8 else images
        return np.clip(np.round(images), 0, 255).astype(np.uint8)

    def _stage_images(self, images: np.ndarray) -> torch.Tensor:
        """Upload one frame's images through a pinned staging buffer, as
        uint8 when cfg.tracker.images_u8 (4x fewer bytes; 8-bit grayscale
        is the reference's native input domain, GrabImageDual
        Tracking.cc:236-269); the extraction converts to f32 on the device
        either way."""
        return self._stage(self._to_u8(np.asarray(images)), "frame")

    def _stage(self, img: np.ndarray, key: str) -> torch.Tensor:
        """Upload `img` (u8 or f32) through the pinned staging buffer
        `key`, which is rewritten only after its previous copy finished."""
        dtype = torch.uint8 if img.dtype == np.uint8 else torch.float32
        st = self._stages.get(key)
        if st is None or st.np.shape != img.shape or st.buf.dtype != dtype:
            st = self._stages[key] = _Staging(img.shape, dtype, self.device)
        st.begin()[...] = img
        return st.send()

    def _refresh_store(self, frame: HostFrame, sticky: bool = False) -> bool:
        """Repack the device-resident local map around `frame`'s view.
        Returns False (and drops the store, so no caller can dispatch
        against stale geometry) when the view is too point-starved."""
        tracked = (np.unique(frame.mp_ids[frame.mp_ids >= 0])
                   if frame.mp_ids is not None else np.empty(0, np.int64))
        cap = self.cfg.tracker.fused_cap
        others = (np.setdiff1d(self._local_map_points(frame), tracked)
                  if tracked.size else np.empty(0, np.int64))
        mids = np.concatenate([tracked, others])[:cap]
        if mids.size < 10:
            self._store = None
            return False
        if self._store is None or self._store.cap != cap:
            self._store = DeviceMapStore(cap, self.device)
        with self.timer("store_refresh"):
            self._store.refresh(self.map, mids, sticky=sticky)
        return True

    # ------------------------------------------------------------------
    @staticmethod
    def _fd_leaves(fd: frontend.FrameData) -> list:
        f = fd.feats
        return [f.uv, f.level, f.angle, f.desc, f.valid, fd.words, fd.nodes,
                f.response]

    def _pull(self, fd_h: list, ts: float,
              frame_id: Optional[int] = None) -> HostFrame:
        """HostFrame from the host copies of `_fd_leaves`."""
        uv, level, angle, desc, valid, words, nodes, response = fd_h
        return HostFrame(
            frame_id=self.frame_id if frame_id is None else frame_id,
            timestamp=ts, uv=uv, level=level, angle=angle,
            desc=desc.view(np.uint32), valid=valid, words=words, nodes=nodes,
            mp_ids=np.full(valid.shape, -1, np.int64), response=response)

    # ------------------------------------------------------------------
    # initialization (Tracking.cc:1928-2112)
    # ------------------------------------------------------------------
    def _monocular_initialization(self, frame: HostFrame) -> None:
        cfg = self.cfg
        n_valid = int(frame.valid[0].sum())
        if self.init_frame is None:
            if n_valid >= cfg.init.min_matches:
                self.init_frame = frame
            return
        if n_valid < cfg.init.min_matches:
            self.init_frame = None
            return
        f0 = self.init_frame
        dev = self.device
        # SearchForInitialization: 100px window, ratio 0.9, rotation check
        uv_a, uv_b = upload(f0.uv[0], dev), upload(frame.uv[0], dev)
        res = matching.match_masked(
            upload(f0.desc[0], dev), upload(frame.desc[0], dev),
            allow=matching.window_mask(uv_a, uv_b, 100.0),
            valid_a=upload(f0.valid[0], dev),
            valid_b=upload(frame.valid[0], dev),
            max_dist=float(cfg.matcher.th_low), ratio=0.9,
            angle_a=upload(f0.angle[0], dev),
            angle_b=upload(frame.angle[0], dev))
        idx = to_host((res.idx,))[0]
        rows0 = np.nonzero(idx >= 0)[0]
        if len(rows0) < cfg.init.min_matches:
            self.init_frame = frame      # slide the window
            return
        rows1 = idx[rows0]
        tv = self._two_view(f0.uv[0][rows0], frame.uv[0][rows1])
        if not bool(tv.success):
            return
        self._create_initial_map(f0, frame, rows0, rows1, tv)

    def _two_view(self, uv1: np.ndarray, uv2: np.ndarray) -> ransac.TwoViewResult:
        """two_view_init on the device; the result's leaves come back as
        numpy after one wait; a span `tracker.two_view`."""
        with span("tracker.two_view"):
            cfg = self.cfg
            valid = torch.ones(len(uv1), dtype=torch.bool, device=self.device)
            idx_h, idx_f = self.two_view_sampler(cfg.init.ransac_iters, valid)
            tv = ransac.two_view_solve(
                idx_h.to(self.device), idx_f.to(self.device),
                upload(uv1.astype(np.float32), self.device),
                upload(uv2.astype(np.float32), self.device), valid,
                self.rig.K[0], sigma=cfg.init.sigma,
                min_parallax_deg=cfg.init.min_parallax_deg,
                min_triangulated=cfg.init.min_triangulated)
            return ransac.TwoViewResult(*to_host(tv))

    def _create_initial_map(self, f0: HostFrame, f1: HostFrame,
                            rows0: np.ndarray, rows1: np.ndarray,
                            tv: ransac.TwoViewResult) -> None:
        """CreateInitialMapMonocular (Tracking.cc:2007-2112): two KFs, the
        triangulated points, a 20-iteration global BA, then median-depth
        normalization to depth 1."""
        cfg = self.cfg
        inl = np.asarray(tv.inliers)
        pts = np.asarray(tv.points)
        T21 = np.asarray(tv.T_21)

        med = float(np.median(pts[inl, 2]))
        if med <= 0 or inl.sum() < cfg.init.min_triangulated:
            return
        pts = pts / med
        T21 = T21.copy()
        T21[:3, 3] /= med

        m = self.map
        # init frames carry the 2x n_init budget (Tracking.cc:204-207);
        # down-select to the uniform n_track KeyFrame shape, keeping every
        # triangulated row
        f0s, map0 = self._shrink_frame(f0)
        f1s, map1 = self._shrink_frame(f1)
        kf0 = self._make_keyframe(f0s, np.eye(4, dtype=np.float64))
        kf1 = self._make_keyframe(f1s, T21.astype(np.float64))
        for i in np.nonzero(inl)[0]:
            r0 = int(map0[rows0[i]])
            r1 = int(map1[rows1[i]])
            if r0 < 0 or r1 < 0:    # dropped by the n_track down-select
                continue
            mp = m.new_point(pts[i], kf1.kid, 0)
            m.add_observation(mp, kf0, r0, 0)
            m.add_observation(mp, kf1, r1, 0)
            update_point_stats(mp, m, self._T_sc_np, self.scale_factors)
        m.update_connections(kf0)
        m.update_connections(kf1)

        # global BA, then re-normalize median scene depth to 1 (the BA can
        # move the gauge): Tracking.cc:2045-2087
        self._global_ba_two(kf0, kf1, iters=cfg.ba.global_iters)
        depths = [float(lie_apply_z(kf1.T_cw, p.pos))
                  for p in m.points.values()]
        med2 = float(np.median(depths)) if depths else 1.0
        if med2 > 0:
            s = 1.0 / med2
            for kf in (kf0, kf1):
                kf.T_cw[:3, 3] *= s
            for p in m.points.values():
                p.pos = p.pos * s
                update_point_stats(p, m, self._T_sc_np, self.scale_factors)

        f1.T_cw = kf1.T_cw.copy()
        f1.mp_ids[0][rows1[inl]] = [
            kf1.mp_idx[int(map1[int(r)])] if map1[int(r)] >= 0 else -1
            for r in rows1[inl]]
        self.ref_kid = kf1.kid
        self.last_kf_frame_id = f1.frame_id
        self.velocity = None
        self.state = self.OK
        self.events.append(
            f"INIT@{f1.frame_id} pts={m.n_points}")
        if self.local_mapper is not None:
            self.local_mapper.on_new_keyframe(kf0, run_ba=False)
            self.local_mapper.on_new_keyframe(kf1, run_ba=False)
        if self.kfdb is not None:
            self._kfdb_add(kf0)
            self._kfdb_add(kf1)
        self.init_frame = None

    def _shrink_frame(self, frame: HostFrame):
        """Down-select an n_init-sized init frame to the uniform n_track
        shape by descending FAST response: the 2x budget's extra (weaker)
        corners strengthen the two-view RANSAC geometry but would degrade
        the persistent map if triangulated.  Returns (shrunk HostFrame,
        row_map [n] old->new or -1)."""
        n_out = self.cfg.orb.n_track
        ncam, n = frame.valid.shape
        if n <= n_out:
            return frame, np.arange(n)
        resp = (frame.response if frame.response is not None
                else np.zeros((ncam, n), np.float32))
        sels = []
        row_map = np.full(n, -1, np.int64)
        for c in range(ncam):
            key = np.where(frame.valid[c], resp[c], -np.inf)
            sel = np.argsort(-key, kind="stable")[:n_out]
            sels.append(sel)
            if c == 0:
                row_map[sel] = np.arange(len(sel))
        sels = np.stack(sels)                                   # [ncam, n_out]
        gather = lambda a: np.stack([a[c][sels[c]] for c in range(ncam)])
        out = HostFrame(
            frame_id=frame.frame_id, timestamp=frame.timestamp,
            uv=gather(frame.uv), level=gather(frame.level),
            angle=gather(frame.angle), desc=gather(frame.desc),
            valid=gather(frame.valid), words=gather(frame.words),
            nodes=gather(frame.nodes), T_cw=frame.T_cw,
            mp_ids=np.full((ncam, n_out), -1, np.int64),
            response=gather(resp))
        return out, row_map

    def _global_ba_two(self, kf0: KeyFrame, kf1: KeyFrame, iters: int):
        prob, all_kids, mids, meta = ba_pack.pack_problem(
            self.map, [kf0.kid, kf1.kid], fixed_kids={kf0.kid},
            level_sigma2=self.scale_factors ** 2, ncam=self.cfg.n_cameras,
            device=self.device)
        res = ba.solve_ba(prob, self.rig.T_sc, self.rig.adj_sc, self.rig.K,
                          iters=iters)
        ba_pack.unpack_result(self.map, res, all_kids, mids, meta,
                              chi2_th=self.cfg.ba.chi2_mono)

    # ------------------------------------------------------------------
    # tracking (Tracking.cc:271-447)
    # ------------------------------------------------------------------
    def _track(self, frame: HostFrame, fused=None) -> bool:
        cfg = self.cfg
        if fused is not None:
            out, slot_mids = fused
            # only a healthy stage-1 accepts the fused result: on a thin
            # motion-model the host cascade (ref-KF attempts, windowless
            # descriptor match) is affordable and more accurate than a
            # stage-2 rescue
            if int(out.n_stage1) >= cfg.tracker.min_matches_motion:
                return self._finish_fused(frame, out, slot_mids)
            # thin motion-model result: fall through to the host-stepped
            # cascade below (rare; the fused stage-1 work is discarded, its
            # extraction is reused)
        last = self.last
        if self.velocity is not None:
            T_pred = self.velocity @ last.T_cw
        else:
            T_pred = last.T_cw.copy()

        # stage 1: motion-model matching against last frame's map points;
        # on a thin result retry once with a doubled window, the
        # reference's recovery inside TrackWithMotionModel
        # (Tracking.cc:1407-1414)
        mids1 = np.unique(last.mp_ids[last.mp_ids >= 0])
        r1 = self._match_stage(frame, T_pred, mids1, radius=15.0,
                               max_hamming=float(cfg.matcher.th_high))
        n1 = int(r1.n_inliers) if r1 is not None else 0
        slot_mids_r1 = self._last_slot_mids
        if n1 < cfg.tracker.min_matches_motion:
            # widened retry, keeping whichever result is BETTER: a wider
            # window on ambiguous texture can harvest aliased matches that
            # diverge the pose opt, so the retry must never clobber an
            # acceptable narrow-window result
            r1b = self._match_stage(frame, T_pred, mids1, radius=30.0,
                                    max_hamming=float(cfg.matcher.th_high))
            n1b = int(r1b.n_inliers) if r1b is not None else 0
            if n1b > n1:
                r1, n1 = r1b, n1b
                slot_mids_r1 = self._last_slot_mids
        if r1 is not None and n1 >= cfg.tracker.min_matches_motion:
            T_cur = np.asarray(r1.T_cw)
            frame_mp = self._slots_to_mids(r1, slot_mids=slot_mids_r1)
        else:
            # fallback cascade, mirroring the reference's
            # TrackWithMotionModel -> TrackReferenceKeyFrame order
            # (Tracking.cc:347-361).  (a) reference-KF points in a wide
            # window from the LAST pose (survives a broken velocity
            # model); (b) the same points with NO spatial window at
            # strict th_low, the role of SearchByBoW
            # (ORBmatcher.cc:50-145), which matches purely by descriptor
            # so it survives abrupt turns whose optical flow exceeds any
            # fixed window; (c) a thin-but-usable motion-model result
            # (the reference accepts >=10 map matches, Tracking.cc:1451).
            ref = self.map.keyframes.get(self.ref_kid)
            mids2 = (np.unique(ref.mp_idx[ref.mp_idx >= 0])
                     if ref is not None else np.empty(0, np.int64))
            # evaluate the fallbacks and keep the highest-consensus pose,
            # each seeded from the velocity-predicted pose AND the last
            # pose; inlier count is the arbiter the reference's sequential
            # cascade approximates
            attempts = [(T_pred, mids2, 30.0, float(cfg.matcher.th_high)),
                        (last.T_cw, mids2, 30.0, float(cfg.matcher.th_high)),
                        (T_pred, mids2, 1e5, float(cfg.matcher.th_low)),
                        (last.T_cw, mids2, 1e5, float(cfg.matcher.th_low))]
            T_cur = None
            best_n = 0
            for T_seed, mids_a, radius, ham in attempts:
                r2 = self._match_stage(frame, T_seed, mids_a,
                                       radius=radius, max_hamming=ham)
                n2 = int(r2.n_inliers) if r2 is not None else 0
                if n2 >= cfg.tracker.min_matches_track and n2 > best_n:
                    best_n = n2
                    T_cur = np.asarray(r2.T_cw)
                    frame_mp = self._slots_to_mids(r2)
            if T_cur is None and ref is not None:
                # last resort before LOST: the whole covisibility region
                # of the reference KF in a wide window from the predicted
                # pose (covers map starvation where last frame's tracked
                # set has shrunk to a sliver but the region still holds
                # points)
                mids3 = self._region_points(self.ref_kid)
                r3w = self._match_stage(frame, T_pred, mids3, radius=60.0,
                                        max_hamming=float(
                                            cfg.matcher.th_high))
                if r3w is not None and (int(r3w.n_inliers)
                                        >= cfg.tracker.min_matches_track):
                    T_cur = np.asarray(r3w.T_cw)
                    frame_mp = self._slots_to_mids(r3w)
            if T_cur is None:
                if r1 is not None and n1 >= cfg.tracker.min_matches_track:
                    T_cur = np.asarray(r1.T_cw)
                    frame_mp = self._slots_to_mids(r1, slot_mids=slot_mids_r1)
                else:
                    return False

        # stage 2: track local map (Tracking.cc:1478-1520); widen the
        # window when tracking is thin (Tracking.cc:1652-1657)
        frame.T_cw = T_cur
        frame.mp_ids = frame_mp
        local_mids = self._local_map_points(frame)
        n_stage1 = int((frame_mp >= 0).sum())
        r2 = 6.0 if n_stage1 >= 50 else 10.0
        r3 = self._match_stage(frame, T_cur, local_mids, radius=r2,
                               max_hamming=float(cfg.matcher.th_low))
        if r3 is not None:
            n3 = int(r3.n_inliers)
            if n3 >= cfg.tracker.min_matches_track:
                frame.T_cw = np.asarray(r3.T_cw)
                frame.mp_ids = self._slots_to_mids(r3)
        n_final = int((frame.mp_ids >= 0).sum())
        self.n_track_inliers = n_final
        if n_final < cfg.tracker.min_matches_track:
            # failed mid-way: drop the partially-assigned pose so the LOST
            # frame never records a garbage trajectory entry
            frame.T_cw = None
            frame.mp_ids = np.full_like(frame.mp_ids, -1)
            return False

        # bookkeeping: found/visible counters.  The reference increments
        # visible for every frustum-visible candidate in SearchLocalPoints
        # and found only for tracked inliers (Tracking.cc:1617-1705): that
        # asymmetry is what makes the found-ratio culling gate bite.
        found_mids = {int(mid) for mid in frame.mp_ids[frame.mp_ids >= 0]}
        vis_mids = set(found_mids)
        if r3 is not None:
            vis = np.asarray(r3.mp_visible)[:len(self._last_slot_mids)]
            vis_mids.update(int(m) for m in
                            self._last_slot_mids[np.nonzero(vis)[0]])
        for mid in vis_mids:
            mp = self.map.points.get(mid)
            if mp is not None:
                mp.n_visible += 1
                if mid in found_mids:
                    mp.n_found += 1

        self.n_stepped_frames += 1
        return self._track_tail(frame)

    def _track_tail(self, frame: HostFrame) -> bool:
        """Post-pose per-frame bookkeeping shared by the fused and
        host-stepped paths: velocity model, reference-KF update, keyframe
        policy, dual bootstrap, FULL-state update (Tracking.cc:324-447)."""
        self.velocity = frame.T_cw @ np.linalg.inv(self.last.T_cw)
        self._update_ref_kid(frame)
        if not self.localization_only and self._need_new_keyframe(frame):
            self._create_keyframe(frame)

        if self.localization_only:
            return True
        # dual bootstrap: periodically attempt cross-camera relocalization
        # until the map is metric (FindPartialRelocalCandidate,
        # Tracking.cc:450-474); on enough successes, create the second map.
        # After scaling, further cross-relocs refine the residual scale
        # (AdjustSecondMapMultical, Tracking.cc:476-511).
        if (self.cfg.n_cameras > 1 and self.kfdb is not None and
                frame.frame_id >= self.next_cross_try):
            with self.timer("xreloc"):
                found = self._try_cross_camera_reloc(frame)
            if found:
                # during the bootstrap, anchor densely: every reloc at a
                # new orientation grows the pair-LS signal |o_i - o_j|
                gap = (self.cfg.tracker.reloc_gap_bootstrap
                       if not self.map.map_scaled
                       else self.cfg.tracker.reloc_gap_try)
                self.next_cross_try = frame.frame_id + gap
                if not self.map.map_scaled:
                    self._anchor_cross_reloc(frame)
                if (not self.map.map_scaled and
                        len(self.cross_reloc_scales) >=
                        self.cfg.tracker.num_frame_in_secondmap):
                    with self.timer("second_map"):
                        self._create_second_map(frame)
                elif self.map.map_scaled:
                    with self.timer("second_map"):
                        self._adjust_second_map(frame)
            else:
                self.next_cross_try = (frame.frame_id +
                                       self.cfg.tracker.reloc_gap_fail)
        self._update_full_state(frame)
        return True

    def _match_stage(self, frame: HostFrame, T_pred: np.ndarray,
                     mids: np.ndarray, radius: float, max_hamming: float,
                     cam_enabled=None):
        """Pack map points `mids` into padded device arrays and run the
        projection-match + pose-opt step.  Returns a TrackResult whose
        leaves are numpy (one readback), or None when too few points."""
        cap = self.cfg.capacity.max_local_mp
        mids = mids[:cap]
        M = len(mids)
        if M < 10:
            return None
        # the reference's padded size (power of FOUR, min 256); the
        # truncation above is semantics, the padding only masked work
        cap = min(cap, max(256, 4 ** int(np.ceil(np.log2(M) / 2))))
        pos = np.zeros((cap, 3), np.float32)
        desc = np.zeros((cap, 8), np.uint32)
        normal = np.zeros((cap, 3), np.float32)
        dmin = np.zeros(cap, np.float32)
        dmax = np.full(cap, 1e9, np.float32)
        valid = np.zeros(cap, bool)
        for i, mid in enumerate(mids):
            mp = self.map.points.get(int(mid))
            if mp is None or mp.is_bad:
                continue
            pos[i] = mp.pos
            desc[i] = mp.desc
            normal[i] = mp.normal
            dmin[i] = mp.min_dist
            dmax[i] = mp.max_dist if mp.max_dist > 0 else 1e9
            valid[i] = True
        if valid.sum() < 10:
            return None
        dev = self.device
        fdev = self._frame_dev(frame)
        res = frontend.match_projection_pose(
            upload(T_pred.astype(np.float32), dev), *fdev,
            upload(pos, dev), upload(desc, dev), upload(valid, dev),
            upload(dmax, dev), upload(dmin, dev), upload(normal, dev),
            self.rig, float(radius), self._level_scales,
            float(max_hamming), 0.5,
            upload(self._cam_enabled() if cam_enabled is None
                   else cam_enabled, dev),
            ba=self.cfg.ba)
        self.n_pose_opt_calls += 1
        self._last_slot_mids = mids
        return frontend.TrackResult(*to_host(res))

    def _frame_dev(self, frame: HostFrame) -> tuple:
        """Device copies of the frame's (uv, desc, level, angle, valid):
        they go up once and serve every stage."""
        if frame.dev is None:
            dev = self.device
            frame.dev = (upload(frame.uv, dev), upload(frame.desc, dev),
                         upload(frame.level, dev), upload(frame.angle, dev),
                         upload(frame.valid, dev))
        return frame.dev

    def _cam_enabled(self) -> np.ndarray:
        """Sibling cameras join tracking only once the map is metric
        (bMapScaled gating, ORBmatcher.cc:128-144)."""
        ncam = self.cfg.n_cameras
        en = np.zeros(ncam, bool)
        en[0] = True
        if self.map.map_scaled or ncam == 1:
            en[:] = True
        return en

    def _slots_to_mids(self, res: frontend.TrackResult,
                       slot_mids: Optional[np.ndarray] = None) -> np.ndarray:
        """Map slot indices back to map-point ids.  `slot_mids` is the mids
        array the result's _match_stage call packed (defaults to the most
        recent call's; pass it explicitly when a later stage ran since)."""
        table = self._last_slot_mids if slot_mids is None else slot_mids
        slots = np.asarray(res.mp_ids)
        out = np.full(slots.shape, -1, np.int64)
        ok = slots >= 0
        out[ok] = table[slots[ok]]
        return out

    def _local_map_points(self, frame: HostFrame) -> np.ndarray:
        """UpdateLocalKeyFrames/Points (Tracking.cc:1707-1860): KFs sharing
        observations with the current frame + their covisible neighbours;
        all their points.  A span `tracker.local_map`."""
        with span("tracker.local_map"):
            counts: Dict[int, int] = {}
            for mid in frame.mp_ids[frame.mp_ids >= 0]:
                mp = self.map.points.get(int(mid))
                if mp is None:
                    continue
                for kid in mp.obs:
                    counts[kid] = counts.get(kid, 0) + 1
            if not counts:
                return np.empty(0, np.int64)
            local_kids = sorted(counts, key=counts.get, reverse=True)
            local_kids = local_kids[:self.cfg.tracker.local_kf_limit]
            extra = []
            for kid in local_kids[:10]:
                kf = self.map.keyframes.get(kid)
                if kf is not None:
                    extra.extend(self.map.covisible_kfs(kf, 10))
            seen = set()
            mids: List[int] = []
            for kid in local_kids + extra:
                kf = self.map.keyframes.get(kid)
                if kf is None or kid in seen:
                    continue
                seen.add(kid)
                for mid in kf.mp_idx[kf.mp_idx >= 0]:
                    mids.append(int(mid))
            return np.unique(np.asarray(mids, np.int64))

    def _update_ref_kid(self, frame: HostFrame) -> None:
        counts: Dict[int, int] = {}
        for mid in frame.mp_ids[frame.mp_ids >= 0]:
            mp = self.map.points.get(int(mid))
            if mp is None:
                continue
            for kid in mp.obs:
                counts[kid] = counts.get(kid, 0) + 1
        if counts:
            self.ref_kid = max(counts, key=counts.get)

    # ------------------------------------------------------------------
    # keyframe policy (Tracking.cc:1523-1615)
    # ------------------------------------------------------------------
    def _need_new_keyframe(self, frame: HostFrame) -> bool:
        cfg = self.cfg
        # hard keyframe capacity (CapacityConfig.max_keyframes): at the
        # cap, EVICT the keyframe least covisible with the current view so
        # the local map around the camera survives; redundancy culling
        # (LocalMapping KeyFrameCulling) frees slots first when it can.
        # Never silent: each eviction logs an event.
        if self.map.n_keyframes >= cfg.capacity.max_keyframes:
            if not self._evict_for_capacity(frame):
                if not self.events or not self.events[-1].startswith("KFCAP"):
                    self.events.append(
                        f"KFCAP@{frame.frame_id} n={self.map.n_keyframes}")
                return False
        ref = self.map.keyframes.get(self.ref_kid)
        if ref is None:
            return False
        since_busy = frame.frame_id - self.last_kf_frame_id
        if (self.mapper_busy is not None and self.mapper_busy()
                and since_busy < cfg.tracker.max_frames_between_kf):
            return False
        # reference tracked-point count (KeyFrame::TrackedMapPoints with
        # minObs 3, or 2 while the map has <=2 KFs, Tracking.cc:1541-1545)
        min_obs = 3 if self.map.n_keyframes > 2 else 2
        n_ref = 0
        for mid in ref.mp_idx[ref.mp_idx >= 0]:
            mp = self.map.points.get(int(mid))
            if mp is not None and mp.n_obs >= min_obs:
                n_ref += 1
        since = frame.frame_id - self.last_kf_frame_id
        c1 = since >= cfg.tracker.max_frames_between_kf
        # reference mono uses mMinFrames=0 (KF every frame when the mapper
        # is idle, Tracking.cc:1560)
        c1b = since >= max(cfg.tracker.min_frames_between_kf, 1)
        c2 = (self.n_track_inliers < cfg.tracker.kf_ref_ratio * max(n_ref, 1)
              and self.n_track_inliers > cfg.tracker.min_matches_track)
        return bool((c1 or c1b) and c2)

    def _evict_for_capacity(self, frame: HostFrame) -> bool:
        """Erase the keyframe least relevant to the current view so a new
        one can be inserted at capacity.  Victim = lowest covisibility
        weight with the reference KF (0 if disconnected), oldest first on
        ties; gauge/bootstrap-critical and recent KFs are protected."""
        m = self.map
        ref = m.keyframes.get(self.ref_kid)
        ref_w = dict(ref.covis) if ref is not None else {}
        recent = set(sorted(m.keyframes.keys())[-5:])
        best, best_key = None, None
        for kid, kf in m.keyframes.items():
            if (kid == m.origin_kid or kid == m.first_scale_kid or
                    kid == self.ref_kid or kid in recent or
                    kf.not_erase or kf.connected_to_second_map):
                continue
            key = (ref_w.get(kid, 0), kid)
            if best_key is None or key < best_key:
                best, best_key = kf, key
        if best is None:
            return False
        m.erase_keyframe(best)
        self.events.append(
            f"KFEVICT@{frame.frame_id} kid={best.kid} "
            f"w={best_key[0]} n={m.n_keyframes}")
        return True

    def _make_keyframe(self, frame: HostFrame, T_cw: np.ndarray) -> KeyFrame:
        """Flatten per-camera features into the global concatenated layout
        (Frame.cc:179-196) and register the KF."""
        ncam, N = frame.valid.shape
        kf = KeyFrame(
            kid=self.map.new_kid(), frame_id=frame.frame_id,
            T_cw=np.asarray(T_cw, np.float64).copy(),
            uv=frame.uv.reshape(ncam * N, 2).astype(np.float64),
            kp_cam=np.repeat(np.arange(ncam), N),
            level=frame.level.reshape(-1).astype(np.int32),
            angle=frame.angle.reshape(-1),
            desc=frame.desc.reshape(ncam * N, 8),
            kp_valid=frame.valid.reshape(-1),
            mp_idx=np.full(ncam * N, -1, np.int64),
            word=frame.words.reshape(-1), node=frame.nodes.reshape(-1))
        self.map.add_keyframe(kf)
        return kf

    def _create_keyframe(self, frame: HostFrame) -> KeyFrame:
        """A keyframe of `frame`, handed to the mapper (synchronous: its
        work inside this call); a span `tracker.keyframe`."""
        with span("tracker.keyframe"):
            kf = self._make_keyframe(frame, frame.T_cw)
            ncam, N = frame.valid.shape
            for c in range(ncam):
                for row in np.nonzero(frame.mp_ids[c] >= 0)[0]:
                    mid = int(frame.mp_ids[c][row])
                    mp = self.map.points.get(mid)
                    if mp is None or mp.is_bad:
                        continue
                    g = c * N + int(row)
                    # the obs-membership guard matters when one point matched
                    # rows in TWO cameras of this frame: a second
                    # add_observation would overwrite mp.obs[kid] and leave
                    # the first row's mp_idx dangling forever
                    if kf.mp_idx[g] < 0 and kf.kid not in mp.obs:
                        self.map.add_observation(mp, kf, g, c)
            self.map.update_connections(kf)
            self.ref_kid = kf.kid
            self.last_kf_frame_id = frame.frame_id
            self.events.append(f"KF@{frame.frame_id} kid={kf.kid}")
            if self.kfdb is not None:
                self._kfdb_add(kf)
            if self.local_mapper is not None:
                self.local_mapper.on_new_keyframe(kf)
            return kf

    def _anchor_cross_reloc(self, frame: HostFrame) -> None:
        """Promote a PRE-scale cross-reloc frame to a keyframe and remember
        its matched (row, map-point) pairs.  At second-map creation the
        pairs are attached as secondary-camera observations - giving scale-
        bearing anchors at every orientation the bootstrap visited.  With a
        single anchor orientation, scale is first-order unobservable (a
        rig-position shift absorbs the extrinsic offset error); the turn
        phase's orientation diversity is what makes the pair-differenced
        scale solve well-posed (optim/scale_opt.bootstrap_scale).
        The reference keeps only the final reloc (Tracking.cc:512-775) and
        relies on NUM_SECONDMAP later keyframes instead."""
        xr = self._last_xreloc
        if xr is None:
            return
        reloc_kid, pairs, T_1w, s_est = xr
        kf = None
        if self.last_kf_frame_id == frame.frame_id:
            cand = self.map.keyframes.get(self.ref_kid)
            if cand is not None and cand.frame_id == frame.frame_id:
                kf = cand
        if kf is None:
            kf = self._create_keyframe(frame)
        # protect the anchor from KeyFrameCulling while its scale evidence
        # is pending (the reference's mbNotErase, KeyFrame.h:144-147) —
        # culled anchors silently shrink the bootstrap's sample
        kf.not_erase = True
        self.pending_cross.append((kf.kid, pairs, T_1w.copy(), s_est))
        self.events.append(
            f"XANCHOR@{frame.frame_id} kid={kf.kid} n={len(pairs)}")

    def _clear_pending_cross(self) -> None:
        """Drop pending anchors and lift their culling protection."""
        for kid_a, _pairs, _T1w, _s in self.pending_cross:
            kfa = self.map.keyframes.get(kid_a)
            if kfa is not None:
                kfa.not_erase = False
        self.pending_cross.clear()

    def _kfdb_add(self, kf: KeyFrame) -> None:
        if self.voc is None or self.kfdb is None:
            return
        ncam = self.cfg.n_cameras
        N = len(kf.word) // ncam
        for c in range(ncam):
            words = kf.word[c * N:(c + 1) * N]
            vvalid = kf.kp_valid[c * N:(c + 1) * N]
            vec = bow.sparse_bow(self.voc, words, vvalid)
            self.kfdb.add(kf.kid, c, words[vvalid & (words >= 0)], vec)

    # ------------------------------------------------------------------
    # dual-camera bootstrap (Tracking.cc:450-775, 786-1033)
    # ------------------------------------------------------------------
    def _try_cross_camera_reloc(self, frame: HostFrame) -> bool:
        """RelocalizationPartialOnCam (Tracking.cc:786-1033): the SECONDARY
        camera recognizes a place mapped by the PRIMARY camera.  On success
        the known physical extrinsic baseline vs the map-units distance
        between the two camera centers yields a metric scale estimate
        (Tracking.cc:1014-1029)."""
        query_cam = 1
        words = frame.words[query_cam]
        vvalid = frame.valid[query_cam] & (words >= 0)
        if vvalid.sum() < 30:
            return False
        vec = bow.sparse_bow(self.voc, words, vvalid)
        cands = self.kfdb.detect_reloc_candidates(
            np.where(vvalid, words, -1), vec, query_cam, 0, self.map)
        self.events.append(f"XTRY@{frame.frame_id} cands={cands[:4]}")
        ncam = self.cfg.n_cameras
        N = frame.n
        for kid in cands[:5]:
            kf = self.map.keyframes.get(kid)
            if kf is None:
                continue
            idx = self._match_frame_kf(frame, kf, query_cam, 0,
                                       by_nodes=True)
            rows_f = np.nonzero(idx >= 0)[0]
            if len(rows_f) < 15:
                # windowless fallback: with a coarse vocabulary the node
                # mask drops true pairs; retry descriptor-only (mutual +
                # ratio + rotation histogram carry the rejection)
                idx2 = self._match_frame_kf(frame, kf, query_cam, 0,
                                            by_nodes=False)
                rows2 = np.nonzero(idx2 >= 0)[0]
                if len(rows2) > len(rows_f):
                    idx, rows_f = idx2, rows2
            if len(rows_f) < 8:
                self.events.append(
                    f"XBOW@{frame.frame_id} kf={kid} n={len(rows_f)}")
                continue
            X, uv, pairs = [], [], []
            for rf in rows_f:
                mid = int(kf.mp_idx[idx[rf]])
                mp = self.map.points.get(mid)
                if mp is None or mp.is_bad:
                    continue
                X.append(mp.pos)
                uv.append(frame.uv[query_cam][rf])
                pairs.append((int(rf), mid))
            if len(X) < 8:
                continue
            # adaptive accept: thin seeds (wide-yaw rigs where cross-view
            # ORB matching is sparse - BRIEF degrades steeply with
            # viewpoint change) pass on a moderate inlier FRACTION rather
            # than the reference's absolute >=20 bar (Tracking.cc:865),
            # because the projection refine + rotation-consistency gates
            # below re-verify the pose against the whole reloc'd region
            # before anything is accepted.  Measured on the 69-deg
            # real-texture rig: genuine cross-view seeds run ~45 %
            # inliers (17/38), which the old 0.6 fraction rejected.
            min_inl = min(18, max(8, int(round(0.45 * len(X)))))
            T_1w, cnt, ok = self._pnp(X, uv, query_cam, n_hyp=512,
                                      min_inliers=min_inl)
            if not ok or cnt < min_inl:
                self.events.append(
                    f"XPNP@{frame.frame_id} kf={kid} n={len(X)} "
                    f"inl={int(cnt)}")
                continue
            # refine: project the reloc region's local map into the query
            # camera from the PnP pose and re-optimize, widening rounds as
            # the reference's RelocalizationPartialOnCam does
            # (PoseOptimization + SearchByProjectionOnCam, Tracking.cc:
            # 850-1010).  The raw 4-point RANSAC pose has a camera-center
            # error of several baselines - useless for scale.
            region_mids = self._region_map_points(kf)
            cam_en = np.zeros(ncam, bool)
            cam_en[query_cam] = True
            T_rig_impl = self._T_cs_np[query_cam] @ T_1w
            rbest = None
            T_cur = T_rig_impl
            for radius in (10.0, 4.0):
                r = self._match_stage(frame, T_cur, region_mids,
                                      radius=radius,
                                      max_hamming=float(
                                          self.cfg.matcher.th_low),
                                      cam_enabled=cam_en)
                if r is None:
                    break
                T_cur = np.asarray(r.T_cw, np.float64)
                rbest = r
            # absolute projection-confirmation floor: a thin PnP seed must
            # grow to >=25 strict-threshold projection inliers against the
            # region's local map or the pose is rejected outright
            if rbest is None or int(rbest.n_inliers) < max(25, int(cnt)):
                self.events.append(
                    f"XREF@{frame.frame_id} kf={kid} refine failed "
                    f"({0 if rbest is None else int(rbest.n_inliers)})")
                continue
            n_good = int(rbest.n_inliers)
            T_1w = self._T_sc_np[query_cam] @ T_cur
            # rotation consistency: the reloc'd camera-1 orientation must
            # agree with the tracked rig pose composed through the
            # extrinsic - scale cannot corrupt rotation, so a mismatch
            # means a bad pose (prunes the scale-estimate outliers)
            R_exp = (self._T_sc_np[query_cam][:3, :3] @
                     frame.T_cw[:3, :3])
            cos_r = (np.trace(T_1w[:3, :3] @ R_exp.T) - 1.0) / 2.0
            if cos_r < np.cos(np.deg2rad(10.0)):
                self.events.append(
                    f"XROT@{frame.frame_id} kf={kid} cos={cos_r:.3f}")
                continue
            # scale = |t_extrinsic| / |C1_map - C0_map| (Tracking.cc:
            # 1014-1029), from the REFINED camera center
            c1_map = -T_1w[:3, :3].T @ T_1w[:3, 3]
            c0_map = -frame.T_cw[:3, :3].T @ frame.T_cw[:3, 3]
            d_map = float(np.linalg.norm(c1_map - c0_map))
            baseline = float(np.linalg.norm(
                self._T_sc_np[query_cam][:3, 3]))
            if d_map < 1e-9 or baseline < 1e-9:
                continue
            scale = baseline / d_map
            # matched pairs from the refined projection stage (query-camera
            # rows), for cross-observation attachment
            mids_final = self._slots_to_mids(rbest)[query_cam]
            inlier_pairs = [(int(rf), int(mid)) for rf, mid in
                            enumerate(mids_final) if mid >= 0]
            self.cross_reloc_scales.append(scale)
            self.last_reloc_cam_pose = T_1w
            self._last_xreloc = (kid, inlier_pairs, T_1w, scale)
            self.events.append(
                f"XRELOC@{frame.frame_id} kf={kid} n={n_good} "
                f"s={scale:.4f}")
            return True
        return False

    def _region_map_points(self, kf: KeyFrame) -> np.ndarray:
        """Local map of keyframe `kf`'s region: its points plus those of its
        best covisible neighbours."""
        mids = {int(x) for x in kf.mp_idx[kf.mp_idx >= 0]}
        for nkid in self.map.covisible_kfs(kf, 10):
            nkf = self.map.keyframes.get(nkid)
            if nkf is not None:
                mids.update(int(x) for x in nkf.mp_idx[nkf.mp_idx >= 0])
        return np.asarray(sorted(mids), np.int64)

    def _apply_scale(self, s: float, frame: HostFrame) -> None:
        """Multiply the whole state (map + tracking) by scale s."""
        self.map.set_scale(s)
        frame.T_cw = frame.T_cw.copy()
        frame.T_cw[:3, 3] *= s
        if self.last is not None and self.last.T_cw is not None:
            self.last.T_cw = self.last.T_cw.copy()
            self.last.T_cw[:3, 3] *= s
        if self.velocity is not None:
            self.velocity = self.velocity.copy()
            self.velocity[:3, 3] *= s
        # keep the pending cross-reloc poses/scales in the new units so the
        # frontier warp and anchor attaches stay consistent post-rescale
        xr = self._last_xreloc
        if xr is not None:
            kid, pairs, T_1w, s_est = xr
            T_1w = T_1w.copy()
            T_1w[:3, 3] *= s
            self._last_xreloc = (kid, pairs, T_1w, s_est / s)
        rescaled = []
        for kid, pairs, T_1w, s_est in self.pending_cross:
            T_1w = T_1w.copy()
            T_1w[:3, 3] *= s
            rescaled.append((kid, pairs, T_1w, s_est / s))
        self.pending_cross = rescaled
        with self.timer("point_stats"):
            for mp in self.map.points.values():
                update_point_stats(mp, self.map, self._T_sc_np,
                                   self.scale_factors)

    def _attach_cross_observations(self, frame: HostFrame,
                                   kf: KeyFrame) -> int:
        """Attach the latest cross-reloc's matched map points as SECONDARY-
        camera observations of keyframe `kf`.  These dual observations are
        what lets BA's extrinsic-adjoint factor enforce the metric baseline
        - the actual scale-anchoring mechanism of the reference
        (AdjustSecondMapMultical, Tracking.cc:483-499, assigns the reloc'd
        frame's map points into the current frame's cam-1 keypoint slots)."""
        if not self._last_xreloc:
            return 0
        reloc_kid, pairs, _, _ = self._last_xreloc
        N = frame.n
        n_attached = 0
        for rf, mid in pairs:
            mp = self.map.points.get(mid)
            if mp is None or mp.is_bad:
                continue
            g = 1 * N + rf
            if kf.mp_idx[g] < 0 and kf.kid not in mp.obs:
                self.map.add_observation(mp, kf, g, 1)
                n_attached += 1
        kf.connected_to_second_map = True
        rkf = self.map.keyframes.get(reloc_kid)
        if rkf is not None:
            rkf.connected_to_second_map = True
        self._last_xreloc = None
        return n_attached

    def _adjust_second_map(self, frame: HostFrame,
                           allow_warp: bool = True) -> None:
        """Post-scaling cross-reloc handling (AdjustSecondMapMultical,
        Tracking.cc:476-511): promote the frame to a keyframe carrying the
        cross-camera observations and let local BA settle the metric scale
        through the extrinsic baseline."""
        xreloc = self._last_xreloc
        # reuse a keyframe already created for THIS frame (e.g. by
        # _anchor_cross_reloc moments before second-map creation, or by
        # the regular KF policy) - a second _make_keyframe would insert a
        # coincident duplicate whose identical residuals double-count in
        # BA and inflate covisibility
        kf = None
        if self.last_kf_frame_id == frame.frame_id:
            cand = self.map.keyframes.get(self.ref_kid)
            if cand is not None and cand.frame_id == frame.frame_id:
                kf = cand
        if kf is None:
            kf = self._make_keyframe(frame, frame.T_cw)
        ncam, N = frame.valid.shape
        for c in range(ncam):
            for row in np.nonzero(frame.mp_ids[c] >= 0)[0]:
                mid = int(frame.mp_ids[c][row])
                mp = self.map.points.get(mid)
                if mp is None or mp.is_bad:
                    continue
                g = c * N + int(row)
                if kf.mp_idx[g] < 0 and kf.kid not in mp.obs:
                    self.map.add_observation(mp, kf, g, c)
        self.map.update_connections(kf)

        # Frontier drift correction BEFORE attaching observations.  The
        # cross-reloc pins the rig's pose relative to the (metric) old
        # region; the tracked pose has drifted away from it by accumulated
        # mono error.  If cross observations were attached at the DRIFTED
        # pose, bundle adjustment and the 1-DoF scale solve would absorb
        # that pose gap into the map scale - measured: the map deforms
        # into a self-consistent equilibrium at the wrong metric scale.
        # So first treat the reloc as a Sim3 loop closure: snap this
        # keyframe to the reloc-implied pose with the relative scale folded
        # into Scw, carry its covisible window, and let the essential graph
        # redistribute (the dual-camera analog of CorrectLoop, sharing its
        # machinery); only then attach.
        if xreloc is not None and allow_warp:
            reloc_kid, _, T_1w, s_est = xreloc
            reloc_kf = self.map.keyframes.get(reloc_kid)
            T_impl = self._T_cs_np[1] @ T_1w
            c_impl = -T_impl[:3, :3].T @ T_impl[:3, 3]
            c_trk = -kf.T_cw[:3, :3].T @ kf.T_cw[:3, 3]
            gap = float(np.linalg.norm(c_impl - c_trk))
            baseline = float(np.linalg.norm(self._T_sc_np[1][:3, 3]))
            self.events.append(
                f"XGAP@{frame.frame_id} s={s_est:.4f} gap={gap:.4f}")
            if (reloc_kf is not None and 0.3 < s_est < 3.0 and
                    (abs(s_est - 1.0) > 0.05 or gap > 0.1 * baseline)):
                s0 = 1.0 / s_est if abs(s_est - 1.0) > 0.05 else 1.0
                Scw = np.eye(4)
                Scw[:3, :3] = s0 * T_impl[:3, :3]
                Scw[:3, 3] = s0 * T_impl[:3, 3]
                with self.timer("window_warp"):
                    apply_sim3_correction(self.map, self.rig, kf, reloc_kf,
                                          Scw, [], fix_scale=False,
                                          pose_graph_iters=20,
                                          scale_factors=self.scale_factors)
                frame.T_cw = kf.T_cw.copy()
                self.velocity = None
                self.events.append(
                    f"XWARP@{frame.frame_id} s={s_est:.4f} gap={gap:.4f}")

        n_att = self._attach_cross_observations(frame, kf)
        self.map.update_connections(kf)
        self.map.first_scale_kid = kf.kid
        self.ref_kid = kf.kid
        self.last_kf_frame_id = frame.frame_id
        self.events.append(f"XKF@{frame.frame_id} kid={kf.kid} att={n_att}")

        # Re-solve the 1-DoF global scale NOW, while the freshly attached
        # cross edges are still strained by the map's true scale error.
        # Running it after local BA is too late: bundle adjustment slides
        # the (depth-slack) points along their camera-0 rays until both
        # cameras are satisfied at the CURRENT scale - measured on the
        # bootstrap scenario, that equilibrium freezes a residual 2x error
        # that no later estimator can see (all of them read the dragged
        # points as "metric").  Fresh first-observation edges are the only
        # unpoisoned scale signal; harvest them first.
        self._refine_scale(frame, "attach")

        if self.kfdb is not None:
            self._kfdb_add(kf)
        if self.local_mapper is not None:
            self.local_mapper.on_new_keyframe(kf)
        # ... and once more after the mapper's own cross-camera harvest
        # added further edges (no-op when BA already settled them)
        self._refine_scale(frame, "xkf")

    def _refine_scale(self, frame: HostFrame, where: str) -> None:
        """1-DoF global-scale refinement over the map's cross-camera edges
        (optim/scale_opt.optimal_map_scale).  Mono cost is scale-invariant,
        so this moves exactly the similarity mode LM cannot efficiently
        reach.  Only informative while the cross edges are still strained
        (right after attach); once BA has settled the map the curve's
        minimum sits at 1.0 and this is a no-op.

        Iterated because the robust (Huber) cost saturates far-out edges:
        after applying a first alpha the re-linearized curve can reveal
        more headroom (bootstrap-size errors are 2-6x)."""
        with self.timer("refine_scale"):
            for _ in range(4):
                res = scale_opt.optimal_map_scale(
                    self.map, self.rig, self.scale_factors ** 2,
                    alpha_lo=0.15, alpha_hi=8.0, n_grid=129)
                if res is None:
                    return
                alpha, n_e = res
                if abs(alpha - 1.0) < 0.005:
                    return
                self._apply_scale(alpha, frame)
                self.events.append(
                    f"ALPHA@{frame.frame_id} a={alpha:.4f} n={n_e} {where}")

    def _create_second_map(self, frame: HostFrame) -> None:
        """CreateSecondMapMultical (Tracking.cc:512-775): estimate the
        metric scale from the bootstrap cross-reloc anchors, rescale EVERY
        keyframe and map point to metric units, pin the scale gauge, and
        run a global BA in which the sibling camera's extrinsic-baseline
        observations now constrain the absolute scale.

        Scale estimation departs from the reference's mean of per-reloc
        |t_sc|/|dC| ratios (Tracking.cc:512-560): that ratio-of-norms is
        systematically biased small when the camera-center noise rivals
        the ~10cm baseline.  We fit the unbiased vector pair-LS over all
        anchors instead (scale_opt.bootstrap_scale) and only commit once
        its confidence gate passes - collecting more anchors otherwise."""
        m = self.map
        anchors = []
        for kid_a, pairs, T1w, s_est in self.pending_cross:
            kfa = m.keyframes.get(kid_a)
            if kfa is None:
                continue
            anchors.append(dict(T1w=T1w, T_track=kfa.T_cw,
                                frame_id=kfa.frame_id))
        ests = np.asarray(self.cross_reloc_scales, np.float64)
        med = float(np.median(ests)) if len(ests) else 0.0
        res = scale_opt.bootstrap_scale(anchors, self._T_sc_np[1])
        if res is not None:
            alpha, rel, n_pairs = res
            self.events.append(
                f"XLS@{frame.frame_id} a={alpha:.4f} rel={rel:.3f} "
                f"n={len(anchors)} med={med:.4f}")
        # Commit policy.  Confident LS (rel sigma under the gate) commits
        # immediately; otherwise wait for a few more anchors but never past
        # `scale_max_anchors` - the bootstrap trajectory's reloc window is
        # finite, and a decent early scale PLUS the post-scale machinery
        # (XWARP pose snapping, SearchCrossCameras harvest, the 1-DoF
        # cross-edge ALPHA refine, cross-edge-protected BA) beats waiting
        # for a certainty the geometry may never provide.  The reference
        # itself commits the plain mean ratio after NUM_FRAME_IN_SECONDMAP
        # relocs (Tracking.cc:548-560).
        confident = res is not None and res[1] <= \
            self.cfg.tracker.scale_rel_sigma
        if not confident and len(anchors) < \
                self.cfg.tracker.scale_max_anchors:
            return          # keep collecting anchors
        # sanity: the unbiased estimate should not be wildly outside the
        # (biased-small) ratio estimates' range; fall back to the
        # reference's averaged ratio otherwise (Tracking.cc:548-560)
        s, n_used = med, len(ests)
        if res is not None and 0.2 < res[0] < 25.0 and res[0] > 0.3 * med:
            s, n_used = res[0], len(anchors)
        if not (0.05 < s < 100.0):
            self.cross_reloc_scales.clear()
            self._clear_pending_cross()
            return
        self._apply_scale(s, frame)
        m.map_scaled = True
        for kf in m.keyframes.values():
            kf.scaled = True
        self.cross_reloc_scales.clear()
        self.events.append(f"SCALED@{frame.frame_id} s={s:.4f} n={n_used}")
        # attach every bootstrap anchor's matches as secondary-camera
        # observations of its keyframe - the orientation-diverse scale
        # anchors collected by _anchor_cross_reloc
        N = frame.n
        for kid_a, pairs, _T1w, _sa in self.pending_cross:
            kfa = m.keyframes.get(kid_a)
            if kfa is None:
                continue
            n_att_a = 0
            for rf, mid in pairs:
                mp = m.points.get(mid)
                if mp is None or mp.is_bad:
                    continue
                g = 1 * N + rf
                if kfa.mp_idx[g] < 0 and kid_a not in mp.obs:
                    m.add_observation(mp, kfa, g, 1)
                    n_att_a += 1
            kfa.connected_to_second_map = True
            m.update_connections(kfa)
            self.events.append(
                f"XATTACH@{frame.frame_id} kid={kid_a} n={n_att_a}")
        self._clear_pending_cross()
        # the anchors' fresh cross edges carry the full remaining scale
        # error - solve it NOW, before any BA can drag the points into a
        # wrong-scale equilibrium (see _adjust_second_map)
        self._refine_scale(frame, "boot")
        # promote the current frame to the first second-map keyframe with
        # the cross-camera observations attached (they are what anchors
        # metric scale in BA); _apply_scale re-expressed the stored reloc
        # pose in the new units, so the frontier warp can run here too —
        # the FIRST attach is precisely where a pose gap would otherwise
        # get baked into the map scale
        self._adjust_second_map(frame, allow_warp=True)
        # ... then a metric global BA re-settles everything around the new
        # gauge (CreateSecondMapMultical's GBA, Tracking.cc:733)
        self._metric_gba(iters=10, cg_iters=24)

    def _update_full_state(self, frame: HostFrame) -> None:
        """FULL iff the map is scaled and enough keyframes carry secondary-
        camera observations (Tracking.cc:324-333, NUM_SECONDMAP)."""
        if self.state == self.FULL or not self.map.map_scaled:
            if self.state == self.FULL and not self.localization_only:
                self._maybe_metric_refresh(frame)
            return
        n_second = sum(1 for kf in self.map.keyframes.values()
                       if kf.connected_to_second_map)
        # KFs with any secondary-camera observation also count (fuse and
        # triangulation attach them once the map is scaled)
        for kf in self.map.keyframes.values():
            if kf.connected_to_second_map:
                continue
            for mid in kf.mp_idx[kf.mp_idx >= 0]:
                mp = self.map.points.get(int(mid))
                if mp is not None and mp.obs_cam.get(kf.kid, 0) != 0:
                    n_second += 1
                    break
        if n_second >= self.cfg.tracker.num_secondmap:
            self.state = self.FULL
            self.events.append(f"FULL@{frame.frame_id}")
            # metric-refinement GBA: the global scale mode is a
            # low-curvature direction that local windows correct slowly;
            # with the dual observations accumulated, a longer global pass
            # settles it (the reference's post-second-map GBA thread)
            self._metric_gba(iters=25)
            self._xedges_at_gba = self._count_cross_edges()

    def _count_cross_edges(self) -> int:
        """Observations whose camera differs from the point's first view —
        the only residuals that sense the metric baseline (same edge set
        scale_opt.optimal_map_scale solves over)."""
        return sum(1 for mp in self.map.points.values()
                   for kid, c in mp.obs_cam.items()
                   if c != mp.first_view_cam)

    def _maybe_metric_refresh(self, frame: HostFrame) -> None:
        """Periodic metric GBA after FULL, re-fired when the map's
        cross-camera edge count has grown 1.5x since the last one.

        Why: the FULL-transition GBA runs while the dual map is young —
        most cross edges arrive LATER through SearchCrossCameras harvests,
        dual triangulation and fuse.  The global scale is a low-curvature
        mode local BA windows barely move, so without a later global pass
        the bootstrap's residual scale error freezes in.  Measured on the
        0.5 m-baseline fixture (see RESULTS.md): the finished map sits at
        1.24x scale error while one extra GBA(30) over the full edge set
        pulls it to 1.10 (the BA optimum, cost 2819 -> 2811).  The 1.5x
        growth trigger gives O(log E) refreshes over a run.

        The reference has no equivalent (its one GBA runs in
        CreateSecondMapMultical, Tracking.cc:733) - this is a fix for a
        measured weakness, not a port."""
        if self.last_kf_frame_id != frame.frame_id:
            return                      # only re-check when a KF landed
        n_x = self._count_cross_edges()
        if n_x < 100 or n_x < 1.5 * self._xedges_at_gba:
            return
        self._metric_gba(iters=20)
        self._xedges_at_gba = self._count_cross_edges()
        self.events.append(f"MGBA@{frame.frame_id} xedges={n_x}")

    def _metric_gba(self, iters: int, cg_iters: int = 48) -> None:
        """Global BA over every keyframe with the gauge pinned at the scale
        anchor, sharded over the tracker's mesh when it is large enough."""
        m = self.map
        kids = sorted(m.keyframes.keys())
        fixed = {m.first_scale_kid} if m.first_scale_kid in m.keyframes \
            else {m.origin_kid}
        with self.timer("metric_gba"):
            prob, all_kids, mids, meta = ba_pack.pack_problem(
                m, kids, fixed_kids=fixed,
                level_sigma2=self.scale_factors ** 2,
                ncam=self.cfg.n_cameras, device=self.device)
            res = runtime.solve_ba_auto(prob, self.rig.T_sc, self.rig.adj_sc,
                                        self.rig.K, iters=iters,
                                        cg_iters=cg_iters, mesh=self.mesh)
            ba_pack.unpack_result(m, res, all_kids, mids, meta,
                                  chi2_th=self.cfg.ba.chi2_mono)
        # every pose/point just moved: stale concurrent local-BA snapshots
        # must not write back (see Map.geometry_epoch)
        m.geometry_epoch += 1

    # ------------------------------------------------------------------
    # relocalization (Tracking.cc:1035-1261)
    # ------------------------------------------------------------------
    def _relocalize(self, frame: HostFrame) -> bool:
        if self.kfdb is None or self.voc is None:
            # fallback: brute-force vs reference KF map points from the last
            # known pose (keeps the no-vocab configuration recoverable)
            if self.last is None or self.last.T_cw is None:
                return False
            mids = self._region_points(self.ref_kid)
            res = self._match_stage(frame, self.last.T_cw, mids, radius=50.0,
                                    max_hamming=float(self.cfg.matcher.th_high))
            if res is None or int(res.n_inliers) < 30:
                return False
            frame.T_cw = np.asarray(res.T_cw)
            frame.mp_ids = self._slots_to_mids(res)
            self.velocity = None
            return True

        words = frame.words[0]
        vvalid = frame.valid[0] & (words >= 0)
        vec = bow.sparse_bow(self.voc, words, vvalid)
        cands = self.kfdb.detect_reloc_candidates(
            np.where(vvalid, words, -1), vec, 0, 0, self.map)
        for kid in cands[:5]:
            kf = self.map.keyframes.get(kid)
            if kf is None:
                continue
            ok = self._reloc_against_kf(frame, kf, query_cam=0, resp_cam=0)
            if ok:
                self.velocity = None
                return True
        return False

    def _match_frame_kf(self, frame: HostFrame, kf: KeyFrame,
                        query_cam: int, g0: int, by_nodes: bool):
        """Frame camera `query_cam` against keyframe rows g0..g0+N that
        carry a map point: by vocabulary node, or descriptor-only with the
        mutual check.  Returns the host idx [N] (kf row relative to g0)."""
        N = frame.n
        dev = self.device
        _, desc_f, _, angle_f, valid_f = self._frame_dev(frame)
        sl = slice(g0, g0 + N)
        desc_k = upload(kf.desc[sl].astype(np.uint32), dev)
        angle_k = upload(kf.angle[sl], dev)
        valid_k = upload(kf.kp_valid[sl] & (kf.mp_idx[sl] >= 0), dev)
        th = float(self.cfg.matcher.th_low)
        ratio = float(self.cfg.matcher.nn_ratio_bow)
        if by_nodes:
            res = frontend.match_bow_frame_kf(
                desc_f[query_cam], upload(frame.nodes[query_cam], dev),
                angle_f[query_cam], valid_f[query_cam], desc_k,
                upload(kf.node[sl], dev), angle_k, valid_k, th, ratio)
        else:
            res = frontend.match_desc_frame_kf(
                desc_f[query_cam], angle_f[query_cam], valid_f[query_cam],
                desc_k, angle_k, valid_k, th, ratio)
        return to_host((res.idx,))[0]

    def _pnp(self, X: list, uv: list, query_cam: int, n_hyp: int = 256,
             min_inliers: int = 12):
        """pnp_ransac on the device over matched (world point, pixel)
        pairs; the minimal sets come from `pnp_sampler`.  Returns host
        (T [4,4] float64, n_inliers, ok)."""
        dev = self.device
        valid = torch.ones(len(X), dtype=torch.bool, device=dev)
        idx6, idx4 = self.pnp_sampler(n_hyp, valid)
        T, _inl, cnt, ok = ransac.pnp_solve(
            idx6.to(dev), idx4.to(dev),
            upload(np.asarray(X, np.float32), dev),
            upload(np.asarray(uv, np.float32), dev), valid,
            self.rig.K[query_cam], min_inliers=min_inliers)
        T, cnt, ok = to_host((T, cnt, ok))
        return T.astype(np.float64), int(cnt), bool(ok)

    def _reloc_against_kf(self, frame: HostFrame, kf: KeyFrame,
                          query_cam: int, resp_cam: int) -> bool:
        """BoW match + PnP RANSAC + pose-opt against one candidate KF.
        Cross-camera when query_cam != resp_cam
        (RelocalizationPartialOnCam, Tracking.cc:786-1033)."""
        N = frame.n
        g0 = resp_cam * N
        idx = self._match_frame_kf(frame, kf, query_cam, g0, by_nodes=True)
        rows_f = np.nonzero(idx >= 0)[0]
        if len(rows_f) < 15:
            return False
        X = []
        uv = []
        for rf in rows_f:
            mid = int(kf.mp_idx[g0 + idx[rf]])
            mp = self.map.points.get(mid)
            if mp is None or mp.is_bad:
                continue
            X.append(mp.pos)
            uv.append(frame.uv[query_cam][rf])
        if len(X) < 15:
            return False
        T_s, _cnt, ok = self._pnp(X, uv, query_cam)
        if not ok:
            return False
        # T_s maps world -> query camera frame; rig pose T_cw = T_cs @ T_s
        T_cw = self._T_cs_np[query_cam] @ T_s
        # polish with widening projection-match rounds on the full local
        # map: the reference retries SearchByProjection at widened then
        # narrowed windows before giving up (Tracking.cc:1180-1250); a
        # raw PnP pose is often just outside the first window.  Widening
        # is SAME-CAMERA only: the reference's cross-camera reloc
        # (RelocalizationPartialOnCam, Tracking.cc:786-1033) does not
        # widen, and before the metric-scale commit the map is still at
        # mono scale, so a wide window there harvests scale-biased
        # associations that corrupt the |t_sc|/|dC| estimates
        frame.T_cw = T_cw.astype(np.float64)
        mids = self._region_points(kf.kid)
        radii = (30.0, 15.0, 6.0) if query_cam == resp_cam else (15.0,)
        best = None
        for radius in radii:
            r = self._match_stage(frame, frame.T_cw, mids, radius=radius,
                                  max_hamming=float(self.cfg.matcher.th_high))
            if r is None:
                break
            frame.T_cw = np.asarray(r.T_cw, np.float64)
            best = r
        if best is None or int(best.n_inliers) < 30:
            return False
        frame.T_cw = np.asarray(best.T_cw)
        frame.mp_ids = self._slots_to_mids(best)
        return True

    def _local_map_points_from_all(self) -> np.ndarray:
        mids = np.asarray(sorted(self.map.points.keys()), np.int64)
        return mids

    def _region_points(self, seed_kid: int) -> np.ndarray:
        """Map points observed by `seed_kid`'s covisibility region, topped
        up with the rest of the map while capacity allows.  _match_stage
        truncates to max_local_mp slots, so the region points must come
        first."""
        cap = self.cfg.capacity.max_local_mp
        m = self.map
        region: List[int] = []
        seen: Set[int] = set()
        kf = m.keyframes.get(seed_kid)
        if kf is not None:
            for kid in [seed_kid] + m.covisible_kfs(kf):
                okf = m.keyframes.get(kid)
                if okf is None:
                    continue
                for mid in okf.mp_idx[okf.mp_idx >= 0]:
                    mid = int(mid)
                    if mid not in seen:
                        seen.add(mid)
                        region.append(mid)
                if len(region) >= cap:
                    break
        if len(region) < cap:
            for mid in sorted(m.points.keys(), reverse=True):
                if len(region) >= cap:
                    break
                if mid not in seen:
                    seen.add(mid)
                    region.append(mid)
        return np.asarray(region[:cap], np.int64)

    def force_lost(self) -> None:
        """Manual fault injection for relocalization testing
        (System::SetCompulsoryLost, System.cc:330-333)."""
        self._force_lost = True

    # ------------------------------------------------------------------
    def composed_trajectory(self):
        """[(fid, ts, T_cw)] with each frame pose re-composed against the
        CURRENT (post-BA) pose of its reference keyframe.  If the reference
        KF was culled, re-anchor through the parent chain using the
        relative poses frozen at cull time (the reference's Trw =
        Tcp-accumulating walk in System::SaveTrajectory)."""
        out = []
        for fid, ts, ref_kid, T_rel, T_abs in self.trajectory:
            T_acc = T_rel
            kid = ref_kid
            for _ in range(64):                    # chain-length bound
                if kid in self.map.keyframes:
                    break
                nxt = self.map.culled_redirect.get(kid)
                if nxt is None:
                    break
                kid = nxt[0]
                T_acc = T_acc @ nxt[1]
            ref = self.map.keyframes.get(kid)
            T = (T_acc @ ref.T_cw) if ref is not None else T_abs
            out.append((fid, ts, T))
        return out


def lie_apply_z(T: np.ndarray, p: np.ndarray) -> float:
    return float(T[2, :3] @ p + T[2, 3])
