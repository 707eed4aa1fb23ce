"""System facade: construction, per-frame entry, savers.

Port of orbslam2_dualcam_tpu/pipeline/system.py (src/System.cc in the
original): builds the map, keyframe database, tracker and local mapper
and exposes the per-frame TrackDual-style entry plus trajectory/map savers in the
reference's ``x y z qx qy qz qw [id]`` text format (System.cc:335-410).

The original spawns LocalMapping/LoopClosing threads (System.cc:116-150);
here stages run synchronously by default (deterministic).
`async_mapping=True` moves the local-mapping work, and the loop closer that
runs after it on each keyframe, onto a background thread fed by a keyframe
queue, with the map guarded by a coarse lock exactly where the original
holds mMutexMapUpdate.  Both threads launch on the same CUDA stream, so
their device work is serial; what overlaps is the mapper's device work
with the tracker's host work and the reverse.

With a vocabulary the system relocalizes by it, runs the dual-camera
bootstrap to a metric map and, unless `enable_loop_closing=False`, closes
loops (detection, Sim3, correction, global BA).  `viewer=True` serves the
live viewer (viz/live.py) over HTTP.  `deferred_tracking=True` pipelines
the tracker (Tracker(deferred=True)); with `async_mapping=True` as well it
is the deployment configuration, in which the tracker takes the map lock
only around its map-touching host sections.  `mesh` (a
parallel.runtime.Mesh) is handed to the tracker and the loop closer, whose
global BAs shard a large problem over it.
"""

from __future__ import annotations

import queue
import threading
from typing import Optional

import numpy as np

import torch

from orbslam2_dualcam_tpu_torch.models.kfdb import KeyFrameDatabase
from orbslam2_dualcam_tpu_torch.models.map import Map
from orbslam2_dualcam_tpu_torch.ops import camera, lie
from orbslam2_dualcam_tpu_torch.pipeline.local_mapping import LocalMapper
from orbslam2_dualcam_tpu_torch.pipeline.loop_closing import LoopCloser
from orbslam2_dualcam_tpu_torch.pipeline.tracking import Tracker
from orbslam2_dualcam_tpu_torch.utils.config import SystemConfig
from orbslam2_dualcam_tpu_torch.utils.device import resolve_device
from orbslam2_dualcam_tpu_torch.utils.profiling import SpanRecorder, span
from orbslam2_dualcam_tpu_torch.vocab import bow


class System:
    def __init__(self, cfg: SystemConfig,
                 voc: Optional[bow.Vocabulary] = None,
                 enable_loop_closing: bool = True,
                 async_mapping: bool = False,
                 mesh=None, viewer: bool = False,
                 viewer_port: int = 0,
                 deferred_tracking: bool = False, device=None) -> None:
        """`device`: where every device program of the system runs; None is
        the current CUDA device and raises where there is none.

        `voc`: a vocabulary on that device; with one the system keeps a
        keyframe database, relocalizes by it, with two cameras runs the
        cross-camera bootstrap and, with `enable_loop_closing`, closes
        loops; without one `enable_loop_closing` has no effect, as in the
        reference.

        `viewer=True` starts the live HTTP viewer (viz/live.py, the
        original's Viewer thread, System.cc:137); `viewer_port=0` picks a
        free port, printed at startup and available as
        `system.viewer.port`.  `track` redraws it from host data after each
        frame and `shutdown` closes it.

        `deferred_tracking=True` runs the tracker pipelined: frames are
        dispatched to the device `cfg.tracker.pipeline_depth` at a time (1:
        lag-1), and the previous dispatch's results are read and processed
        while the new one runs, so track() returns the state up to
        2*depth-1 frames behind, and shutdown() flushes the frames in
        flight.

        `mesh`: an optional parallel.runtime.Mesh; the global BAs (the
        metric GBA of the dual bootstrap, the loop closer's) go through
        runtime.solve_ba_auto with it, which shards problems of at least
        DIST_EDGE_THRESHOLD edges.  A mesh whose process group has more
        than one rank is refused: each rank would run the whole system, and
        the runs drift apart in the last bit (BA's sums are float atomics
        on the card), so their global BAs could be handed problems of
        different shapes, and the reductions over them would hang."""
        if mesh is not None and mesh.n_ranks > 1:
            raise NotImplementedError(
                f"System with a mesh over {mesh.n_ranks} processes: each "
                f"would run the whole system, the runs drift apart in the "
                f"last bit and their global BAs could reduce problems of "
                f"different shapes; call parallel.dist_ba."
                f"solve_ba_distributed with the identical problem on every "
                f"rank instead")
        self.cfg = cfg
        self.mesh = mesh
        self.device = resolve_device(device)
        self.rig = camera.make_rig(cfg, device=self.device)
        self.map = Map()
        self.voc = voc
        self.kfdb = (KeyFrameDatabase(cfg.n_cameras, voc.n_words)
                     if voc is not None else None)
        if self.kfdb is not None:
            # culling a keyframe must drop its inverted-file postings too,
            # or reloc queries return dead candidates (KeyFrame.cc:668)
            self.map.on_erase_keyframe.append(self.kfdb.erase)
        self.loop_closer = None
        if enable_loop_closing and voc is not None:
            self.loop_closer = LoopCloser(cfg, self.rig, self.map, self.kfdb,
                                          voc, mesh=mesh)
        self.mapper = LocalMapper(cfg, self.rig, self.map,
                                  loop_closer=self.loop_closer,
                                  kfdb=self.kfdb, voc=voc)
        self._async = async_mapping
        self.map_lock = threading.Lock()
        # the spans of the tracker, the mapper and the loop closer
        # (utils/profiling.py); current in track() and on the mapping thread
        self.tracer = SpanRecorder()
        if async_mapping:
            self._kf_queue: "queue.Queue" = queue.Queue()
            self._stop = threading.Event()
            # local BA yields: drops map_lock while each LM chunk runs on
            # the device, and aborts when the tracker queued another keyframe
            # (the reference's InterruptBA, LocalMapping.cc:97-108)
            self.mapper.map_lock = self.map_lock
            self.mapper.interrupt_check = lambda: not self._kf_queue.empty()
            self._mapper_thread = threading.Thread(
                target=self._mapping_loop, daemon=True)
            self._mapper_thread.start()
            front = _AsyncMapperProxy(self)
        else:
            front = self.mapper
        self.tracker = Tracker(cfg, self.rig, voc, self.map, self.kfdb,
                               local_mapper=front, mesh=mesh,
                               deferred=deferred_tracking)
        if async_mapping and self.tracker.deferred:
            # the tracker takes the lock itself, only around map-touching
            # sections, so the mapper thread runs during readback waits
            self.tracker.map_lock = self.map_lock
        if async_mapping:
            # KF back-pressure (the reference's LocalMapping idle check):
            # with >=2 keyframes queued, defer further insertions
            self.tracker.mapper_busy = \
                lambda: self._kf_queue.qsize() >= 2
        self.viewer = None
        if viewer:
            from orbslam2_dualcam_tpu_torch.viz.live import LiveViewer
            self.viewer = LiveViewer(port=viewer_port)
            # the viewer draws host arrays: one readback of the rig here
            self._T_sc_host = self.rig.T_sc.detach().cpu().numpy()
            print(f"# live viewer: http://localhost:{self.viewer.port}/")

    # ------------------------------------------------------------------
    def track(self, images: np.ndarray, timestamp: float) -> str:
        """Per-frame entry (System::TrackDual, System.cc:153-180).
        images: [ncam, H, W] uint8/float grayscale (uint8 preferred: it
        uploads 4x fewer bytes; float inputs are quantized to u8 at the
        device boundary either way, Tracker._stage_images).  The call is
        the root span `system.track` of `self.tracer`, with the submitted
        frame's id."""
        images = np.asarray(images)
        with self.tracer.activate(), \
                span("system.track", frame=self.tracker.frame_id):
            try:
                if self._async and not self.tracker.deferred:
                    with self.map_lock:
                        return self.tracker.process(images, timestamp)
                # synchronous mapping, or the deferred tracker, which holds
                # the lock only around its map-touching host sections
                return self.tracker.process(images, timestamp)
            finally:
                if self.viewer is not None:
                    self.viewer.update(
                        images, self.tracker.last, self.tracker.state,
                        self.map, self._T_sc_host,
                        reloc_T_cw=self.tracker.last_reloc_cam_pose)

    def _mapping_loop(self) -> None:
        with self.tracer.activate():
            while not self._stop.is_set():
                try:
                    kf, run_ba = self._kf_queue.get(timeout=0.05)
                except queue.Empty:
                    continue
                with self.map_lock:
                    self.mapper.on_new_keyframe(kf, run_ba=run_ba)

    def shutdown(self) -> None:
        with self.tracer.activate(), span("system.shutdown"):
            self.tracker.flush()
        if self.viewer is not None:
            self.viewer.close()
            self.viewer = None
        if self._async:
            while not self._kf_queue.empty():
                import time
                time.sleep(0.01)
            self._stop.set()
            self._mapper_thread.join(timeout=5.0)

    def activate_localization_mode(self) -> None:
        """Track against the frozen map without extending it
        (System::ActivateLocalizationMode, System.cc:182-199)."""
        self.tracker.localization_only = True

    def deactivate_localization_mode(self) -> None:
        self.tracker.localization_only = False

    def set_compulsory_lost(self) -> None:
        """Force LOST on the next frame (System.cc:330-333)."""
        self.tracker.force_lost()

    def reset(self) -> None:
        """System/Tracking reset (Tracking.cc:1863-1918)."""
        self.map.clear()
        if self.kfdb is not None:
            self.kfdb.clear()
        self.tracker.reset_state()
        self.mapper.recent_mids.clear()
        if self.loop_closer is not None:
            self.loop_closer.consistent_groups.clear()
            self.loop_closer.last_loop_kid = -1

    # ------------------------------------------------------------------
    # savers (System.cc:335-410 formats)
    # ------------------------------------------------------------------
    @staticmethod
    def _pose_line(T_cw: np.ndarray, suffix: str = "") -> str:
        T_wc = np.linalg.inv(T_cw)
        t = T_wc[:3, 3]
        # small host math stays on the host: an explicit CPU tensor
        q = lie.rot_to_quat(torch.as_tensor(
            T_wc[:3, :3].astype(np.float32), device="cpu")).numpy()
        return (f"{t[0]:.7f} {t[1]:.7f} {t[2]:.7f} "
                f"{q[1]:.7f} {q[2]:.7f} {q[3]:.7f} {q[0]:.7f}{suffix}")

    def save_frame_trajectory(self, path: str) -> None:
        """SaveFramePoseTcw (System.cc:372-391): per-frame camera poses."""
        with open(path, "w") as f:
            for fid, ts, T in self.tracker.composed_trajectory():
                f.write(self._pose_line(T, f" {fid}") + "\n")

    def save_keyframe_trajectory(self, path: str) -> None:
        with open(path, "w") as f:
            for kid in sorted(self.map.keyframes):
                kf = self.map.keyframes[kid]
                f.write(self._pose_line(kf.T_cw, f" {kid}") + "\n")

    def save_map_points(self, path: str) -> None:
        with open(path, "w") as f:
            for mid in sorted(self.map.points):
                p = self.map.points[mid].pos
                f.write(f"{p[0]:.7f} {p[1]:.7f} {p[2]:.7f} {mid}\n")


class _AsyncMapperProxy:
    """Queue-facing stand-in handed to the Tracker in async mode (the
    reference's LocalMapping::InsertKeyFrame queue, LocalMapping.h:123)."""

    def __init__(self, system: System) -> None:
        self._system = system

    def on_new_keyframe(self, kf, run_ba: bool = True) -> None:
        self._system._kf_queue.put((kf, run_ba))
