#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --profile    (kernel launches and the card's busy
                                        time of System.track, of one local BA
                                        and of the dual bootstrap's solvers
                                        under torch.profiler; no checks)

Drives the port's main paths, the fused dual-camera tracking step
(orbslam2_dualcam_tpu_torch.pipeline.frontend.make_track_fn), its batched
form (make_track_batch_fn), the monocular SLAM system
(pipeline.system.System.track without a vocabulary), the dual-camera
system with a vocabulary (relocalization, the cross-camera bootstrap to a
metric map), the system with loop closing (detection, Sim3 RANSAC and
optimizer, correction, global BA), the video CLI with its settings,
vocabulary and map files and the cloud tools, the deployment
configuration (deferred batched tracking with the mapping thread), and
distributed bundle adjustment (virtual meshes of shards of the card, a
mesh-attached System, two processes in one gloo group), at the reference's
operating point:
2 x 640 x 480 frames, 1300 features per camera, 8 levels x 1.2, a 2048-slot
map store and, for the step, a random vocabulary tree of ORBvoc's shape
(k=10, depth 6).  Phases, each raising on failure:

  1. card: nvidia-smi name and power limit, torch and CUDA versions;
  2. build: the CUDA kernels from csrc/ with nvcc (sm_90a), and the C++
     postings index (native/invfile.cpp) with g++;
  3. K1 (fast_nms) against its plain torch version on the card: the
     one-level entry at all 8 main-path level shapes for two cameras and a
     non-tile-aligned shape, and the pyramid entry (one launch for all 8
     levels) per level, on u8-valued and on random float input, bit-exact;
  4. track a rendered 12-frame orbit: seed the store from frame 0 with
     ground-truth depth, chain frames 1-11 through the step, hold poses and
     match counts to fixed bounds, count one K1 launch per frame,
     re-run frame 1 on the host CPU as a cross-check, and run one step with
     host synchronization forbidden;
  5. the batched path: frames 1-4 through make_track_batch_fn, every output
     held equal to the same frames of phase 4 run one by one, one K1 launch
     per frame counted, and one batch run with host synchronization
     forbidden;
  6. timing with CUDA events: the step's median ms/frame on the rendered
     chain and on 20 random frames (worst case: the widened retry always
     engages), a per-stage split, the batched path's ms/frame beside the
     one-frame path's in alternating runs, and K1 (the pyramid launch, the
     eight one-level launches, level 0 alone) against its plain version and
     its bound;
  7. the system: System(dual_default(), voc=None, enable_loop_closing=False)
     on a rendered 25-frame dual orbit (radius 1.5 m, 3.2 deg and 8.4 cm per
     frame, looking along the tangent: the sideways motion gives the
     two-view initialization its parallax within two or three frames),
     synchronous, then with async_mapping=True (frames paced at the
     synchronous run's median rate), then 10 frames with
     cfg.tracker.fused_tracking=False (every frame through the host-stepped
     cascade).  Held to the gates of the reference's mono SLAM test (OK
     within 15 frames and at the end, <= 3 LOST, >= 4 keyframes, > 150 map
     points, > 50 triangulated, Sim3-aligned ATE under 9% of the path), one
     K1 launch per track call, a local BA that lowered its cost, and one
     solve_ba chunk with host synchronization forbidden; prints the
     frames/s of System.track, the stage timers, ms per local BA by its
     (K, M, E) bucket and ms per two_view_init;
  8. the dual bootstrap: System(cfg, voc, enable_loop_closing=False) with
     dual_default()'s intrinsics, ORB, matcher, mapping and capacity
     settings, camera 1 facing backwards 0.50 m behind camera 0, cross-camera
     attempts every 4 frames and 3 relocalizations before the second map (the
     82-frame trajectory is too short for the defaults of 30 / 50 / 5), and
     a 10-ary vocabulary of cfg.vocab.depth levels trained here on the
     descriptors the port extracts on the card from 10 rendered orbit
     frames.  An out-and-back walk with a U-turn (26 + 30 + 26 frames) in the
     box room, synchronous, then with async_mapping=True paced at the
     synchronous median; after the synchronous walk a forced loss
     (set_compulsory_lost) with the rig standing where the walk ended (the
     frames it takes to recover there, up to 5, are reported), then one with
     the rig put back on the way out, and the frames it takes to
     relocalize by vocabulary there.  Gates: last state OK or
     FULL, <= 5 LOST, XRELOC@, SCALED@ and FULL@ in the event trail, a metric
     map with its scale anchor, > 20 map points seen by camera 1,
     Sim3-aligned keyframe ATE under 10% of the trajectory's span, Umeyama
     scale in (0.2, 4.0), relocalized within 10 frames of the forced loss,
     one K1 launch per track call.  Prints ms per track call by state
     (MONO, bootstrap, FULL), the stage timers, and the time of one
     pnp_ransac, one scale solve, one pose graph and one metric global BA;
  9. the loop: System(cfg, voc, enable_loop_closing=True) with camera 0 of
     dual_default() alone (the reference's 1-camera mode of
     tests/test_loop_closing.py) and dual_default()'s ORB, matcher, mapping,
     loop and capacity settings, a 10-ary vocabulary of cfg.vocab.depth
     levels trained on the card's own descriptors of 16 orbit frames, and
     110 frames over 2.2 pi of an orbit of radius 1.5 m in the box room
     (seed 7) looking along the tangent, 3.6 deg and 9.4 cm per frame:
     past one full turn, so that consecutive detections build a consistent
     group.  Synchronous, gated as that test gates: a loop closed, last
     state OK, <= 3 LOST, Sim3-aligned ATE of the composed trajectory
     under 0.8 m, every map point finite, one K1 launch per track call.
     Prints ms per track call (median, max, the closing call apart), the
     closing call's split (detect, Sim3 with CUDA events around the RANSAC
     and the optimizer, the correction's fuse, pose graph (CUDA events) and
     point statistics, the global BA), the accepted loop's log lines and the
     keyframe ATE just before and just after the correction;
 10. the run path, what a user runs: a settings file in the original's
     format for phase 8's rig (read back equal in every field it carries),
     phase 8's vocabulary saved as .npz, and the first 40 frames of phase
     8's walk as one side-by-side MJPG video; `python3 -m
     orbslam2_dualcam_tpu_torch.run` on them in a child process (exit 0,
     the four artifacts), and the same video through the CLI's own pieces
     (run.video_frames, run.track_stream, run.write_artifacts) in this
     process with K1's launches counted and each call timed.  Gates: the
     artifacts, a frame line per tracked frame, one K1 launch per track
     call, keyframe Sim3 ATE within phase 8's band; then the child's map.npz
     restored (keyframe and point counts, points and keyframe poses equal to
     the text files to their print precision), rebuild_kfdb on the card's
     vocabulary (each keyframe finds itself by its own BoW vector), tools
     convert --voxel 0.05, and fit_planes on the card and on the CPU (same
     planes, normals within 1e-3, inlier counts within 1).  Prints ms per
     track call beside phase 8's over the same frames, and fit_planes' ms;
 11. the deployment configuration, bench.py's bench_end_to_end in the port:
     first utils.device.Readback on the card (its wait() returns while a
     sleep kernel queued after it runs, and a Python thread runs during
     the wait); then System(cfg, voc, enable_loop_closing=False,
     async_mapping=True, deferred_tracking=True) with dual_default() at
     images_u8=True and pipeline_depth 3, the vocabulary (k=8, depth 3,
     seed 7) trained on 20,000 random descriptors of rng(1), over the
     90-frame 1.2 pi orbit of radius 1.5 m in that rng's box room (u8 frames
     rendered untimed), each call timed on the host clock with no
     synchronization around it, gated as tests/test_deferred.py gates
     deferred tracking with the mapping thread: no DROPFRAME@ or LOST@,
     >= 85 frames in the trajectory after shutdown(), Sim3 ATE under
     0.35 m (THIN@ counted: with the mapper on its own thread the store a
     batch is dispatched against lags the map, and stage 1 of a batch's
     first frame thins now and then); then the same deferred pipeline with
     synchronous mapping, gated as that file gates the deferred mode alone
     (no DROPFRAME@, THIN@ or LOST@, the trajectory, the ATE) over the
     first 45 frames; every run
     one K1 launch per track call and one fused_get wait per dispatched
     batch.  Prints bench.py's fields (mean, p90 and median ms per call
     over calls 20-89, fps from the mean, the stage medians), the same 90
     frames synchronously (mean, ATE), a lag-1 run (pipeline_depth 1,
     async) over the first 30 frames, and peak memory.  Phase 11 alone: python3 -c "import torch, chip_smoke as c;
     c._build.load_library(); c.phase_deployment(torch.device('cuda', 0),
     c.card_line())";
 12. distributed BA (parallel/): (a) examples/bench_dist_ba.py's problem at
     its defaults (256 keyframes in a ring, 32768 points seen 8 times each,
     E = 262144) solved by ba.solve_ba and by solve_ba_distributed on
     virtual meshes of 2 and 4 shards of the card, replicated and
     point-sharded, each held to the single-device solve at
     tests/test_dist_ba.py's bands (cost rtol 1e-3, poses atol 5e-4, points
     atol 5e-3 point-sharded, per-edge chi2 row by row in the caller's
     order), with ms per LM iteration of each; (b) phase 9's final map:
     its packed (K, M, E), LoopCloser._global_ba once with a 4-shard mesh
     attached (at the default threshold when E >= 16384, else forced with
     dist_edge_threshold=1, and said so), its distributed solve held to
     ba.solve_ba on the same packed problem at tests/test_dist_pipeline.py's
     bands (cost rtol 2e-3, poses rtol 1e-2 atol 2e-3); (c) System(
     dual_default(), voc=None, mesh=<2 shards of the card>) over 20 frames
     of phase 7's orbit, ending OK with one K1 launch per call; (d) two
     child processes, ranks of one gloo group (NCCL refuses two ranks on
     one card), one shard each on the card, on (a)'s problem: equal costs,
     within tests/test_multihost.py's 2e-3 of the in-process 2-shard solve;
     (e) examples/eval_tum.py's evaluate over a 30-frame TUM-layout
     sequence at 640x480 written to disk here, gated at <= 8 frames
     untracked, >= 5 keyframes and phase 7's ATE band.  Phase 12 alone:
     python3 -c "import torch, chip_smoke as c; c._build.load_library();
     d = torch.device('cuda', 0); c.phase_dist(d, c.card_line(),
     c.phase_loop(d, c.card_line())[1])".

The last line of standard output is a JSON object with "ok": true; it is
printed only when every phase passed.  There is no CPU path: without a
CUDA card the script exits with an error.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from orbslam2_dualcam_tpu_torch import _build, dual_default
from orbslam2_dualcam_tpu_torch.examples import bench_dist_ba, eval_tum
from orbslam2_dualcam_tpu_torch.native import invfile
from orbslam2_dualcam_tpu_torch.ops import fast_nms as k1
from orbslam2_dualcam_tpu_torch.ops import ransac
from orbslam2_dualcam_tpu_torch.ops.camera import make_rig
from orbslam2_dualcam_tpu_torch.ops.orb import _tables, build_pyramid, level_shapes
from orbslam2_dualcam_tpu_torch.optim import (ba, pose_graph, pose_opt, scale_opt,
                                              sim3_opt)
from orbslam2_dualcam_tpu_torch.parallel import dist_ba, runtime
from orbslam2_dualcam_tpu_torch.parallel.runtime import Mesh
from orbslam2_dualcam_tpu_torch.pipeline import frontend
from orbslam2_dualcam_tpu_torch.pipeline.system import System
from orbslam2_dualcam_tpu_torch.utils import metrics, synthetic
from orbslam2_dualcam_tpu_torch.utils.convert import desc_to_numpy, desc_to_torch
from orbslam2_dualcam_tpu_torch.utils.device import Readback
from orbslam2_dualcam_tpu_torch.vocab import bow
from orbslam2_dualcam_tpu_torch.vocab.bow import Vocabulary

H, W = 480, 640
N_FRAMES = 12
DEPTH = 4                           # frames per batch of the batched path
TH_HI, TH_LO = 20.0, 7.0            # FAST thresholds of the main path
# K1's bound (the least time the card could take for the same function).
# Bytes: each pixel read once, both outputs written once.  Operations, per
# pixel: 16 circle differences; for each of them and each polarity a
# compare, a subtract, a conditional add and a mask insert (128); two
# run-of-9 tests of 4 shifts, 4 ANDs and a test (18); the low score, the
# blend and sad_lo (6); 8 max, a compare and a select for the NMS (10).
# Where a low-threshold arc exists (counted from this run's data), one
# polarity again at the high threshold: 16 x 4, a run-of-9 test, a select.
# None of these fuse into multiply-adds, so the rate is one operation per
# lane and clock: half of the card's 67 TFLOP/s f32 peak, which counts a
# multiply-add as two.
K1_BYTES_PER_PIXEL = 12
K1_OPS_PER_PIXEL = 16 + 128 + 18 + 6 + 10
K1_OPS_PER_ARC = 64 + 9 + 2
H100_BYTES_PER_S = 3.35e12
H100_SIMPLE_OPS_PER_S = 67e12 / 2
STEP_RAD = 1.2 * math.pi / 90       # per-frame yaw of the orbit (2.4 deg)
# Bounds on every tracked frame (1-11).  Set from the same full-size
# sequence run through the port on a host CPU (and on the card, which
# agreed): worst rotation error 0.124 deg and worst center error 1.11 cm
# (frame 1, predicted with zero velocity), fewest final inliers 459
# (frame 11, the store is never refreshed).
MAX_ROT_ERR_DEG = 0.5
MAX_CENTER_ERR_M = 0.03
MIN_N_FINAL = 350
# The system phase: frames of the orbit, frames of the host-stepped run,
# and the ATE band of the reference's mono SLAM test (0.30 m on ~3.5 m).
SYS_FRAMES = 25
SYS_STEPPED_FRAMES = 10
SYS_MAX_ATE_OF_PATH = 0.09
# The dual phase: the out-and-back walk (frames out, in the U-turn, back),
# the baseline, the frames allowed for the relocalization after the forced
# loss, the integration gates, and the reported accuracy bands (those of the
# reference's wide-baseline test at a quarter of this resolution).
DUAL_WALK = (26, 30, 26)
DUAL_BASELINE_M = 0.50
DUAL_RELOC_FRAMES = 10
DUAL_INPLACE_FRAMES = 5             # tries where the walk ended, reported
DUAL_MAX_LOST = 5
DUAL_MIN_CAM1_POINTS = 20
DUAL_MAX_ATE_OF_SPAN = 0.10
DUAL_SCALE_GATE = (0.2, 4.0)
DUAL_SCALE_BAND = (0.75, 1.35)
DUAL_SE3_ATE_BAND_OF_SPAN = 0.45
# The loop phase: frames and total angle of the orbit (3.6 deg and 9.4 cm
# per frame at radius 1.5 m), and the gates of tests/test_loop_closing.py.
LOOP_FRAMES = 110
LOOP_ANGLE = 2.2 * math.pi
LOOP_RADIUS = 1.5
LOOP_MAX_LOST = 3
LOOP_MAX_ATE_M = 0.8

# phase 10, the run path: the CLI's frame loop over the first 40 frames of
# phase 8's walk, as one joint MJPG video (the card's machine has cv2; it
# has no matplotlib, so the live viewer's drawing is not driven there)
RUN_FRAMES = 40
RUN_CLI_TIMEOUT_S = 600

# phase 11, the deployment configuration of bench.py's bench_end_to_end:
# frames of the orbit (1.2 pi, radius 1.5 m), warm-up frames left out of
# the mean, frames of the lag-1 run, and the gates of tests/test_deferred.py
DEPLOY_FRAMES = 90
DEPLOY_WARMUP = 20
DEPLOY_LAG1_FRAMES = 30
DEPLOY_MAX_MISSING = 5              # frames a run's trajectory may lack
# frames of the deferred run with synchronous mapping (it covers frame 22,
# where the runs with the mapping thread first thin; cut to keep the whole
# script well inside its time limit)
DEPLOY_SYNCMAP_FRAMES = 45
DEPLOY_MAX_ATE_M = 0.35

# phase 12, distributed BA: bench_dist_ba's problem at its defaults (a ring
# of 256 keyframes, 32768 points seen 8 times each: E = 262144), the shard
# counts of the virtual meshes, the LM iterations of every solve, the frames
# of the mesh-attached system run and of the TUM-layout sequence, and the
# wall timeout of the two ranks
DIST_KF, DIST_MP, DIST_OBS = 256, 32768, 8
DIST_SHARDS = (2, 4)
DIST_ITERS = 10
DIST_SYS_FRAMES = 20
DIST_TUM_FRAMES = 30
DIST_RANKS_TIMEOUT_S = 240


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def random_vocabulary(rng, k: int, depth: int, direct_level: int,
                      device) -> Vocabulary:
    """A tree of ORBvoc's shape with random centroids (quantization cost
    depends on the shape only)."""
    cents = tuple(desc_to_torch(rng.integers(0, 2 ** 32, (k ** (l + 1), 8),
                                             dtype=np.uint32), device)
                  for l in range(depth))
    return Vocabulary(k, depth, cents, torch.ones(k ** depth, device=device),
                      direct_level)


def pose_errors(T_cw: np.ndarray, T_gt: np.ndarray):
    """(rotation error in degrees, camera-center error in meters)."""
    R = T_cw[:3, :3] @ T_gt[:3, :3].T
    axis = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    rot = math.degrees(math.atan2(np.linalg.norm(axis) / 2, (np.trace(R) - 1) / 2))
    c = -T_cw[:3, :3].T @ T_cw[:3, 3]
    c_gt = -T_gt[:3, :3].T @ T_gt[:3, 3]
    return rot, float(np.linalg.norm(c - c_gt))


class Scene:
    """The rendered orbit, the vocabulary and the seeded store on the
    card.  The rig, the step and the batched step are built with no
    `device` argument: the entry points' default is the current CUDA
    device, which must be `device`."""

    def __init__(self, cfg, device, seed: int = 1):
        rng = np.random.default_rng(seed)
        self.cfg, self.device = cfg, device
        self.n_feats, self.cap = cfg.orb.n_track, cfg.tracker.fused_cap
        self.rig = make_rig(cfg)
        if self.rig.K.device != device:
            raise AssertionError(f"make_rig() landed on {self.rig.K.device}, "
                                 f"not on {device}")
        self.voc = random_vocabulary(rng, 10, 6, cfg.vocab.direct_index_level,
                                     device)
        self.world = synthetic.make_box_world(rng, half=6.0)
        self.poses = synthetic.orbit_trajectory(
            N_FRAMES, radius=1.5, total_angle=N_FRAMES * STEP_RAD)
        K, T_sc = self.rig.K.cpu().numpy(), self.rig.T_sc.cpu().numpy()
        self.frames = [np.clip(np.round(synthetic.render_rig(
            self.world, K, T_sc, T, H=H, W=W)), 0, 255).astype(np.uint8)
            for T in self.poses]
        self.step = frontend.make_track_fn(cfg, self.n_feats, self.voc, self.rig)
        self.batch = frontend.make_track_batch_fn(cfg, self.n_feats, self.voc,
                                                  self.rig, DEPTH)
        f = frontend._extract_frame_body(
            torch.as_tensor(self.frames[0], device=device), cfg, self.n_feats,
            self.voc, self.rig).feats
        self.store = synthetic.seed_store(
            self.world, K, T_sc, self.poses[0], f.uv.cpu().numpy(),
            f.level.cpu().numpy(), desc_to_numpy(f.desc), f.valid.cpu().numpy(),
            cfg.orb.scale_factors, self.cap)

    def store_tensors(self, device):
        st = self.store
        return (torch.as_tensor(st.pos, device=device),
                desc_to_torch(st.desc, device),
                torch.as_tensor(st.valid, device=device),
                torch.as_tensor(st.max_dist, device=device),
                torch.as_tensor(st.min_dist, device=device),
                torch.as_tensor(st.normal, device=device))

    def initial_state(self, device):
        return (torch.as_tensor(self.poses[0], dtype=torch.float32, device=device),
                torch.eye(4, device=device),
                torch.as_tensor(self.store.slots, device=device))


def k1_inputs(rng, world, h: int, w: int):
    """[("u8-valued", rendered [2, h, w]), ("random", uniform floats)]."""
    K = np.array([[500.0 * w / W, 0, w / 2], [0, 500.0 * h / H, h / 2], [0, 0, 1]])
    rendered = np.round(synthetic.render_rig(
        world, np.stack([K, K]), np.stack([np.eye(4), np.diag([-1.0, 1, -1, 1])]),
        np.eye(4), H=h, W=w)).astype(np.float32)
    return [("u8-valued", rendered),
            ("random", rng.uniform(0, 255, (2, h, w)).astype(np.float32))]


def k1_error(out, ref) -> float:
    return max((out[0] - ref[0]).abs().max().item(),
               (out[1] - ref[1]).abs().max().item())


def phase_k1(device) -> float:
    """K1 against fast_nms_reference on the card, bit-exact: the one-level
    entry at every main-path shape and 100x150, then the pyramid entry in
    one launch over the 8 main-path shapes.  Returns max |error|."""
    rng = np.random.default_rng(2)
    world = synthetic.make_box_world(rng, half=6.0, tex_size=256)
    shapes = level_shapes(H, W, 8, 1.2)
    worst = 0.0
    pyramids = {"u8-valued": [], "random": []}
    for h, w in shapes + [(100, 150)]:
        for name, img in k1_inputs(rng, world, h, w):
            x = torch.as_tensor(img, device=device)
            out = k1.fast_nms(x, TH_HI, TH_LO)
            torch.cuda.synchronize()
            ref = k1.fast_nms_reference(x, TH_HI, TH_LO)
            err = k1_error(out, ref)
            worst = max(worst, err)
            if err != 0.0:
                raise AssertionError(f"K1 disagrees at {h}x{w} {name}: "
                                     f"max |err| {err}")
            if (h, w) in shapes:
                pyramids[name].append((x, ref))
        log(f"  K1 {h}x{w} x2: agrees (corners kept {int((out[0] > 0).sum())})")
    for name, levels in pyramids.items():
        n0 = k1.fast_nms.launches
        outs = k1.fast_nms_levels([x for x, _ in levels], TH_HI, TH_LO)
        torch.cuda.synchronize()
        if k1.fast_nms.launches != n0 + 1:
            raise AssertionError("the pyramid entry did not launch exactly once")
        errs = [k1_error(out, ref) for out, (_, ref) in zip(outs, levels)]
        worst = max(worst, *errs)
        if any(e != 0.0 for e in errs):
            raise AssertionError(f"K1 pyramid launch disagrees on {name} input: "
                                 f"max |err| per level {errs}")
        log(f"  K1 pyramid, one launch over {len(levels)} levels x2, {name}: "
            f"max |err| per level {errs}")
    return worst


def run_chain(scene: Scene, device):
    """Chain frames 1-11 on the card.  Returns the per-frame (FrameData,
    FusedTrackOut), the ms of each step (CUDA events around each call) and
    K1's launch count over the chain (set to 0 just before it)."""
    mp = scene.store_tensors(device)
    T, V, slots = scene.initial_state(device)
    on = torch.ones(2, dtype=torch.bool, device=device)
    frames = iter([torch.as_tensor(f, device=device) for f in scene.frames[1:]])
    outs = []

    def step():
        nonlocal T, V, slots
        fd, o = scene.step(next(frames), T, V, slots, on, *mp)
        T, V, slots = o.T_cw, o.V_new, o.mp_slots
        outs.append((fd, o))

    torch.cuda.synchronize()
    k1.fast_nms.launches = 0
    ms = time_events(step, len(scene.frames) - 1)
    return outs, ms, k1.fast_nms.launches


def check_track(scene: Scene, outs) -> None:
    for k, (fd, o) in enumerate(outs, start=1):
        f = fd.feats
        shapes_ok = (f.uv.shape == (2, scene.n_feats, 2) and
                     f.desc.shape == (2, scene.n_feats, 8) and
                     o.mp_slots.shape == (2, scene.n_feats) and
                     o.mp_visible.shape == (scene.cap,))
        finite = bool(torch.isfinite(o.T_cw).all() and torch.isfinite(f.uv).all())
        T = o.T_cw.cpu().numpy().astype(np.float64)
        rot, cen = pose_errors(T, scene.poses[k])
        n_final, n1 = int(o.n_final), int(o.n_stage1)
        n_valid = int(f.valid.sum())
        log(f"  frame {k:2d}: valid kp {n_valid}, stage-1 inliers {n1}, "
            f"final {n_final}, rot err {rot:.4f} deg, center err {cen * 100:.3f} cm")
        if not (shapes_ok and finite):
            raise AssertionError(f"frame {k}: bad shapes or non-finite output")
        if n_final < MIN_N_FINAL or rot > MAX_ROT_ERR_DEG or cen > MAX_CENTER_ERR_M:
            raise AssertionError(
                f"frame {k} outside bounds: n_final {n_final} (>= {MIN_N_FINAL}), "
                f"rot {rot:.4f} deg (<= {MAX_ROT_ERR_DEG}), center {cen:.4f} m "
                f"(<= {MAX_CENTER_ERR_M})")
        if n_valid < 0.8 * 2 * scene.n_feats:
            raise AssertionError(f"frame {k}: only {n_valid} valid keypoints")


def cross_check_cpu(scene: Scene, card_out) -> None:
    """Frame 1 through the same step on the host CPU (the kernels' plain
    versions): the pose agrees to 1e-3, n_final within max(3, 3%), >= 95%
    of matched slots equal: the port's own CPU-vs-reference agreement."""
    cpu_rig = make_rig(scene.cfg, "cpu")
    cpu_voc = Vocabulary(scene.voc.branching, scene.voc.depth,
                         tuple(c.cpu() for c in scene.voc.centroids),
                         scene.voc.idf.cpu(), scene.voc.direct_level)
    step = frontend.make_track_fn(scene.cfg, scene.n_feats, cpu_voc, cpu_rig, "cpu")
    T, V, slots = scene.initial_state("cpu")
    t0 = time.perf_counter()
    _, o = step(torch.as_tensor(scene.frames[1]), T, V, slots,
                torch.ones(2, dtype=torch.bool), *scene.store_tensors("cpu"))
    dt = time.perf_counter() - t0
    g = card_out
    dT = (g.T_cw.cpu() - o.T_cw).abs().max().item()
    same = (g.mp_slots.cpu() == o.mp_slots).float().mean().item()
    n_c, n_g = int(o.n_final), int(g.n_final)
    log(f"  host CPU frame 1 ({dt:.1f} s): |dT| {dT:.2e}, n_final {n_c} vs card "
        f"{n_g}, matched slots equal {same * 100:.2f}%")
    if dT > 1e-3 or abs(n_c - n_g) > max(3, 0.03 * n_c) or same < 0.95:
        raise AssertionError("card and host CPU disagree on frame 1")


def check_no_host_sync(scene: Scene, device) -> None:
    """One step under CUDA's sync debug mode "error": an operation that
    synchronizes the host with the card raises instead of running (what a
    CUDA graph capture of the step will need)."""
    mp = scene.store_tensors(device)
    T, V, slots = scene.initial_state(device)
    on = torch.ones(2, dtype=torch.bool, device=device)
    img = torch.as_tensor(scene.frames[1], device=device)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        scene.step(img, T, V, slots, on, *mp)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    log("  one step ran with no host synchronization (sync debug mode: error)")


def batch_args(scene: Scene, device):
    """The batched entry point's arguments on the card: frames 1..DEPTH and
    the state the one-by-one chain starts from."""
    T, V, slots = scene.initial_state(device)
    on = torch.ones(2, dtype=torch.bool, device=device)
    images = torch.as_tensor(np.stack(scene.frames[1:1 + DEPTH]), device=device)
    return (images, T, V, slots, on, *scene.store_tensors(device))


def check_batch(scene: Scene, device, single) -> int:
    """The batched path against the same frames run one by one (`single`,
    phase 4's outputs): same kernels in the same order, so every output is
    held exactly equal.  Returns K1's launches over the batch."""
    args = batch_args(scene, device)
    torch.cuda.synchronize()
    k1.fast_nms.launches = 0
    carry, fds, outs = scene.batch(*args)
    torch.cuda.synchronize()
    launches = k1.fast_nms.launches
    if any(x.shape[0] != DEPTH or x.device != device for x in outs):
        raise AssertionError("a batch output lacks the leading axis or the card")
    if fds.feats.desc.shape != (DEPTH, 2, scene.n_feats, 8):
        raise AssertionError(f"batched descriptors {tuple(fds.feats.desc.shape)}")
    unequal = []
    for k in range(DEPTH):
        fd1, o1 = single[k]
        pairs = list(zip(outs._fields, outs, o1)) + [
            ("uv", fds.feats.uv, fd1.feats.uv), ("desc", fds.feats.desc, fd1.feats.desc),
            ("words", fds.words, fd1.words)]
        unequal += [(k + 1, name) for name, stacked, one in pairs
                    if not torch.equal(stacked[k], one)]
        dT = (outs.T_cw[k] - o1.T_cw).abs().max().item()
        same = (outs.mp_slots[k] == o1.mp_slots).float().mean().item()
        log(f"  batch frame {k + 1}: |dT| vs one-by-one {dT}, n_final "
            f"{int(outs.n_final[k])} vs {int(o1.n_final)}, matched slots equal "
            f"{same * 100:.2f}%")
    if unequal:
        raise AssertionError(f"batched and one-by-one outputs differ: {unequal}")
    last = single[DEPTH - 1][1]
    if not all(torch.equal(c, x) for c, x in
               zip(carry, (last.T_cw, last.V_new, last.mp_slots))):
        raise AssertionError("the batch's final carry is not its last frame's")
    torch.cuda.set_sync_debug_mode("error")
    try:
        scene.batch(*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    log(f"  a batch of {DEPTH} frames ran with no host synchronization "
        f"(sync debug mode: error)")
    return launches


def time_batch_vs_single(scene: Scene, device, rounds: int = 3):
    """ms/frame of frames 1..DEPTH through the batched entry point and
    through the one-frame step, in alternating runs (one-frame, batch,
    batch, one-frame per round), each run between two CUDA events."""
    mp = scene.store_tensors(device)
    on = torch.ones(2, dtype=torch.bool, device=device)
    frames = [torch.as_tensor(f, device=device) for f in scene.frames[1:1 + DEPTH]]

    def one_by_one():
        T, V, slots = scene.initial_state(device)
        for img in frames:
            _, o = scene.step(img, T, V, slots, on, *mp)
            T, V, slots = o.T_cw, o.V_new, o.mp_slots

    args = batch_args(scene, device)

    def batch():
        scene.batch(*args)

    t_single, t_batch = [], []
    for _ in range(rounds):
        for fn, out in ((one_by_one, t_single), (batch, t_batch),
                        (batch, t_batch), (one_by_one, t_single)):
            out.append(time_events(fn, 1)[0] / DEPTH)
    return t_single, t_batch


def time_events(fn, n: int) -> list[float]:
    """ms of each of n calls, with CUDA events around each."""
    out = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return out


def run_chain_with_spans(scene: Scene, device):
    """The rendered chain, timed as in run_chain, with CUDA events also
    around each extraction, each match + pose stage and each optimize_pose
    call inside the steps.  The step's stage functions are wrapped for this
    run only; an event record is queued on the stream with no host sync, so
    the spans and the frame times come from the same run.  Returns the
    per-frame ms and the total ms of each span over the chain."""
    spans = {"extraction": [], "match + pose stages": [], "optimize_pose": []}
    patched = [(frontend, "_extract_frame_body", "extraction"),
               (frontend, "match_projection_pose", "match + pose stages"),
               (pose_opt, "optimize_pose", "optimize_pose")]
    saved = [getattr(mod, attr) for mod, attr, _ in patched]

    def timed(fn, events):
        def call(*args, **kwargs):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = fn(*args, **kwargs)
            b.record()
            events.append((a, b))
            return out
        return call

    for (mod, attr, key), fn in zip(patched, saved):
        setattr(mod, attr, timed(fn, spans[key]))
    try:
        _, ms, _ = run_chain(scene, device)
    finally:
        for (mod, attr, _), fn in zip(patched, saved):
            setattr(mod, attr, fn)
    torch.cuda.synchronize()
    return ms, {k: sum(a.elapsed_time(b) for a, b in v) for k, v in spans.items()}


def time_random(scene: Scene, device) -> list[float]:
    """ms of the step on each of 20 random frames, after 3 warm-up steps."""
    mp = scene.store_tensors(device)
    T, V, slots = scene.initial_state(device)
    on = torch.ones(2, dtype=torch.bool, device=device)
    rng = np.random.default_rng(3)
    rand = [torch.as_tensor(rng.integers(0, 256, (2, H, W), dtype=np.uint8),
                            device=device) for _ in range(20)]

    def step(img):
        return scene.step(img, T, V, slots, on, *mp)

    for img in rand[:3]:                                   # warm-up
        step(img)
    torch.cuda.synchronize()
    it = iter(rand)
    return time_events(lambda: step(next(it)), len(rand))


def time_calls(fn, n: int, device_only: bool = False) -> float:
    """ms per call of n back-to-back calls between two CUDA events, after
    one warm-up call.  Plain, the time includes the host's launch
    overhead; with `device_only` the n calls are queued behind a sleep
    kernel, so the events see their launches run back to back."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    fn()
    torch.cuda.synchronize()
    if device_only:
        torch.cuda._sleep(50_000_000)          # ~25 ms of device time
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def k1_bound_ms(levels) -> tuple[float, str, float]:
    """(bound in ms, what binds, share of pixels with a low-threshold arc)
    of K1 on these inputs: the larger of the bytes it must move over the
    card's memory rate and the operations it must do over the card's rate
    for them (constants at the top)."""
    n_px = sum(x.numel() for x in levels)
    n_arc = sum(int((k1.fast_scores2(x, TH_HI, TH_LO)[1] > 0).sum()) for x in levels)
    t_bytes = K1_BYTES_PER_PIXEL * n_px / H100_BYTES_PER_S
    t_ops = (K1_OPS_PER_PIXEL * n_px + K1_OPS_PER_ARC * n_arc) / H100_SIMPLE_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes > t_ops else "operations",
            n_arc / n_px)


def time_k1(scene: Scene, device) -> dict:
    """K1 on the pyramid of a rendered main-path frame (8 levels x 2
    cameras): the pyramid launch, the eight one-level launches and level 0
    alone, device-only and per call, with the plain version, alternated
    plain, kernel, kernel, plain; every level alone and a launch over
    one-pixel levels, device-only; and the bounds from this data."""
    images = torch.as_tensor(scene.frames[1], device=device).to(torch.float32)
    pyr = [x.contiguous() for x in build_pyramid(
        images, _tables(H, W, scene.cfg.orb, device).resize)]

    def pyramid():
        return k1.fast_nms_levels(pyr, TH_HI, TH_LO)

    def eight():
        return [k1.fast_nms(x, TH_HI, TH_LO) for x in pyr]

    def level0():
        return k1.fast_nms(pyr[0], TH_HI, TH_LO)

    def plain():
        return [k1.fast_nms_reference(x, TH_HI, TH_LO) for x in pyr]

    def plain0():
        return k1.fast_nms_reference(pyr[0], TH_HI, TH_LO)

    r = {}
    p1, p01 = time_calls(plain, 5), time_calls(plain0, 10)
    # 30 calls at a time: on a slow host 50 calls of `eight` take longer
    # to queue than the sleep kernel runs
    for name, fn in (("pyramid", pyramid), ("eight", eight), ("level0", level0)):
        r[name + "_call_ms"] = (time_calls(fn, 30) + time_calls(fn, 30)) / 2
        r[name + "_device_ms"] = time_calls(fn, 30, device_only=True)
    r["plain_ms"] = (p1 + time_calls(plain, 5)) / 2
    r["plain0_ms"] = (p01 + time_calls(plain0, 10)) / 2
    r["level_device_ms"] = [
        time_calls(lambda x=x: k1.fast_nms(x, TH_HI, TH_LO), 30, device_only=True)
        for x in pyr]
    # what a launch costs before any work: 8 levels of one pixel
    tiny = [torch.zeros(2, 1, 1, device=device) for _ in pyr]
    r["floor_device_ms"] = time_calls(
        lambda: k1.fast_nms_levels(tiny, TH_HI, TH_LO), 30, device_only=True)
    r["bound_ms"], r["bound_by"], r["arc_share"] = k1_bound_ms(pyr)
    r["bound0_ms"], r["bound0_by"], r["arc_share0"] = k1_bound_ms(pyr[:1])
    r["shapes"] = [tuple(x.shape) for x in pyr]
    return r


def u8_renderer(world, rig):
    """T_cw -> the rig's u8 frames [ncam, H, W] of `world`."""
    K, T_sc = rig.K.cpu().numpy(), rig.T_sc.cpu().numpy()

    def render(T):
        return np.clip(np.round(synthetic.render_rig(world, K, T_sc, T, H=H, W=W)),
                       0, 255).astype(np.uint8)
    return render


def system_frames(cfg, device):
    """The rendered dual orbit of the system phase as u8 frames, its
    ground-truth poses and its path length."""
    rng = np.random.default_rng(42)
    world = synthetic.make_box_world(rng, half=6.0)
    # 3.2 deg and 8.4 cm per frame, however many frames
    poses = synthetic.orbit_trajectory(SYS_FRAMES, radius=1.5,
                                       total_angle=0.8 * math.pi * SYS_FRAMES / 45)
    render = u8_renderer(world, make_rig(cfg))
    frames = [render(T) for T in poses]
    centres = np.asarray([-T[:3, :3].T @ T[:3, 3] for T in poses])
    path = float(np.linalg.norm(np.diff(centres, axis=0), axis=1).sum())
    return frames, poses, centres, path


def require_card(sys_) -> None:
    if sys_.rig.K.device.type != "cuda":
        raise AssertionError(f"System() landed on {sys_.rig.K.device}")


def drive(sys_, frames, label: str, period_ms: float = 0.0, k0: int = 0):
    """System.track over `frames` (numbered from k0) on the current CUDA
    device, one K1 launch per call counted, each call timed between two
    synchronizations of the card.  With `period_ms`, frame k is not handed
    over before k * period_ms.  Returns the states, the ms per call and the
    number of tracker events after each call."""
    require_card(sys_)
    states, ms, n_events = [], [], []
    t_run = time.perf_counter()
    for k, img in enumerate(frames):
        time.sleep(max(0.0, t_run + 1e-3 * k * period_ms - time.perf_counter()))
        n0 = k1.fast_nms.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        states.append(sys_.track(img, (k0 + k) / 30.0))
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        n_events.append(len(sys_.tracker.events))
        if k1.fast_nms.launches != n0 + 1:
            raise AssertionError(
                f"{label}: frame {k0 + k} launched K1 "
                f"{k1.fast_nms.launches - n0} times, expected exactly 1")
    return states, ms, n_events


def span_ms(sys_, name: str) -> list:
    """Milliseconds of each of the system's spans named `name`, in order."""
    return [1e-6 * (s.t1_ns - s.t0_ns) for s in sys_.tracer.spans() if s.name == name]


def log_stage_timers(sys_, label: str, card: str) -> None:
    for who, timer in (("tracker", sys_.tracker.timer), ("mapper", sys_.mapper.timer)):
        log(f"  {label} ({card}) {who} stages (host wall clock):\n    " +
            timer.report().replace("\n", "\n    "))


def run_system(cfg, frames, centres, path, label: str, card: str,
               async_mapping: bool = False, gates: bool = True,
               period_ms: float = 0.0):
    """Drive System.track over `frames` on the current CUDA device, one K1
    launch per call counted, each call timed between two synchronizations
    of the card.  With `period_ms`, frame k is not handed over before
    k * period_ms (a camera's pace: frames fed back to back outrun the
    mapping thread, which then defers keyframes until the map starves).
    With `gates`, hold the run to the mono SLAM gates.  Returns the system
    and a dict of what was measured."""
    sys_ = System(cfg, voc=None, enable_loop_closing=False,
                  async_mapping=async_mapping)
    states, ms, _ = drive(sys_, frames, label, period_ms)
    sys_.shutdown()
    if async_mapping and sys_._mapper_thread.is_alive():
        raise AssertionError(f"{label}: the mapping thread did not stop")
    tr, mp = sys_.tracker, sys_.mapper
    traj = tr.composed_trajectory()
    est = metrics.trajectory_positions(traj)
    ate = metrics.ate_rmse(est, centres[[t[0] for t in traj]]) if len(traj) > 3 \
        else float("inf")
    first_ok = states.index("OK") if "OK" in states else len(states)
    tracked = ms[first_ok + 1:]
    n_lost = states.count("LOST")
    log(f"  {label} ({card}): states OK from frame {first_ok}, {n_lost} LOST, "
        f"{sys_.map.n_keyframes} keyframes, {sys_.map.n_points} map points, "
        f"{mp.n_triangulated} triangulated, {mp.n_fused} fused, "
        f"{mp.n_culled_kf} keyframes culled; fused frames {tr.n_fused_frames}, "
        f"host-stepped frames {tr.n_stepped_frames} "
        f"({tr.n_pose_opt_calls} match + pose stages); ATE {ate:.4f} m on a "
        f"{path:.3f} m path ({ate / path:.4f})")
    if tracked:
        pace = (f"frames handed over every {period_ms:.3f} ms, so this is the "
                f"call's latency, not a throughput: " if period_ms else "")
        log(f"  {label} ({card}): System.track over {len(tracked)} tracked frames: "
            f"{pace}{1e3 * len(tracked) / sum(tracked):.3f} calls/s back to back; "
            f"ms/call median "
            f"{np.median(tracked):.3f} (min {min(tracked):.3f}, max "
            f"{max(tracked):.3f}); two_view_init ms "
            f"{[round(ms, 3) for ms in span_ms(sys_, 'tracker.two_view')]}")
    log(f"  {label}: events {tr.events}")
    log_stage_timers(sys_, label, card)
    by_bucket = {}
    for s in sys_.tracer.spans():
        if s.name == "ba.solve":
            by_bucket.setdefault(s.attrs["shape"], []).append(1e-6 * (s.t1_ns - s.t0_ns))
    log(f"  {label} ({card}): local BA ms per call by (K, M, E) bucket: " +
        "; ".join(f"{shape}: n {len(v)}, median {np.median(v):.3f}"
                  for shape, v in sorted(by_bucket.items())))
    if async_mapping:
        # how much of the mapping thread's BA time ran while a track call
        # was in progress (both threads queue on one stream)
        spans = sys_.tracer.spans()
        ba_iv = [(s.t0_ns * 1e-9, s.t1_ns * 1e-9) for s in spans if s.name == "ba.solve"]
        fr_iv = [(s.t0_ns * 1e-9, s.t1_ns * 1e-9) for s in spans if s.name == "system.track"]
        both = sum(max(0.0, min(b1, f1) - max(b0, f0))
                   for b0, b1 in ba_iv for f0, f1 in fr_iv)
        ba_total = sum(b1 - b0 for b0, b1 in ba_iv)
        log(f"  {label} ({card}): local BA ran {ba_total:.3f} s in all, "
            f"{both:.3f} s of it ({both / max(ba_total, 1e-9):.4f}) while a "
            f"track call was in progress")
    if gates:
        problems = []
        if first_ok >= 15 or states[-1] != "OK":
            problems.append(f"OK first at frame {first_ok}, last {states[-1]}")
        if n_lost > 3:
            problems.append(f"{n_lost} LOST frames")
        if sys_.map.n_keyframes < 4 or sys_.map.n_points <= 150:
            problems.append(f"{sys_.map.n_keyframes} keyframes, "
                            f"{sys_.map.n_points} points")
        if mp.n_triangulated <= 50:
            problems.append(f"{mp.n_triangulated} triangulated")
        if tr.n_fused_frames < 1:
            problems.append("no frame took the fused path")
        if not ate < SYS_MAX_ATE_OF_PATH * path:
            problems.append(f"ATE {ate:.4f} m over {SYS_MAX_ATE_OF_PATH} of "
                            f"{path:.3f} m")
        if problems:
            raise AssertionError(f"{label}: " + "; ".join(problems))
    return sys_, {"states": states, "ms": tracked, "ate": ate, "est": est,
                  "fids": [t[0] for t in traj]}


def check_local_ba(sys_, card: str) -> None:
    """The last local BA of a run: it lowered its cost; then one chunk of
    solve_ba on the same problem with host synchronization made an error,
    and its time between CUDA events."""
    if sys_.mapper.last_ba is None:
        raise AssertionError("no local BA ran")
    prob, res = sys_.mapper.last_ba
    rig, cfg = sys_.rig, sys_.cfg
    args = (rig.T_sc, rig.adj_sc, rig.K)
    cost0 = float(ba.solve_ba(prob, *args, iters=0).cost)
    cost1 = float(res.cost)
    if not (math.isfinite(cost1) and cost1 < cost0):
        raise AssertionError(f"local BA did not lower its cost: {cost0} -> {cost1}")
    chunk = cfg.ba.abort_chunk
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ba.solve_ba(prob, *args, iters=chunk)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    t = time_events(lambda: ba.solve_ba(prob, *args, iters=chunk), 3)
    shape = (prob.poses.shape[0], prob.points.shape[0], prob.edges.kf.shape[0])
    log(f"  last local BA, bucket (K, M, E) = {shape}: cost {cost0:.3f} -> "
        f"{cost1:.3f}; one solve_ba chunk of {chunk} LM steps ran with no host "
        f"synchronization (sync debug mode: error); ms per chunk ({card}): "
        + ", ".join(f"{x:.3f}" for x in t))


def phase_system(device, card: str) -> int:
    """Phase 7.  Returns K1's launches over the synchronous run."""
    import dataclasses
    cfg = dual_default()
    t0 = time.perf_counter()
    frames, _, centres, path = system_frames(cfg, device)
    log(f"  rendered {len(frames)} frames 2x{H}x{W} in "
        f"{time.perf_counter() - t0:.1f} s; path {path:.3f} m")
    torch.cuda.synchronize()
    k1.fast_nms.launches = 0
    sync_sys, sync = run_system(cfg, frames, centres, path, "system, synchronous",
                                card)
    launches = k1.fast_nms.launches
    if launches != len(frames):
        raise AssertionError(f"K1 launched {launches} times over {len(frames)} "
                             f"System.track calls")
    check_local_ba(sync_sys, card)
    period = float(np.median(sync["ms"]))
    log(f"  async run paced at the synchronous run's median, {period:.3f} ms/frame")
    run_system(cfg, frames, centres, path, "system, async_mapping", card,
               async_mapping=True, period_ms=period)
    stepped_cfg = dataclasses.replace(
        cfg, tracker=dataclasses.replace(cfg.tracker, fused_tracking=False))
    st_sys, st = run_system(stepped_cfg, frames[:SYS_STEPPED_FRAMES], centres, path,
                            "system, host-stepped (fused_tracking=False)", card,
                            gates=False)
    tr = st_sys.tracker
    if st["states"][-1] != "OK" or tr.n_stepped_frames < SYS_STEPPED_FRAMES // 2 \
            or tr.n_fused_frames != 0:
        raise AssertionError(
            f"host-stepped run: last state {st['states'][-1]}, "
            f"{tr.n_stepped_frames} host-stepped and {tr.n_fused_frames} fused frames")
    log(f"  host-stepped run: {tr.n_pose_opt_calls} match + pose stages "
        f"(one optimize_pose each) over {tr.n_stepped_frames} frames: "
        f"{tr.n_pose_opt_calls / tr.n_stepped_frames:.2f} per frame (the fused "
        f"step makes 3)")
    return launches


def dual_config():
    """dual_default() with camera 1 DUAL_BASELINE_M behind camera 0 (facing
    backwards, as there) and the cross-camera schedule of the 82-frame
    walk; ORB, matcher, mapping, vocabulary and capacity settings
    unchanged."""
    import dataclasses
    cfg = dual_default()
    cam1 = dataclasses.replace(cfg.cameras[1], t_sc=(0.0, 0.0, DUAL_BASELINE_M))
    tracker = dataclasses.replace(cfg.tracker, reloc_gap_try=4, reloc_gap_fail=4,
                                  num_frame_in_secondmap=3)
    return dataclasses.replace(cfg, cameras=(cfg.cameras[0], cam1), tracker=tracker)


def dual_scene(cfg, device):
    """The box room (seed 3), the vocabulary trained on the card's own
    descriptors of 10 orbit frames (both cameras), and the rendered walk.
    Returns (voc, u8 frames, poses)."""
    world = synthetic.make_box_world(np.random.default_rng(3), half=6.0)
    rig = make_rig(cfg)
    render = u8_renderer(world, rig)
    extract = frontend.make_extract_fn(cfg, cfg.orb.n_track, None, rig)
    docs = []
    for T in synthetic.orbit_trajectory(10, radius=1.0):
        f = extract(torch.as_tensor(render(T), device=device)).feats
        desc, valid = desc_to_numpy(f.desc), f.valid.cpu().numpy()
        docs += [desc[c][valid[c]] for c in range(desc.shape[0])]
    t0 = time.perf_counter()
    voc = bow.train_vocabulary(np.concatenate(docs), branching=cfg.vocab.branching,
                               depth=cfg.vocab.depth, seed=9,
                               direct_level=cfg.vocab.direct_index_level,
                               weight_docs=docs)
    log(f"  vocabulary: k={voc.branching}, depth {voc.depth}, {voc.n_words} words, "
        f"trained on {sum(len(d) for d in docs)} descriptors of {len(docs)} images "
        f"in {time.perf_counter() - t0:.1f} s (host k-majority; not gated)")
    t0 = time.perf_counter()
    poses = synthetic.out_and_back_trajectory(*DUAL_WALK)
    frames = [render(T) for T in poses]
    log(f"  rendered {len(frames)} frames 2x{H}x{W} in {time.perf_counter() - t0:.1f} s")
    return voc, frames, poses


def keyframe_accuracy(m, poses):
    """(Umeyama scale, Sim3-aligned ATE, SE3-aligned ATE, span) of the
    keyframe centres of map `m` against the ground truth of their frames."""
    kfs = [m.keyframes[k] for k in sorted(m.keyframes)]
    est = np.asarray([kf.center() for kf in kfs])
    gt = np.asarray([-poses[kf.frame_id][:3, :3].T @ poses[kf.frame_id][:3, 3]
                     for kf in kfs])
    _, _, scale = metrics.align_umeyama(est, gt, with_scale=True)
    return (float(scale), float(metrics.ate_rmse(est, gt, with_scale=True)),
            float(metrics.ate_rmse(est, gt, with_scale=False)),
            float(np.linalg.norm(gt.max(0) - gt.min(0))))


_BOOT_EVENTS = ("XRELOC@", "XANCHOR@", "XLS@", "SCALED@", "XATTACH@", "XGAP@",
                "XWARP@", "XKF@", "ALPHA@", "FULL@", "MGBA@")


def run_dual(cfg, voc, frames, poses, label: str, card: str,
             async_mapping: bool = False, period_ms: float = 0.0,
             force_lost: bool = False):
    """Phase 8's run: the walk through System(cfg, voc).track under the
    integration gates; with `force_lost`, a forced loss where the walk
    ended (the frames it takes to recover there are reported), then a
    forced loss with the rig put back on the way out, where it has to
    relocalize by vocabulary within DUAL_RELOC_FRAMES frames.
    Returns the system and what was measured."""
    sys_ = System(cfg, voc=voc, enable_loop_closing=False,
                  async_mapping=async_mapping)
    tr = sys_.tracker
    states, ms, n_events = drive(sys_, frames, label, period_ms)
    # classes of calls: those in which the bootstrap machinery ran (an event
    # of it was logged), the others by the map's state
    scaled_at = next((k for k, n in enumerate(n_events)
                      if any(e.startswith("SCALED@") for e in tr.events[:n])),
                     len(frames))
    first_ok = states.index("OK") if "OK" in states else len(states)
    by_class = {"MONO": [], "bootstrap": [], "FULL": [], "other": []}
    for k in range(len(frames)):
        new = tr.events[n_events[k - 1] if k else 0:n_events[k]]
        if any(e.startswith(_BOOT_EVENTS) for e in new):
            by_class["bootstrap"].append(ms[k])
        elif states[k] == "FULL":
            by_class["FULL"].append(ms[k])
        elif states[k] == "OK" and first_ok < k < scaled_at:
            by_class["MONO"].append(ms[k])
        else:
            by_class["other"].append(ms[k])
    reloc_frames, n_after = None, 0
    if force_lost:
        # first where the walk ended: the rig stands still (reported, not
        # gated: there camera 0 faces what only camera 1 has mapped)
        sys_.set_compulsory_lost()
        st, ms_lost = [], []
        while len(st) < DUAL_INPLACE_FRAMES and (not st or st[-1] not in ("OK", "FULL")):
            s2, m2, _ = drive(sys_, frames[-1:], label + ", forced loss in place",
                              0.0, k0=len(frames) + len(st))
            st += s2
            ms_lost += m2
        n_after = len(st)
        found = st[-1] in ("OK", "FULL")
        log(f"  {label} ({card}): forced loss after frame {len(frames) - 1}, the rig "
            f"standing where the walk ended (reported, not gated): "
            f"{f'recovered at frame {len(st)} of the loss' if found else f'not recovered in {len(st)} frames'}"
            f"; states {st}, ms/call {[round(x, 3) for x in ms_lost]}, events "
            f"{[e for e in tr.events[n_events[-1]:] if not e.startswith('KF@')]}")
        n_ev = len(tr.events)
        if found:
            sys_.set_compulsory_lost()
        # then a kidnapped rig (the gate): back on the way out, where camera
        # 0 faces the wall it mapped first, so only the vocabulary can place it
        k_out = DUAL_WALK[0] - 2
        back = frames[k_out:k_out - DUAL_RELOC_FRAMES:-1]
        st, ms_lost = [], []
        while len(st) < len(back) and (not st or st[-1] not in ("OK", "FULL")):
            s2, m2, _ = drive(sys_, back[len(st):len(st) + 1], label + ", forced loss",
                              0.0, k0=len(frames) + n_after)
            st += s2
            ms_lost += m2
            n_after += 1
        reloc_frames = len(st) if st[-1] in ("OK", "FULL") else None
        log(f"  {label} ({card}): the rig put back at frames {k_out}, {k_out - 1}, ... "
            f"of the way out: states {st}, ms/call {[round(x, 3) for x in ms_lost]}, "
            f"events {[e for e in tr.events[n_ev:] if not e.startswith('KF@')]}")
    sys_.shutdown()
    if async_mapping and sys_._mapper_thread.is_alive():
        raise AssertionError(f"{label}: the mapping thread did not stop")
    ev, m, mp = tr.events, sys_.map, sys_.mapper
    scale, ate_sim3, ate_se3, span = keyframe_accuracy(sys_.map, poses)
    n_lost = states.count("LOST")
    n_cam1 = sum(1 for p in m.points.values() if any(c == 1 for c in p.obs_cam.values()))
    first = {name: next((int(e.split("@")[1].split()[0]) for e in ev
                         if e.startswith(name + "@")), None)
             for name in ("INIT", "XRELOC", "SCALED", "FULL", "MGBA")}
    log(f"  {label} ({card}): first INIT/XRELOC/SCALED/FULL/MGBA at frames "
        f"{[first[n] for n in ('INIT', 'XRELOC', 'SCALED', 'FULL', 'MGBA')]}; "
        f"{n_lost} LOST, last state {states[-1]}; {m.n_keyframes} keyframes, "
        f"{m.n_points} map points, {n_cam1} seen by camera 1, "
        f"{tr._count_cross_edges()} cross-camera edges, "
        f"{mp.n_cross_harvested} harvested by SearchCrossCameras, "
        f"{mp.n_triangulated} triangulated, {mp.n_fused} fused, {mp.n_culled_kf} "
        f"keyframes culled; fused frames {tr.n_fused_frames}, host-stepped "
        f"{tr.n_stepped_frames}")
    lo, hi = DUAL_SCALE_BAND
    log(f"  {label} ({card}): keyframe centres against ground truth: Umeyama scale "
        f"{scale:.4f} (reported band {lo}-{hi}: {'inside' if lo < scale < hi else 'OUTSIDE'}), "
        f"Sim3-aligned ATE {ate_sim3:.4f} m, SE3-aligned ATE {ate_se3:.4f} m on a span of "
        f"{span:.3f} m ({ate_se3 / span:.4f}; reported band < "
        f"{DUAL_SE3_ATE_BAND_OF_SPAN}: "
        f"{'inside' if ate_se3 < DUAL_SE3_ATE_BAND_OF_SPAN * span else 'OUTSIDE'})")
    pace = (f"frames handed over every {period_ms:.3f} ms, so these are latencies: "
            if period_ms else "")
    for name, v in by_class.items():
        if v:
            log(f"  {label} ({card}): {name} calls, n {len(v)}: {pace}ms/call median "
                f"{np.median(v):.3f} (min {min(v):.3f}, max {max(v):.3f}), "
                f"{1e3 * len(v) / sum(v):.3f} calls/s back to back")
    for name in ("SCALED@", "FULL@"):
        k = next((k for k in range(len(frames)) if any(
            e.startswith(name) for e in
            ev[n_events[k - 1] if k else 0:n_events[k]])), None)
        if k is not None:
            log(f"  {label} ({card}): the {name} call (frame {k}) took {ms[k]:.3f} ms")
    log(f"  {label}: events {[e for e in ev if not e.startswith('KF@')]}")
    log(f"  {label}: mapper events (last 12) {mp.events[-12:]}")
    log_stage_timers(sys_, label, card)
    problems = []
    if states[-1] not in ("OK", "FULL") or n_lost > DUAL_MAX_LOST:
        problems.append(f"last state {states[-1]}, {n_lost} LOST")
    for name in ("XRELOC", "SCALED", "FULL"):
        if first[name] is None:
            problems.append(f"no {name}@ event")
    if not m.map_scaled or m.first_scale_kid < 0:
        problems.append(f"map_scaled {m.map_scaled}, first_scale_kid {m.first_scale_kid}")
    if n_cam1 <= DUAL_MIN_CAM1_POINTS:
        problems.append(f"{n_cam1} map points seen by camera 1")
    if not ate_sim3 < DUAL_MAX_ATE_OF_SPAN * span:
        problems.append(f"Sim3-aligned ATE {ate_sim3:.4f} m of a span of {span:.3f} m")
    if not DUAL_SCALE_GATE[0] < scale < DUAL_SCALE_GATE[1]:
        problems.append(f"Umeyama scale {scale:.4f}")
    if force_lost and reloc_frames is None:
        problems.append(f"not relocalized within {DUAL_RELOC_FRAMES} frames of the "
                        f"forced loss")
    if problems:
        raise AssertionError(f"{label}: " + "; ".join(problems))
    return sys_, {"states": states, "ms": ms, "by_class": by_class,
                  "reloc_frames": reloc_frames, "calls_after_walk": n_after,
                  "first": first}


def dual_workloads(sys_):
    """The four solver calls of the bootstrap on the finished map's own
    data, as closures: one pnp_ransac (512 + 512 hypotheses) on the points
    of the keyframe with the most of them, the scale cost curve (129 x E)
    over the cross-camera edges, one 20-step pose graph over the essential
    graph, and their sizes."""
    m, rig, dev = sys_.map, sys_.rig, sys_.device
    N = sys_.cfg.orb.n_track
    kf = max(m.keyframes.values(), key=lambda k: int((k.mp_idx[:N] >= 0).sum()))
    rows = np.nonzero(kf.mp_idx[:N] >= 0)[0]
    X = torch.as_tensor(np.asarray([m.points[int(kf.mp_idx[r])].pos for r in rows],
                                   np.float32), device=dev)
    uv = torch.as_tensor(kf.uv[rows].astype(np.float32), device=dev)
    valid = torch.ones(len(rows), dtype=torch.bool, device=dev)
    gen = torch.Generator().manual_seed(0)

    def pnp():
        return ransac.pnp_ransac(gen, X, uv, valid, rig.K[0], n_hyp=512)

    # the essential graph as optimize_essential_graph builds it
    kids = sorted(m.keyframes)
    slot = {kid: i for i, kid in enumerate(kids)}
    pairs = set()
    for kid in kids:
        k = m.keyframes[kid]
        for other in ([k.parent] if k.parent >= 0 else []) + list(k.loop_edges) + \
                [n for n, w in k.covis.items() if w >= 100]:
            if other in slot and other != kid:
                pairs.add((min(kid, other), max(kid, other)))
    pairs = sorted(pairs)
    S0 = np.stack([m.keyframes[kid].T_cw for kid in kids]).astype(np.float32)
    e_i = np.asarray([slot[a] for a, _ in pairs], np.int64)
    e_j = np.asarray([slot[b] for _, b in pairs], np.int64)
    rng = np.random.default_rng(0)
    S_meas = np.stack([S0[i] @ np.linalg.inv(S0[j]) for i, j in zip(e_i, e_j)])
    # strain the graph as a frontier warp does: 2 cm of noise on each edge
    S_meas[:, :3, 3] += rng.normal(0, 0.02, (len(pairs), 3))
    fixed = np.zeros(len(kids), bool)
    fixed[0] = True
    pg_args = [torch.as_tensor(x, device=dev) for x in
               (S0, e_i, e_j, S_meas.astype(np.float32), np.ones(len(pairs), bool),
                fixed)]

    def graph():
        return pose_graph.optimize_pose_graph(*pg_args, iters=20)

    def scale():
        return scale_opt.optimal_map_scale(
            m, rig, sys_.tracker.scale_factors ** 2, alpha_lo=0.15, alpha_hi=8.0,
            n_grid=129)

    return {"pnp": pnp, "graph": graph, "scale": scale,
            "sizes": (len(rows), len(kids), len(pairs))}


def time_dual_solvers(sys_, card: str) -> None:
    """ms of one pnp_ransac, one scale solve, one pose graph and one metric
    global BA on the finished map of the synchronous run."""
    w = dual_workloads(sys_)
    n_pts, n_kf, n_edges = w["sizes"]
    w["pnp"]()
    w["graph"]()
    torch.cuda.synchronize()
    t_pnp = time_events(w["pnp"], 3)
    T, _, cnt, ok = w["pnp"]()
    log(f"  one pnp_ransac, 512 + 512 hypotheses over {n_pts} points (CUDA events; "
        f"the valid mask is read back once, the sets are drawn on the host and "
        f"uploaded) "
        f"({card}): ms " + ", ".join(f"{x:.3f}" for x in t_pnp) +
        f"; inliers {int(cnt)}, success {bool(ok)}")
    if not bool(ok):
        raise AssertionError("pnp_ransac failed on a keyframe's own map points")
    t_graph = time_events(w["graph"], 2)
    _, cost = w["graph"]()
    log(f"  one optimize_pose_graph, 20 LM x 32 PCG steps over {n_kf} nodes and "
        f"{n_edges} edges (CUDA events, no readback inside) ({card}): ms "
        + ", ".join(f"{x:.3f}" for x in t_graph) + f"; cost {float(cost):.6f}")
    if not math.isfinite(float(cost)):
        raise AssertionError("the pose graph's cost is not finite")
    t_scale = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = w["scale"]()
        t_scale.append(1e3 * (time.perf_counter() - t0))
    log(f"  one optimal_map_scale, 129 x {res[1] if res else 0} edges (host clock: "
        f"host packing, one upload, one readback) ({card}): ms "
        + ", ".join(f"{x:.3f}" for x in t_scale) + f"; alpha {res[0] if res else None}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sys_.tracker._metric_gba(iters=25)
    torch.cuda.synchronize()
    log(f"  one _metric_gba, 25 LM x 48 PCG steps over {n_kf} keyframes and "
        f"{sys_.map.n_points} points (host clock: packing, solve, readback, "
        f"unpacking) ({card}): ms {1e3 * (time.perf_counter() - t0):.3f}")


def phase_dual(device, card: str):
    """Phase 8.  Returns K1's launches over the synchronous walk and what
    phase 10 reuses: the vocabulary, the walk's frames and poses, and the
    synchronous run's ms per call."""
    cfg = dual_config()
    voc, frames, poses = dual_scene(cfg, device)
    torch.cuda.synchronize()
    k1.fast_nms.launches = 0
    sync_sys, sync = run_dual(cfg, voc, frames, poses, "dual, synchronous", card,
                              force_lost=True)
    launches = k1.fast_nms.launches
    n_calls = len(frames) + sync["calls_after_walk"]
    if launches != n_calls:
        raise AssertionError(f"K1 launched {launches} times over {n_calls} "
                             f"System.track calls")
    time_dual_solvers(sync_sys, card)
    period = float(np.median(sync["ms"]))
    log(f"  async run paced at the synchronous run's median, {period:.3f} ms/frame")
    run_dual(cfg, voc, frames, poses, "dual, async_mapping", card,
             async_mapping=True, period_ms=period)
    return launches, {"voc": voc, "frames": frames, "poses": poses,
                      "ms": sync["ms"]}


def loop_config():
    """Camera 0 of dual_default() alone, every other setting dual_default()'s."""
    import dataclasses
    cfg = dual_default()
    return dataclasses.replace(cfg, cameras=(cfg.cameras[0],))


def loop_scene(cfg, device):
    """The box room of tests/test_loop_closing.py (seed 7), the vocabulary
    trained on the card's own descriptors of 16 frames of the orbit, and the
    rendered 110-frame orbit.  Returns (voc, u8 frames, poses)."""
    world = synthetic.make_box_world(np.random.default_rng(7), half=6.0)
    rig = make_rig(cfg)
    render = u8_renderer(world, rig)
    extract = frontend.make_extract_fn(cfg, cfg.orb.n_track, None, rig)
    docs = []
    for T in synthetic.orbit_trajectory(16, radius=LOOP_RADIUS):
        f = extract(torch.as_tensor(render(T), device=device)).feats
        docs.append(desc_to_numpy(f.desc)[0][f.valid.cpu().numpy()[0]])
    t0 = time.perf_counter()
    voc = bow.train_vocabulary(np.concatenate(docs), branching=cfg.vocab.branching,
                               depth=cfg.vocab.depth, seed=5,
                               direct_level=cfg.vocab.direct_index_level,
                               weight_docs=docs)
    log(f"  vocabulary: k={voc.branching}, depth {voc.depth}, {voc.n_words} words, "
        f"trained on {sum(len(d) for d in docs)} descriptors of {len(docs)} images "
        f"in {time.perf_counter() - t0:.1f} s (host k-majority; not gated)")
    t0 = time.perf_counter()
    poses = synthetic.orbit_trajectory(LOOP_FRAMES, radius=LOOP_RADIUS,
                                       total_angle=LOOP_ANGLE)
    frames = [render(T) for T in poses]
    log(f"  rendered {len(frames)} frames 1x{H}x{W} in {time.perf_counter() - t0:.1f} s; "
        f"{math.degrees(LOOP_ANGLE / LOOP_FRAMES):.2f} deg and "
        f"{100 * LOOP_RADIUS * LOOP_ANGLE / LOOP_FRAMES:.2f} cm per frame")
    return voc, frames, poses


class LoopProbe:
    """Records, for each track call in which the closer corrected a loop,
    the frame, the keyframe ATE just before and just after the correction,
    the closer's stage times of that call and CUDA-event times of the Sim3
    RANSAC, the Sim3 optimizer and the pose graph.  The solvers are wrapped
    at the module attributes the closer calls; `close()` puts them back."""

    _TARGETS = ((ransac, "sim3_solve"), (sim3_opt, "optimize_sim3"),
                (pose_graph, "optimize_pose_graph"))

    def __init__(self, sys_, poses):
        self.sys_, self.poses = sys_, poses
        self.closings = []
        self.events = {name: [] for _, name in self._TARGETS}
        self._orig = [(mod, name, getattr(mod, name)) for mod, name in self._TARGETS]
        for mod, name, fn in self._orig:
            setattr(mod, name, self._timed(name, fn))
        lc = sys_.loop_closer
        self._on_kf, self._correct = lc.on_new_keyframe, lc._correct_loop
        lc.on_new_keyframe, lc._correct_loop = self._on_new_keyframe, self._correct_loop

    def _timed(self, name, fn):
        def run(*args, **kwargs):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            out = fn(*args, **kwargs)
            e1.record()
            self.events[name].append((e0, e1))
            return out
        return run

    def _correct_loop(self, kf, loop_kf, Scw, matched):
        before = keyframe_accuracy(self.sys_.map, self.poses)[1]
        self._correct(kf, loop_kf, Scw, matched)
        after = keyframe_accuracy(self.sys_.map, self.poses)[1]
        self.closings.append({"frame": kf.frame_id, "kid": kf.kid,
                              "loop_kid": loop_kf.kid, "ate_before": before,
                              "ate_after": after})

    def _on_new_keyframe(self, kf):
        lc = self.sys_.loop_closer
        mark = {k: len(v) for k, v in lc.timer.samples.items()}
        ev_mark = {k: len(v) for k, v in self.events.items()}
        log_mark = len(lc.debug_log)
        n0 = lc.n_loops_closed
        self._on_kf(kf)
        if lc.n_loops_closed > n0:
            torch.cuda.synchronize()
            c = self.closings[-1]
            c["stages_ms"] = {k: 1e3 * sum(v[mark.get(k, 0):])
                              for k, v in lc.timer.samples.items()
                              if len(v) > mark.get(k, 0)}
            c["events_ms"] = {k: [e0.elapsed_time(e1) for e0, e1 in v[ev_mark[k]:]]
                              for k, v in self.events.items()}
            c["log"] = lc.debug_log[log_mark:]

    def close(self):
        for mod, name, fn in self._orig:
            setattr(mod, name, fn)
        lc = self.sys_.loop_closer
        lc.on_new_keyframe, lc._correct_loop = self._on_kf, self._correct


def phase_loop(device, card: str):
    """Phase 9.  Returns K1's launches over the run and the system, whose
    final map phase 12 bundle-adjusts on a mesh."""
    cfg = loop_config()
    voc, frames, poses = loop_scene(cfg, device)
    sys_ = System(cfg, voc=voc, enable_loop_closing=True)
    probe = LoopProbe(sys_, poses)
    torch.cuda.synchronize()
    k1.fast_nms.launches = 0
    try:
        states, ms, n_events = drive(sys_, frames, "loop")
    finally:
        probe.close()
    launches = k1.fast_nms.launches
    sys_.shutdown()
    tr, m, lc = sys_.tracker, sys_.map, sys_.loop_closer
    traj = tr.composed_trajectory()
    est = metrics.trajectory_positions(traj)
    gt = np.asarray([-poses[f][:3, :3].T @ poses[f][:3, 3] for f, _, _ in traj])
    ate = float(metrics.ate_rmse(est, gt, with_scale=True)) if len(traj) > 3 \
        else float("inf")
    scale, kf_ate, _, span = keyframe_accuracy(sys_.map, poses) if m.n_keyframes > 3 \
        else (float("nan"),) * 4
    n_lost = states.count("LOST")
    finite = all(np.isfinite(p.pos).all() for p in m.points.values())
    closing = {c["frame"] for c in probe.closings}
    first_ok = states.index("OK") if "OK" in states else len(states)
    other = [t for k, t in enumerate(ms) if k > first_ok and k not in closing]
    log(f"  loop ({card}): {lc.n_loops_closed} loop(s) closed at frames "
        f"{[c['frame'] for c in probe.closings]} (keyframe {[c['kid'] for c in probe.closings]} "
        f"against {[c['loop_kid'] for c in probe.closings]}); {n_lost} LOST, last state "
        f"{states[-1]}; {m.n_keyframes} keyframes, {m.n_points} map points, "
        f"{lc.n_loop_fused} fused by the loop; composed-trajectory Sim3 ATE {ate:.4f} m, "
        f"keyframe Sim3 ATE {kf_ate:.4f} m on a span of {span:.3f} m, Umeyama scale "
        f"{scale:.4f}; map points finite: {finite}")
    if other:
        log(f"  loop ({card}): System.track over {len(other)} tracked calls without a "
            f"closing: ms/call median {np.median(other):.3f} (min {min(other):.3f}, max "
            f"{max(other):.3f})")
    for c in probe.closings:
        st, ev = c["stages_ms"], c["events_ms"]
        log(f"  loop ({card}): the closing call (frame {c['frame']}) took "
            f"{ms[c['frame']]:.3f} ms; keyframe Sim3 ATE {c['ate_before']:.4f} m just "
            f"before the correction, {c['ate_after']:.4f} m just after")
        log(f"  loop ({card}): its split (host clock, ms): " + ", ".join(
            f"{k} {v:.3f}" for k, v in sorted(st.items())) +
            "; CUDA events (ms): sim3_solve " + ", ".join(
                f"{x:.3f}" for x in ev["sim3_solve"]) + "; optimize_sim3 " +
            ", ".join(f"{x:.3f}" for x in ev["optimize_sim3"]) +
            f"; optimize_pose_graph ({cfg.ba.pose_graph_iters} LM x 32 PCG) " +
            ", ".join(f"{x:.3f}" for x in ev["optimize_pose_graph"]))
        log(f"  loop: the accepted loop's log: {c['log']}")
    log(f"  loop: closer stages over the run (host wall clock):\n    " +
        lc.timer.report().replace("\n", "\n    "))
    log(f"  loop: events {[e for e in tr.events if not e.startswith('KF@')]}")
    log_stage_timers(sys_, "loop", card)
    problems = []
    if lc.n_loops_closed < 1:
        problems.append(f"no loop closed; closer log {lc.debug_log[-8:]}")
    if states[-1] != "OK" or n_lost > LOOP_MAX_LOST:
        problems.append(f"last state {states[-1]}, {n_lost} LOST")
    if not ate < LOOP_MAX_ATE_M:
        problems.append(f"Sim3-aligned ATE {ate:.4f} m")
    if not finite:
        problems.append("a map point is not finite")
    if launches != len(frames):
        problems.append(f"K1 launched {launches} times over {len(frames)} track calls")
    if problems:
        raise AssertionError("loop: " + "; ".join(problems))
    return launches, sys_


def rig_yaml(cfg) -> str:
    """`cfg`'s rig in the original's settings format (Dual-LenaCV.yaml):
    intrinsics, distortion, quaternion and translation extrinsics, image
    size, fps, RGB and the ORB settings."""
    lines = ["%YAML:1.0", f"nCameras: {cfg.n_cameras}"]
    keys = ("fx", "fy", "cx", "cy", "k1", "k2", "p1", "p2", "k3", "qw", "qx", "qy",
            "qz", "tx", "ty", "tz")
    for c, cam in enumerate(cfg.cameras):
        values = (cam.fx, cam.fy, cam.cx, cam.cy, *cam.dist, *cam.q_sc, *cam.t_sc)
        lines += [f"Camera{c}.{k}: {v!r}" for k, v in zip(keys, values, strict=True)]
    cam = cfg.cameras[0]
    o = cfg.orb
    lines += [f"Camera.width: {cam.width}", f"Camera.height: {cam.height}",
              f"Camera.fps: {cfg.fps!r}", f"Camera.RGB: {int(cfg.rgb)}",
              f"ORBextractor.nFeatures: {o.n_features}",
              f"ORBextractor.scaleFactor: {o.scale_factor!r}",
              f"ORBextractor.nLevels: {o.n_levels}",
              f"ORBextractor.iniThFAST: {o.ini_th_fast}",
              f"ORBextractor.minThFAST: {o.min_th_fast}"]
    return "\n".join(lines) + "\n"


def yaml_fields(cfg) -> dict:
    """What a settings file carries of a config."""
    o = cfg.orb
    return {"cameras": [(c.fx, c.fy, c.cx, c.cy, tuple(c.dist), tuple(c.q_sc),
                         tuple(c.t_sc), c.width, c.height) for c in cfg.cameras],
            "fps": cfg.fps, "rgb": cfg.rgb,
            "orb": (o.n_features, o.scale_factor, o.n_levels, o.ini_th_fast,
                    o.min_th_fast)}


def write_joint_video(frames, path: str) -> None:
    """u8 rig frames [2, H, W] -> one side-by-side MJPG video, the original's
    joint input (dual_slam_video.cpp:68-86)."""
    import cv2

    ncam, h, w = frames[0].shape
    wr = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 30, (ncam * w, h))
    if not wr.isOpened():
        raise AssertionError(f"cv2 cannot write an MJPG video to {path}")
    for f in frames:
        wr.write(cv2.cvtColor(np.concatenate(list(f), axis=1), cv2.COLOR_GRAY2BGR))
    wr.release()


def frame_lines(path) -> list:
    return [ln.split() for ln in path.read_text().strip().splitlines() if ln.strip()]


def check_reload(out, cfg, voc, poses, label: str, card: str) -> dict:
    """The run's map.npz against its text artifacts, the keyframe database
    rebuilt from it, and the cloud tools on its points.  Returns the card's
    and the CPU's fit_planes ms."""
    from orbslam2_dualcam_tpu_torch import tools
    from orbslam2_dualcam_tpu_torch.models.kfdb import KeyFrameDatabase
    from orbslam2_dualcam_tpu_torch.utils import checkpoint

    problems = []
    m = checkpoint.load_map(str(out / "map.npz"))
    klines, plines = frame_lines(out / "KeyFramePoseTcw.txt"), frame_lines(out / "MapPoint.txt")
    if (len(klines), len(plines)) != (m.n_keyframes, m.n_points):
        problems.append(f"map.npz holds {m.n_keyframes} keyframes and {m.n_points} "
                        f"points, the text files {len(klines)} and {len(plines)}")
    else:
        P = np.asarray([m.points[int(r[3])].pos for r in plines], np.float64)
        d_pts = float(np.abs(P - np.asarray([r[:3] for r in plines], np.float64)).max())
        d_kfs = max(float(np.abs(
            np.asarray(System._pose_line(m.keyframes[int(r[7])].T_cw).split(), np.float64)
            - np.asarray(r[:7], np.float64)).max()) for r in klines)
        if not (d_pts <= 1e-6 and d_kfs <= 1e-6):
            problems.append(f"restored points differ from MapPoint.txt by {d_pts:.3g}, "
                            f"keyframe poses from KeyFramePoseTcw.txt by {d_kfs:.3g}")
        log(f"  {label}: map.npz restored: {m.n_keyframes} keyframes, {m.n_points} "
            f"points; largest difference from MapPoint.txt {d_pts:.3g}, from "
            f"KeyFramePoseTcw.txt {d_kfs:.3g} (printed to 7 decimals)")
    db = KeyFrameDatabase(cfg.n_cameras, voc.n_words)
    t0 = time.perf_counter()
    checkpoint.rebuild_kfdb(m, db, voc, cfg.n_cameras)
    t_db = 1e3 * (time.perf_counter() - t0)
    n_q, missed = 0, []
    for kid in sorted(m.keyframes):
        for c in range(cfg.n_cameras):
            q = db.bow[c].get(kid)
            if q is None:
                continue
            n_q += 1
            if kid not in db.detect_reloc_candidates(q.words.astype(np.int64), q, c, c, m):
                missed.append((kid, c))
    log(f"  {label}: rebuild_kfdb on the card's vocabulary ({voc.n_words} words) in "
        f"{t_db:.3f} ms; {n_q} keyframe cameras queried with their own BoW vector, "
        f"{n_q - len(missed)} found themselves among the candidates")
    if n_q == 0 or missed:
        problems.append(f"rebuild_kfdb: {n_q} queries, missed {missed[:8]}")
    ply = out / "cloud.ply"
    tools.main(["convert", str(out / "MapPoint.txt"), str(ply), "--voxel", "0.05"])
    n_ply = int(next(ln for ln in ply.read_text().splitlines()
                     if ln.startswith("element vertex")).split()[-1])
    pts = tools.load_points_txt(str(out / "MapPoint.txt"))
    if not 0 < n_ply <= len(pts):
        problems.append(f"convert wrote {n_ply} vertices of {len(pts)} points")
    tools.fit_planes(pts, device="cuda")          # warm: first launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    on_card = tools.fit_planes(pts)
    torch.cuda.synchronize()
    t_card = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    on_cpu = tools.fit_planes(pts, device="cpu")
    t_cpu = 1e3 * (time.perf_counter() - t0)
    diffs = []
    for (n1, d1, i1), (n2, d2, i2) in zip(on_card, on_cpu):
        sgn = float(np.sign(n1 @ n2)) or 1.0
        diffs.append((float(np.abs(n1 - sgn * n2).max()), abs(len(i1) - len(i2))))
    log(f"  {label} ({card}): convert --voxel 0.05 kept {n_ply} of {len(pts)} points; "
        f"fit_planes (4 planes, 512 hypotheses a round, dist 0.05) on the card "
        f"{t_card:.3f} ms, on the CPU {t_cpu:.3f} ms (host clock, the SVD refits on "
        f"the host in both); planes {len(on_card)} and {len(on_cpu)}, inliers "
        f"{[len(p[2]) for p in on_card]} and {[len(p[2]) for p in on_cpu]}, largest "
        f"normal difference {max([d[0] for d in diffs], default=0.0):.3g}")
    if not on_card or len(on_card) != len(on_cpu) or \
            any(dn > 1e-3 or di > 1 for dn, di in diffs):
        problems.append(f"fit_planes: card {[(p[0].round(4).tolist(), len(p[2])) for p in on_card]}, "
                        f"CPU {[(p[0].round(4).tolist(), len(p[2])) for p in on_cpu]}")
    if problems:
        raise AssertionError(f"{label}: " + "; ".join(problems))
    return {"fit_planes_ms": t_card, "fit_planes_cpu_ms": t_cpu}


def phase_run(device, card: str, dual: dict | None = None) -> dict:
    """Phase 10: the user's run path.  A settings file for phase 8's rig,
    phase 8's vocabulary saved as .npz and the first RUN_FRAMES frames of
    its walk as one joint MJPG video, then (a) the CLI as a user runs it,
    `python3 -m orbslam2_dualcam_tpu_torch.run`, in a child process, and (b)
    the same video through the CLI's own pieces in this process (the YAML
    loader, the .npz reader, System, the decode and run.track_stream, the
    artifact writers), where K1's launches are counted and each track call
    timed.  Both runs' artifacts are gated; the child's map is restored and
    its database rebuilt, and the cloud tools run on its points.  Without
    `dual` (phase 10 alone) the vocabulary and the walk are made here as
    phase 8 makes them.  Returns K1's launches over the counted run and
    what was measured."""
    import pathlib
    import tempfile

    import cv2

    from orbslam2_dualcam_tpu_torch import run
    from orbslam2_dualcam_tpu_torch.utils import checkpoint
    from orbslam2_dualcam_tpu_torch.utils.yaml_config import load_rig_yaml

    want = dual_config()
    if dual is None:
        voc, frames, poses = dual_scene(want, device)
        dual = {"voc": voc, "frames": frames, "poses": poses, "ms": None}
    frames, poses = dual["frames"][:RUN_FRAMES], dual["poses"]
    problems = []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_run_") as tmp:
        tmp = pathlib.Path(tmp)
        settings, vocab, video = tmp / "rig.yaml", tmp / "voc.npz", tmp / "walk.avi"
        settings.write_text(rig_yaml(want))
        cfg = load_rig_yaml(str(settings))
        if yaml_fields(cfg) != yaml_fields(want):
            raise AssertionError(f"load_rig_yaml: {yaml_fields(cfg)} != {yaml_fields(want)}")
        bow.save_vocabulary(dual["voc"], str(vocab))
        t0 = time.perf_counter()
        write_joint_video(frames, str(video))
        log(f"  run path: settings file of phase 8's rig read back equal in every "
            f"field it carries (the rest is SystemConfig's defaults, so the cross-"
            f"camera schedule is the original's 30 / 50 / 5); vocabulary "
            f"{vocab.stat().st_size} B; {len(frames)} joint {H}x{2 * W} frames to MJPG "
            f"({video.stat().st_size} B) in {time.perf_counter() - t0:.1f} s")

        # (a) the CLI in a child process, as a user runs it
        out_cli = tmp / "out_cli"
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "orbslam2_dualcam_tpu_torch.run", "--settings",
             str(settings), "--video", str(video), "--vocab", str(vocab), "--out",
             str(out_cli), "--max-frames", str(RUN_FRAMES)],
            capture_output=True, text=True, timeout=RUN_CLI_TIMEOUT_S,
            cwd=pathlib.Path(__file__).resolve().parent)
        t_cli = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"the run CLI exited {proc.returncode}:\n"
                                 f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        log(f"  run CLI ({card}): exit 0 in {t_cli:.1f} s (interpreter start, "
            f"kernel library load, {RUN_FRAMES} frames, artifacts); its output: "
            + " | ".join(proc.stdout.strip().splitlines()[-3:]))
        if f"{RUN_FRAMES} frames; artifacts in" not in proc.stdout:
            problems.append(f"the CLI did not report {RUN_FRAMES} frames")

        # (b) the same video through the CLI's pieces, counted and timed
        out_run = tmp / "out_run"
        voc = bow.load_vocabulary(str(vocab))
        sys_ = System(cfg, voc=voc)
        require_card(sys_)
        cap = cv2.VideoCapture(str(video))
        torch.cuda.synchronize()
        k1.fast_nms.launches = 0
        n = run.track_stream(sys_, run.video_frames(cap), cfg.n_cameras, cfg.fps,
                             RUN_FRAMES)
        torch.cuda.synchronize()
        launches = k1.fast_nms.launches
        cap.release()
        sys_.shutdown()
        run.write_artifacts(sys_, str(out_run))
        ms = span_ms(sys_, "system.track")
        if launches != n or n != RUN_FRAMES:
            problems.append(f"K1 launched {launches} times over {n} track calls "
                            f"({RUN_FRAMES} frames)")
        for out, label in ((out_cli, "run CLI"), (out_run, "run in process")):
            missing = [f for f in ("FramePoseTcw.txt", "KeyFramePoseTcw.txt",
                                   "MapPoint.txt", "map.npz") if not (out / f).exists()]
            if missing:
                raise AssertionError(f"{label}: no {missing}")
            rows = frame_lines(out / "FramePoseTcw.txt")
            fids = [int(r[7]) for r in rows]
            m = checkpoint.load_map(str(out / "map.npz"))
            _, ate, _, span = keyframe_accuracy(m, poses) if m.n_keyframes > 3 \
                else (float("nan"), float("inf"), float("nan"), 1.0)
            log(f"  {label} ({card}): {len(rows)} frame lines (frames {fids[0] if fids else None}"
                f"-{fids[-1] if fids else None}), {m.n_keyframes} keyframes, "
                f"{m.n_points} points; keyframe Sim3 ATE {ate:.4f} m on a span of "
                f"{span:.3f} m ({ate / span:.4f}; phase 8's band < {DUAL_MAX_ATE_OF_SPAN})")
            if fids != sorted(set(fids)) or not fids or fids[-1] >= RUN_FRAMES or \
                    len(fids) < RUN_FRAMES - 5:
                problems.append(f"{label}: frame lines {fids}")
            if not ate < DUAL_MAX_ATE_OF_SPAN * span:
                problems.append(f"{label}: keyframe Sim3 ATE {ate:.4f} m of a span of "
                                f"{span:.3f} m")
        traj = [t[0] for t in sys_.tracker.trajectory]
        if [int(r[7]) for r in frame_lines(out_run / "FramePoseTcw.txt")] != traj:
            problems.append("run in process: FramePoseTcw.txt is not one line per "
                            "tracked frame")
        tracked = [t for k, t in enumerate(ms) if k >= 3]
        p8 = dual["ms"][3:RUN_FRAMES] if dual["ms"] else [float("nan")]
        log(f"  run in process ({card}): System.track over the decoded video, "
            f"ms/call (host clock of the system.track spans) median "
            f"{np.median(tracked):.3f} (min {min(tracked):.3f}, max {max(tracked):.3f}) "
            f"over calls 3-{RUN_FRAMES - 1}; phase 8's synchronous walk over the same "
            f"frames (host clock between synchronizations) median {np.median(p8):.3f} "
            f"(min {min(p8):.3f}, max {max(p8):.3f}); last state "
            f"{sys_.tracker.state}; events "
            f"{[e for e in sys_.tracker.events if not e.startswith('KF@')][:12]}")
        if problems:
            raise AssertionError("run path: " + "; ".join(problems))
        tools_ms = check_reload(out_cli, cfg, voc, poses, "run CLI's map", card)
    return {"launches": launches, "ms": tracked, "cli_s": t_cli, **tools_ms}


# ---------------------------------------------------------------------------
# phase 11: the deployment configuration
# ---------------------------------------------------------------------------

def deployment_scene(device):
    """bench.py's bench_end_to_end scene: the box room and the 90-frame orbit
    of rng(1), the vocabulary (branching 8, depth 3, seed 7) trained on the
    20,000 random descriptors that rng draws next, and dual_default() with
    u8 frames (pipeline_depth is 3 there).  The frames are rendered untimed,
    as u8.  Returns (cfg, voc, frames, poses)."""
    import dataclasses
    cfg = dual_default()
    cfg = dataclasses.replace(cfg, tracker=dataclasses.replace(cfg.tracker,
                                                               images_u8=True))
    rng = np.random.default_rng(1)
    # the reference's make_box_world ignores bench.py's n_points=6000
    world = synthetic.make_box_world(rng, half=6.0)
    poses = synthetic.orbit_trajectory(DEPLOY_FRAMES, radius=1.5,
                                       total_angle=1.2 * math.pi)
    t0 = time.perf_counter()
    voc = bow.train_vocabulary(
        rng.integers(0, 2 ** 32, (20000, 8), dtype=np.uint32),
        branching=8, depth=3, seed=7, device=device)
    log(f"  vocabulary: k=8, depth 3, {voc.n_words} words, trained on 20000 random "
        f"descriptors in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    render = u8_renderer(world, make_rig(cfg))
    frames = [render(T) for T in poses]
    log(f"  rendered {len(frames)} frames 2x{H}x{W} (u8) in "
        f"{time.perf_counter() - t0:.1f} s; pipeline_depth "
        f"{cfg.tracker.pipeline_depth}, images_u8 {cfg.tracker.images_u8}")
    return cfg, voc, frames, poses


def run_deployment(cfg, voc, frames, poses, label: str, card: str, deferred: bool,
                   async_mapping: bool, gate_kinds: tuple = ()) -> dict:
    """System(cfg, voc, enable_loop_closing=False) over `frames`, each
    track call timed on the host clock with no synchronization of the card
    around it (bench.py's timing: a deferred call that only buffers a frame
    takes well under a millisecond, the call that dispatches a batch pays
    for it), then shutdown() (which flushes the pipeline).  K1 is counted
    from 0 over the run.  With `gate_kinds`, tests/test_deferred.py's
    gates: no event of those kinds, at most DEPLOY_MAX_MISSING frames
    missing from the trajectory, ATE under DEPLOY_MAX_ATE_M."""
    sys_ = System(cfg, voc=voc, enable_loop_closing=False,
                  async_mapping=async_mapping, deferred_tracking=deferred)
    require_card(sys_)
    tr = sys_.tracker
    if tr.deferred != deferred:
        raise AssertionError(f"{label}: tracker.deferred is {tr.deferred}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    k1.fast_nms.launches = 0
    states, ms = [], []
    for k, img in enumerate(frames):
        t0 = time.perf_counter()
        states.append(sys_.track(img, k / 30.0))
        ms.append(1e3 * (time.perf_counter() - t0))
    t0 = time.perf_counter()
    sys_.shutdown()
    torch.cuda.synchronize()
    shutdown_ms = 1e3 * (time.perf_counter() - t0)
    launches = k1.fast_nms.launches
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    if async_mapping and sys_._mapper_thread.is_alive():
        raise AssertionError(f"{label}: the mapping thread did not stop")
    est = {fid: T for fid, _, _, _, T in tr.trajectory}
    common = sorted(set(est) & set(range(len(frames))))
    if len(common) > 3:
        E = np.stack([np.linalg.inv(est[i])[:3, 3] for i in common])
        G = np.stack([np.linalg.inv(poses[i])[:3, 3] for i in common])
        ate = float(metrics.ate_rmse(E, G))
    else:
        ate = float("inf")
    warm = min(DEPLOY_WARMUP, len(ms) - 6)
    tail = np.asarray(ms[warm:])
    stages = {k: float(np.median(v[warm // 2:])) * 1e3
              for k, v in tr.timer.samples.items() if len(v) > warm // 2}
    n_disp, n_get = (len(tr.timer.samples.get(k, ())) for k in
                     ("fused_dispatch", "fused_get"))
    n_kind = {k: sum(e.startswith(k) for e in tr.events)
              for k in ("DROPFRAME@", "THIN@", "RESCUE@", "LOST@")}
    bad = [e for e in tr.events if gate_kinds and e.startswith(gate_kinds)]
    r = {"mean": float(tail.mean()), "p90": float(np.percentile(tail, 90)),
         "median": float(np.median(tail)), "frames": len(tail), "warm": warm,
         "ate": ate, "n_traj": len(common), "launches": launches,
         "dispatches": n_disp, "gets": n_get, "peak": peak,
         "shutdown_ms": shutdown_ms, "events": n_kind}
    log(f"  {label} ({card}): ms per track call over calls {warm}-{len(ms) - 1} "
        f"(host clock, no synchronization): mean {r['mean']:.3f}, p90 {r['p90']:.3f}, "
        f"median {r['median']:.3f}, fps from the mean {1e3 / r['mean']:.3f}; "
        f"shutdown (flush) {shutdown_ms:.3f} ms")
    log(f"  {label}: trajectory {len(common)} of {len(frames)} frames, Sim3 ATE "
        f"{ate:.4f} m; K1 launches {launches} over {len(frames)} track calls "
        f"({launches / len(frames):g} per call); {n_disp} deferred dispatches, "
        f"{n_get} fused_get waits; events by kind {n_kind}; peak device memory "
        f"{peak:.0f} MiB; last state {states[-1]}")
    log(f"  {label}: events {[e for e in tr.events if not e.startswith('KF@')]}")
    log(f"  {label} ({card}): stage medians, ms (bench.py's "
        f"e2e_stage_ms_per_frame): " +
        ", ".join(f"{k} {v:.3f}" for k, v in sorted(stages.items())))
    log_stage_timers(sys_, label, card)
    problems = []
    if launches != len(frames):
        problems.append(f"K1 launched {launches} times over {len(frames)} track calls")
    if deferred and n_get != n_disp:
        problems.append(f"{n_get} fused_get waits for {n_disp} dispatches")
    if gate_kinds:
        if bad:
            problems.append(f"events {bad[:10]}")
        if len(common) < len(frames) - DEPLOY_MAX_MISSING:
            problems.append(f"trajectory covers {len(common)} frames")
        if not ate < DEPLOY_MAX_ATE_M:
            problems.append(f"ATE {ate:.4f} m")
        if n_disp < 1:
            problems.append("no deferred dispatch")
    if problems:
        raise AssertionError(f"{label}: " + "; ".join(problems))
    return r


def check_readback(device) -> dict:
    """utils.device.Readback on the card: its wait() returns while a sleep
    kernel queued after it still runs (it waits on its own event, not on
    the stream), with the values read back; and a Python thread keeps
    running during the wait (the wait releases the interpreter lock)."""
    x = torch.arange(4096, dtype=torch.float32, device=device)
    want = (x * 3).cpu().numpy()
    y = x * 3
    torch.cuda._sleep(int(2e8))              # runs before the copies
    rb = Readback([y])
    torch.cuda._sleep(int(1e9))              # queued after the readback
    count, stop = [0], [False]

    def spin():
        while not stop[0]:
            count[0] += 1

    th = threading.Thread(target=spin, daemon=True)
    th.start()
    time.sleep(0.002)
    c0, t0 = count[0], time.perf_counter()
    got = rb.wait()[0]
    wait_ms = 1e3 * (time.perf_counter() - t0)
    c1 = count[0]
    busy = not torch.cuda.current_stream(device).query()
    stop[0] = True
    th.join()
    torch.cuda.synchronize()
    r = {"wait_ms": wait_ms, "spins": c1 - c0, "stream_busy": busy}
    if not np.array_equal(got, want):
        raise AssertionError("Readback: wrong values")
    if not busy:
        raise AssertionError("Readback.wait() waited for work queued after it")
    if c1 - c0 < 1000:
        raise AssertionError(f"Readback.wait() held the interpreter lock: a thread "
                             f"counted {c1 - c0} during its {wait_ms:.3f} ms")
    return r


def phase_deployment(device, card: str) -> dict:
    """Phase 11: bench.py's bench_end_to_end in the port.  The deployment
    configuration (deferred batched tracking at pipeline_depth 3 with the
    mapper on its own thread) over the 90 frames, gated as
    tests/test_deferred.py gates that mode (no DROPFRAME@ or LOST@, the
    trajectory, the ATE; THIN@ counted); the same pipeline with
    synchronous mapping over the first 45 frames, gated as that file gates
    the deferred mode alone (no THIN@ either); the same frames synchronously (no deferral, no
    mapping thread) for the mean and the ATE; lag 1 (pipeline_depth 1,
    async) over the first 30 frames.  Returns the deployment run's
    numbers."""
    import dataclasses
    rb = check_readback(device)
    log(f"  Readback ({card}): wait() returned after {rb['wait_ms']:.3f} ms with a "
        f"sleep kernel queued after it still running; a Python thread counted "
        f"{rb['spins']} during the wait (the event wait releases the interpreter lock)")
    cfg, voc, frames, poses = deployment_scene(device)
    dep = run_deployment(cfg, voc, frames, poses, "deployment (deferred, depth 3, "
                         "async_mapping)", card, deferred=True, async_mapping=True,
                         gate_kinds=("DROPFRAME@", "LOST@"))
    n = DEPLOY_SYNCMAP_FRAMES
    alone = run_deployment(cfg, voc, frames[:n], poses[:n], f"deferred, depth 3, "
                           f"synchronous mapping, first {n} frames", card,
                           deferred=True, async_mapping=False,
                           gate_kinds=("DROPFRAME@", "THIN@", "LOST@"))
    sync = run_deployment(cfg, voc, frames, poses, "same frames, synchronous", card,
                          deferred=False, async_mapping=False)
    lag1_cfg = dataclasses.replace(cfg, tracker=dataclasses.replace(
        cfg.tracker, pipeline_depth=1))
    lag1 = run_deployment(lag1_cfg, voc, frames[:DEPLOY_LAG1_FRAMES],
                          poses[:DEPLOY_LAG1_FRAMES], "lag 1 (pipeline_depth 1, "
                          "async_mapping), first 30 frames", card, deferred=True,
                          async_mapping=True)
    log(f"  deployment ({card}): mean {dep['mean']:.3f} ms/call "
        f"({1e3 / dep['mean']:.3f} fps), p90 {dep['p90']:.3f}, ATE {dep['ate']:.4f} m, "
        f"THIN@ {dep['events']['THIN@']}; deferred with synchronous mapping: mean "
        f"{alone['mean']:.3f} ms/call over calls {alone['warm']}-{n - 1}, ATE "
        f"{alone['ate']:.4f} m; synchronous over the "
        f"same calls: mean {sync['mean']:.3f} ms/call ({1e3 / sync['mean']:.3f} fps), "
        f"ATE {sync['ate']:.4f} m; deployment / synchronous "
        f"{dep['mean'] / sync['mean']:.4f}; lag 1 over calls {lag1['warm']}-"
        f"{DEPLOY_LAG1_FRAMES - 1}: mean {lag1['mean']:.3f} ms/call")
    dep["alone"], dep["sync"], dep["lag1"], dep["readback"] = alone, sync, lag1, rb
    return dep


# ---------------------------------------------------------------------------
# phase 12: distributed bundle adjustment
# ---------------------------------------------------------------------------

def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def dist_problem(device, n_kf: int = DIST_KF, n_mp: int = DIST_MP):
    """bench_dist_ba's problem (seed 0) on `device`, with the rig of its
    observations."""
    prob = bench_dist_ba.make_problem(np.random.default_rng(0), n_kf, n_mp,
                                      DIST_OBS, device=device)
    return prob, bench_dist_ba.problem_rig(device)


def as_f64(prob, rig):
    def f(x):
        return x.double() if x.is_floating_point() else x
    return (ba.BAProblem(*(type(x)(*map(f, x)) if isinstance(x, tuple) else f(x)
                           for x in prob)), type(rig)(*map(f, rig)))


def max_err(a, b) -> float:
    return float((a - b).abs().max())


def dist_case(res, single, E: int) -> dict:
    """How far a distributed solve lies from the single-device one."""
    return {"cost_rel": abs(float(res.cost) / float(single.cost) - 1),
            "poses": max_err(res.poses, single.poses),
            "points": max_err(res.points, single.points),
            "chi2": float(((res.edge_chi2 - single.edge_chi2).abs() /
                           (1e-2 + 1e-3 * single.edge_chi2.abs())).max()),
            "shape_ok": tuple(res.edge_chi2.shape) == (E,)}


def check_dist_solves(device, card: str, n_kf: int = DIST_KF,
                      n_mp: int = DIST_MP) -> dict:
    """(a) bench_dist_ba's problem solved by ba.solve_ba and by
    solve_ba_distributed on virtual meshes of DIST_SHARDS shards of
    `device` in both layouts, with ms per LM iteration of each (float32).

    The check of the math is made in float64, where the solves differ only
    by rounding: each distributed solve is held to the single-device one at
    tests/test_dist_ba.py's bands (cost rtol 1e-3, poses atol 5e-4, points
    atol 5e-3) with its per-edge chi2 row by row in the caller's order
    (atol 1e-2 + rtol 1e-3).  In float32 this problem's solve moves with the
    order of its sums (points seen once or twice, an LM that has not
    converged in 10 steps): the single-device solve on a permutation of its
    edge rows already lies outside those bands, so the float32 distributed
    solves are printed beside that baseline and a second single-device run
    (the card's sums are float atomics), not gated."""
    prob, rig = dist_problem(device, n_kf, n_mp)
    E = int(prob.edges.kf.shape[0])
    p64, r64 = as_f64(prob, rig)
    args32 = (prob, rig.T_sc, rig.adj_sc, rig.K)
    args64 = (p64, r64.T_sc, r64.adj_sc, r64.K)
    single = ba.solve_ba(*args32, iters=DIST_ITERS)
    single64 = ba.solve_ba(*args64, iters=DIST_ITERS)
    perm = torch.as_tensor(np.random.default_rng(5).permutation(E), device=device)
    permuted = ba.solve_ba(prob._replace(edges=type(prob.edges)(
        *(f[perm] for f in prob.edges))), *args32[1:], iters=DIST_ITERS)
    again = ba.solve_ba(*args32, iters=DIST_ITERS)
    base = {"permuted edges": dist_case(permuted, single, E),
            "second run": dist_case(again, single, E)}
    t_single = bench_dist_ba.ms_per_iter(
        bench_dist_ba.solver(prob, rig, device, 0, ""), DIST_ITERS, device)
    log(f"  (a) bench_dist_ba's problem K={n_kf} M={n_mp} E={E} on {device}, "
        f"{DIST_ITERS} LM iterations: ba.solve_ba float32 cost "
        f"{float(single.cost):.9g} (float64 {float(single64.cost):.9g}), "
        f"{t_single:.3f} ms per LM iteration; float32 single-device baselines: " +
        "; ".join(f"{k}: cost rel {v['cost_rel']:.3g}, max |dpose| {v['poses']:.3g}, "
                  f"max |dpoint| {v['points']:.3g}" for k, v in base.items()) +
        f" ({card})")
    out = {"E": E, "single_ms": t_single, "single_cost": float(single.cost),
           "baselines": base, "cases": []}
    problems = []
    for n in DIST_SHARDS:
        for layout in bench_dist_ba.LAYOUTS:
            sharded = layout == "sharded"
            mesh = Mesh((device,) * n)
            c64 = dist_case(dist_ba.solve_ba_distributed(
                *args64, mesh, iters=DIST_ITERS, shard_points=sharded), single64, E)
            res = dist_ba.solve_ba_distributed(*args32, mesh, iters=DIST_ITERS,
                                               shard_points=sharded)
            c = dict(dist_case(res, single, E), shards=n, layout=layout,
                     cost=float(res.cost), f64=c64)
            c["ms"] = bench_dist_ba.ms_per_iter(
                bench_dist_ba.solver(prob, rig, device, n, layout), DIST_ITERS,
                device)
            out["cases"].append(c)
            log(f"  (a) {n} shards of {device}, {layout}: {c['ms']:.3f} ms per LM "
                f"iteration ({c['ms'] / t_single:.3f}x ba.solve_ba); float64 against "
                f"ba.solve_ba: cost rel {c64['cost_rel']:.3g}, max |dpose| "
                f"{c64['poses']:.3g}, max |dpoint| {c64['points']:.3g}, per-edge chi2 "
                f"at {c64['chi2']:.3g} of its band; float32: cost {c['cost']:.9g} (rel "
                f"{c['cost_rel']:.3g}), max |dpose| {c['poses']:.3g}, max |dpoint| "
                f"{c['points']:.3g} ({card})")
            if not (c64["cost_rel"] < 1e-3 and c64["poses"] < 5e-4 and
                    c64["points"] < 5e-3 and c64["chi2"] <= 1 and c64["shape_ok"]
                    and c["shape_ok"]):
                problems.append(f"{n} shards {layout}: {c}")
    if problems:
        raise AssertionError("distributed BA against ba.solve_ba: " +
                             "; ".join(problems))
    return out


def check_dist_pipeline(loop_sys, device, card: str) -> dict:
    """(b) phase 9's final map: LoopCloser._global_ba once with a virtual
    mesh of 4 shards attached, its distributed solve held to ba.solve_ba on
    the same packed problem at tests/test_dist_pipeline.py's bands (cost
    rtol 2e-3, poses rtol 1e-2 atol 2e-3).  At the default threshold when
    the packed E reaches it (the natural routing), else forced with
    dist_edge_threshold=1."""
    lc = loop_sys.loop_closer
    seen = {}
    real_dist, real_auto = dist_ba.solve_ba_distributed, runtime.solve_ba_auto

    def spy(prob, *args, **kwargs):
        seen["prob"] = prob
        seen["res"] = real_dist(prob, *args, **kwargs)
        return seen["res"]

    m = loop_sys.map
    natural = None

    def auto(prob, *args, **kwargs):
        nonlocal natural
        natural = prob.edges.kf.shape[0] >= runtime.DIST_EDGE_THRESHOLD
        if not natural:
            kwargs["dist_edge_threshold"] = 1
        return real_auto(prob, *args, **kwargs)

    lc.mesh = Mesh((device,) * 4)
    dist_ba.solve_ba_distributed, runtime.solve_ba_auto = spy, auto
    try:
        _sync(device)
        t0 = time.perf_counter()
        lc._global_ba()
        _sync(device)
        t_dist = 1e3 * (time.perf_counter() - t0)
    finally:
        dist_ba.solve_ba_distributed, runtime.solve_ba_auto = real_dist, real_auto
        lc.mesh = None
    if "res" not in seen:
        raise AssertionError("LoopCloser._global_ba did not reach the distributed "
                             "solver")
    prob, res = seen["prob"], seen["res"]
    K, M, E = (int(prob.poses.shape[0]), int(prob.points.shape[0]),
               int(prob.edges.kf.shape[0]))
    rig = lc.rig
    _sync(device)
    t0 = time.perf_counter()
    one = ba.solve_ba(prob, rig.T_sc, rig.adj_sc, rig.K, iters=10)
    _sync(device)
    t_one = 1e3 * (time.perf_counter() - t0)
    rel = abs(float(res.cost) / float(one.cost) - 1)
    dp = float(((res.poses - one.poses).abs() /
                (2e-3 + 1e-2 * one.poses.abs())).max())
    log(f"  (b) phase 9's global BA: packed (K, M, E) = ({K}, {M}, {E}), "
        f"{m.n_keyframes} keyframes; routing "
        f"{'natural (E >= DIST_EDGE_THRESHOLD 16384)' if natural else 'FORCED with dist_edge_threshold=1 (E < 16384)'}; "
        f"LoopCloser._global_ba on 4 shards of {device} {t_dist:.3f} ms, ba.solve_ba "
        f"on the same problem {t_one:.3f} ms; cost {float(res.cost):.6g} against "
        f"{float(one.cost):.6g} (rel {rel:.3g}); poses at {dp:.3g} of their band "
        f"({card})")
    if not (rel < 2e-3 and dp <= 1):
        raise AssertionError(f"pipeline GBA on the mesh: cost rel {rel}, poses at "
                             f"{dp} of the band")
    if not all(np.isfinite(p.pos).all() for p in m.points.values()):
        raise AssertionError("pipeline GBA on the mesh: a map point is not finite")
    return {"K": K, "M": M, "E": E, "natural": natural, "ms": t_dist,
            "single_ms": t_one, "cost_rel": rel}


def run_mesh_system(device, card: str, n_frames: int = DIST_SYS_FRAMES) -> int:
    """(c) System(dual_default(), voc=None, mesh=<2 shards of the device>)
    over the first frames of phase 7's orbit: ends OK, one K1 launch per
    call.  Returns K1's launches over the run."""
    cfg = dual_default()
    frames = system_frames(cfg, device)[0][:n_frames]
    mesh = Mesh((device,) * 2)
    sys_ = System(cfg, voc=None, mesh=mesh)
    if sys_.tracker.mesh is not mesh:
        raise AssertionError("System did not hand its mesh to the tracker")
    _sync(device)
    k1.fast_nms.launches = 0
    states, ms, _ = drive(sys_, frames, "mesh-attached system")
    launches = k1.fast_nms.launches
    sys_.shutdown()
    log(f"  (c) System(cfg, voc=None, mesh=2 shards of {device}) over {n_frames} "
        f"frames of phase 7's orbit: last state {states[-1]}, "
        f"{sys_.map.n_keyframes} keyframes, ms/call median {np.median(ms):.3f}; "
        f"K1 launches {launches} ({card})")
    if states[-1] != "OK" or launches != n_frames:
        raise AssertionError(f"mesh-attached system: states {states}, K1 launched "
                             f"{launches} times over {n_frames} calls")
    return launches


def dist_rank_main(argv) -> int:
    """One rank of (d): `chip_smoke.py --dist-rank RANK PORT DEVICE N_KF N_MP`
    joins a two-rank gloo group, solves bench_dist_ba's problem on a mesh of
    one shard of DEVICE per rank and prints its cost and ms."""
    import datetime
    import torch.distributed as tdist
    rank, port, device, n_kf, n_mp = (int(argv[0]), argv[1], torch.device(argv[2]),
                                      int(argv[3]), int(argv[4]))
    tdist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                             world_size=2, rank=rank,
                             timeout=datetime.timedelta(seconds=60))
    try:
        prob, rig = dist_problem(device, n_kf, n_mp)
        mesh = Mesh((device,), group=tdist.group.WORLD)
        args = (prob, rig.T_sc, rig.adj_sc, rig.K, mesh)
        dist_ba.solve_ba_distributed(*args, iters=1)          # warm
        _sync(device)
        t0 = time.perf_counter()
        res = dist_ba.solve_ba_distributed(*args, iters=DIST_ITERS)
        cost = float(res.cost)
        ms = 1e3 * (time.perf_counter() - t0)
        print(f"RANK {rank} {cost!r} {ms:.3f} {float(res.edge_chi2.sum())!r}",
              flush=True)
    finally:
        tdist.destroy_process_group()
    return 0


def run_two_ranks(device, card: str, want_cost: float, n_kf: int = DIST_KF,
                  n_mp: int = DIST_MP) -> dict:
    """(d) Two processes sharing the device, each a rank of a gloo group
    with one shard, on the identical problem: both print the same cost, and
    it matches the in-process 2-shard solve's `want_cost` within
    tests/test_multihost.py's 2e-3."""
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, __file__, "--dist-rank", str(r), str(port), str(device),
         str(n_kf), str(n_mp)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=DIST_RANKS_TIMEOUT_S)
            if p.returncode != 0:
                raise AssertionError(f"rank exited {p.returncode}: {err[-3000:]}")
            outs.append(out)
    finally:
        for p in procs:
            p.kill()
            p.wait()
    wall = time.perf_counter() - t0
    got = [ln.split() for out in outs for ln in out.splitlines()
           if ln.startswith("RANK ")]
    costs = [float(g[2]) for g in got]
    ms = [float(g[3]) for g in got]
    chi2 = [float(g[4]) for g in got]
    rel = abs(costs[0] / want_cost - 1) if costs else float("inf")
    log(f"  (d) two ranks of a gloo group on {device}, one shard each: costs "
        f"{costs} (the in-process 2-shard solve {want_cost:.9g}, rel {rel:.3g}); "
        f"per-edge chi2 sums {chi2}; {DIST_ITERS} LM iterations in {ms} ms "
        f"({[t / DIST_ITERS for t in ms]} ms per iteration); both processes "
        f"{wall:.1f} s wall ({card})")
    if len(costs) != 2 or costs[0] != costs[1] or chi2[0] != chi2[1] or \
            not rel < 2e-3:
        raise AssertionError(f"two ranks: costs {costs}, chi2 {chi2}, rel {rel}")
    return {"costs": costs, "rel": rel, "ms_per_iter": [t / DIST_ITERS for t in ms]}


def write_tum_sequence(root, n: int) -> float:
    """A TUM-layout sequence of camera 0 of dual_default() along phase 7's
    orbit in its box room: rgb/<ts>.png, rgb.txt and groundtruth.txt (the
    camera centres, as the reference's tests/test_eval_tum.py writes them).
    Returns the path length."""
    import cv2
    cam = dual_default().cameras[0]
    K = np.array([[cam.fx, 0, cam.cx], [0, cam.fy, cam.cy], [0, 0, 1]])
    world = synthetic.make_box_world(np.random.default_rng(42), half=6.0)
    poses = synthetic.orbit_trajectory(n, radius=1.5,
                                       total_angle=0.8 * math.pi * n / 45)
    (root / "rgb").mkdir(parents=True, exist_ok=True)
    rgb, gt, centres = [], [], []
    for i, T in enumerate(poses):
        ts = 1305031100.0 + i / 30.0
        name = f"rgb/{ts:.6f}.png"
        img = synthetic.render(world, K, T, H=cam.height, W=cam.width)
        cv2.imwrite(str(root / name), np.clip(np.round(img), 0, 255).astype(np.uint8))
        rgb.append(f"{ts:.6f} {name}")
        c = np.linalg.inv(T)[:3, 3]
        centres.append(c)
        gt.append(f"{ts:.6f} {c[0]:.6f} {c[1]:.6f} {c[2]:.6f} 0 0 0 1")
    (root / "rgb.txt").write_text("# color images\n" + "\n".join(rgb) + "\n")
    (root / "groundtruth.txt").write_text("# ground truth\n" + "\n".join(gt) + "\n")
    return float(np.linalg.norm(np.diff(np.asarray(centres), axis=0), axis=1).sum())


def run_eval_tum(device, card: str, n: int = DIST_TUM_FRAMES) -> dict:
    """(e) The port's eval_tum.evaluate over an n-frame TUM-layout sequence
    at 640x480 written to disk here: at most 8 frames untracked, >= 5
    keyframes, Sim3 ATE under phase 7's 9% of the path."""
    import pathlib
    import tempfile
    cam = dual_default().cameras[0]
    with tempfile.TemporaryDirectory() as tmp:
        root = pathlib.Path(tmp)
        path = write_tum_sequence(root, n)
        t0 = time.perf_counter()
        out = eval_tum.evaluate(str(root), intr=dict(fx=cam.fx, fy=cam.fy,
                                                     cx=cam.cx, cy=cam.cy),
                                device=device)
        wall = time.perf_counter() - t0
    ate = out.get("ate_sim3_m", float("inf"))
    log(f"  (e) eval_tum.evaluate over {n} frames {cam.width}x{cam.height} written to disk: "
        f"{out['n_tracked']} tracked, {out['n_kf']} keyframes, {out['n_loops']} "
        f"loops, Sim3 ATE {ate:.4f} m on a path of {path:.3f} m, {wall:.1f} s "
        f"with its vocabulary ({card})")
    if out["n_tracked"] < n - 8 or out["n_kf"] < 5 or \
            not ate < SYS_MAX_ATE_OF_PATH * path:
        raise AssertionError(f"eval_tum: {out}")
    out["path"], out["wall_s"] = path, wall
    return out


def phase_dist(device, card: str, loop_sys) -> dict:
    """Phase 12: distributed BA on the card, (a)-(e).  Returns what was
    measured, with K1's launches over the mesh-attached system run."""
    t0 = time.perf_counter()
    solves = check_dist_solves(device, card)
    t_a = time.perf_counter() - t0
    pipeline = check_dist_pipeline(loop_sys, device, card)
    launches = run_mesh_system(device, card)
    two = next(c["cost"] for c in solves["cases"]
               if c["shards"] == 2 and c["layout"] == "replicated")
    ranks = run_two_ranks(device, card, two)
    tum = run_eval_tum(device, card)
    log(f"  phase 12 split: (a) {t_a:.1f} s, the rest "
        f"{time.perf_counter() - t0 - t_a:.1f} s")
    return {"solves": solves, "pipeline": pipeline, "launches": launches,
            "ranks": ranks, "tum": tum}


def profile_system(device, card: str, n_warm: int = 8, n_prof: int = 5) -> None:
    """`--profile`: the synchronous system under torch.profiler for n_prof
    tracked frames after n_warm, and one 15-step local BA on the last
    window: kernel launches and the card's busy time against the wall
    time.  The profiler slows the host, so the wall times here are not the
    system's; the launch counts and the busy time are."""
    from torch.profiler import ProfilerActivity, profile

    def totals(prof):
        launches, busy_us = 0, 0.0
        for e in prof.key_averages():
            if e.key.startswith("cudaLaunchKernel") or e.key == "cuLaunchKernel":
                launches += e.count
            busy_us += getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0.0))
        return launches, busy_us / 1e3

    cfg = dual_default()
    frames, _, _, _ = system_frames(cfg, device)
    sys_ = System(cfg, voc=None, enable_loop_closing=False)
    for k in range(n_warm):
        sys_.track(frames[k], k / 30.0)
    torch.cuda.synchronize()
    n_kf0 = sum(e.startswith("KF@") for e in sys_.tracker.events)
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for k in range(n_warm, n_warm + n_prof):
            sys_.track(frames[k], k / 30.0)
        torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t0)
    launches, busy = totals(prof)
    n_kf = sum(e.startswith("KF@") for e in sys_.tracker.events) - n_kf0
    log(f"  profiler, {n_prof} System.track calls ({n_kf} keyframes inserted, each "
        f"with a full local-mapping pass) ({card}): {launches / n_prof:.0f} kernel launches per "
        f"call, card busy {busy / n_prof:.3f} ms of {wall / n_prof:.3f} ms per call "
        f"under the profiler: idle share {1 - busy / wall:.4f}")
    prob, _ = sys_.mapper.last_ba
    args = (sys_.rig.T_sc, sys_.rig.adj_sc, sys_.rig.K)
    iters = cfg.ba.local_iters_a + cfg.ba.local_iters_b
    ba.solve_ba(prob, *args, iters=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        ba.solve_ba(prob, *args, iters=iters)
        torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t0)
    launches, busy = totals(prof)
    shape = (prob.poses.shape[0], prob.points.shape[0], prob.edges.kf.shape[0])
    log(f"  profiler, one solve_ba of {iters} LM steps, bucket (K, M, E) = {shape} "
        f"({card}): {launches} kernel launches, card busy {busy:.3f} ms of "
        f"{wall:.3f} ms under the profiler")

    # the dual bootstrap's stages on the map of one synchronous walk
    dcfg = dual_config()
    voc, dframes, _ = dual_scene(dcfg, device)
    dsys = System(dcfg, voc=voc, enable_loop_closing=False)
    drive(dsys, dframes, "profile, dual walk")
    dsys.shutdown()
    w = dual_workloads(dsys)
    stages = [("pnp_ransac (512 + 512 hypotheses)", w["pnp"]),
              ("optimize_pose_graph (20 x 32)", w["graph"]),
              ("optimal_map_scale (129 x E)", w["scale"]),
              ("_metric_gba (25 x 48)", lambda: dsys.tracker._metric_gba(iters=25))]
    for name, fn in stages:
        if not name.startswith("_metric"):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
        launches, busy = totals(prof)
        log(f"  profiler, one {name}, sizes (points, keyframes, edges) = "
            f"{w['sizes']} ({card}): {launches} kernel launches, card busy "
            f"{busy:.3f} ms of {wall:.3f} ms under the profiler")


def main() -> int:
    if sys.argv[1:2] == ["--dist-rank"]:
        return dist_rank_main(sys.argv[2:])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 1
    device = torch.device("cuda", torch.cuda.current_device())
    t_start = time.perf_counter()
    if sys.argv[1:] == ["--profile"]:
        _build.load_library()
        profile_system(device, card_line())
        return 0

    # 1. card
    card = card_line()
    name = torch.cuda.get_device_name(0)
    log(f"[1/12] card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {name}, count {torch.cuda.device_count()}")

    # 2. build
    t0 = time.perf_counter()
    built = not _build.library_path().exists()
    _build.load_library()
    log(f"[2/12] build: {'compiled' if built else 'cached'} "
        f"{_build.library_path().name} in {time.perf_counter() - t0:.1f} s")
    for line in _build.library_path().with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line or "error" in line.lower():
            log(f"  ptxas: {line.strip()}")
    t0 = time.perf_counter()
    built = not invfile.library_path().exists()
    invfile.load_library()
    log(f"  postings index: {'compiled' if built else 'cached'} "
        f"{invfile.library_path().name} (g++) in {time.perf_counter() - t0:.1f} s")

    # 3. K1 against its plain version
    k1_err = phase_k1(device)
    log(f"[3/12] K1 agrees with its plain version at all level shapes, one level "
        f"per launch and the pyramid in one launch (max |err| {k1_err})")

    # 4. the one-frame path at full width
    cfg = dual_default()
    t0 = time.perf_counter()
    scene = Scene(cfg, device)
    log(f"[4/12] scene: {N_FRAMES} frames 2x{H}x{W}, {scene.n_feats} features/camera, "
        f"{int(scene.store.valid.sum())}/{scene.cap} store slots seeded, vocabulary "
        f"k=10 depth 6 ({sum(c.numel() * 4 for c in scene.voc.centroids) / 1e6:.1f} MB) "
        f"in {time.perf_counter() - t0:.1f} s")
    outs, _, launches = run_chain(scene, device)
    check_track(scene, outs)
    n_tracked = len(outs)
    if launches != n_tracked:
        raise AssertionError(f"K1 launched {launches} times over {n_tracked} "
                             f"frames, expected 1 per frame")
    log(f"  K1 launches over the chain: {launches} ({launches / n_tracked:g} per frame)")
    cross_check_cpu(scene, outs[0][1])
    check_no_host_sync(scene, device)

    # 5. the batched path at full width
    batch_launches = check_batch(scene, device, outs)
    if batch_launches != DEPTH:
        raise AssertionError(f"K1 launched {batch_launches} times over a batch of "
                             f"{DEPTH} frames, expected 1 per frame")
    log(f"[5/12] batched path: {DEPTH} frames equal the one-by-one run exactly; "
        f"K1 launches {batch_launches} ({batch_launches / DEPTH:g} per frame)")

    # 6. timing
    _, t_rend, _ = run_chain(scene, device)          # warm: timed run
    t_span, spans = run_chain_with_spans(scene, device)
    t_rand = time_random(scene, device)
    med = float(np.median(t_rend))
    log(f"[6/12] step ms/frame ({card}): rendered chain median {med:.3f} "
        f"(min {min(t_rend):.3f}, max {max(t_rend):.3f}); random frames "
        f"(widened retry) median {np.median(t_rand):.3f} "
        f"(max {max(t_rand):.3f})")
    total = sum(t_span)
    log(f"  split of one rendered-chain run with stage events ({len(t_span)} "
        f"frames, {total:.3f} ms, median {np.median(t_span):.3f} ms/frame): " +
        ", ".join(f"{k} {v:.3f} ms ({v / total:.4f})" for k, v in spans.items()) +
        "; optimize_pose runs inside the stages")
    t_single, t_batch = time_batch_vs_single(scene, device)
    log(f"  frames 1-{DEPTH}, ms/frame in alternating runs: one-frame step median "
        f"{np.median(t_single):.3f} (" + ", ".join(f"{t:.3f}" for t in t_single) +
        f"); batched step median {np.median(t_batch):.3f} (" +
        ", ".join(f"{t:.3f}" for t in t_batch) + ")")
    k = time_k1(scene, device)
    us = 1e3
    log(f"  K1 on a rendered frame's pyramid ({len(k['shapes'])} levels x2, us): "
        f"one pyramid launch device-only {k['pyramid_device_ms'] * us:.2f}, per call "
        f"{k['pyramid_call_ms'] * us:.2f}; eight one-level launches device-only "
        f"{k['eight_device_ms'] * us:.2f}, per call {k['eight_call_ms'] * us:.2f}; "
        f"plain per call {k['plain_ms'] * us:.2f}; bound {k['bound_ms'] * us:.2f} "
        f"({k['bound_by']}, {k['arc_share']:.4f} of the pixels have a low-threshold "
        f"arc); a launch over 8 one-pixel levels device-only "
        f"{k['floor_device_ms'] * us:.2f}")
    log(f"  K1 at 2x{H}x{W} alone (us): device-only {k['level0_device_ms'] * us:.2f}, "
        f"per call {k['level0_call_ms'] * us:.2f}, plain per call "
        f"{k['plain0_ms'] * us:.2f}; bound {k['bound0_ms'] * us:.2f} "
        f"({k['bound0_by']}, arc share {k['arc_share0']:.4f})")
    log("  K1 one level per launch, device-only us: " + ", ".join(
        f"{h}x{w} {t * us:.2f}" for (_, h, w), t in zip(k["shapes"], k["level_device_ms"])))
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    log(f"  peak device memory {peak:.0f} MiB; {time.perf_counter() - t_start:.0f} s so far")

    # 7. the system at full width
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sys_launches = phase_system(device, card)
    log(f"[7/12] system: System.track initialized, tracked, mapped and bundle-"
        f"adjusted the orbit synchronously and with async_mapping; K1 launches "
        f"{sys_launches} over {SYS_FRAMES} track calls (1 per call); peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2 ** 20:.0f} MiB; phase "
        f"{time.perf_counter() - t0:.0f} s, total "
        f"{time.perf_counter() - t_start:.0f} s")

    # 8. the dual bootstrap at full width
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    dual_launches, dual = phase_dual(device, card)
    log(f"[8/12] dual bootstrap: System(cfg, voc).track walked out, turned and came "
        f"back, relocalized across cameras, scaled the map by the baseline and "
        f"reached FULL, synchronously and with async_mapping, and relocalized by "
        f"vocabulary after a forced loss; K1 launches {dual_launches} (1 per track "
        f"call); peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 20:.0f} MiB; phase "
        f"{time.perf_counter() - t0:.0f} s, total "
        f"{time.perf_counter() - t_start:.0f} s")

    # 9. the loop at full width
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loop_launches, loop_sys = phase_loop(device, card)
    log(f"[9/12] loop: System(cfg, voc, enable_loop_closing=True).track went past a "
        f"full turn, detected the loop, computed and optimized its Sim3, corrected "
        f"it and ran the global BA; K1 launches {loop_launches} (1 per track call); "
        f"peak device memory {torch.cuda.max_memory_allocated() / 2 ** 20:.0f} MiB; "
        f"phase {time.perf_counter() - t0:.0f} s, total "
        f"{time.perf_counter() - t_start:.0f} s")

    # 10. the run path: settings file, vocabulary file, video, the CLI,
    # the map archive, the tools
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ran = phase_run(device, card, dual)
    del dual
    log(f"[10/12] run path: python3 -m orbslam2_dualcam_tpu_torch.run tracked "
        f"{RUN_FRAMES} frames of a joint MJPG video with a settings file and a "
        f"vocabulary file and wrote its four artifacts; the map restored, its "
        f"database rebuilt, the cloud tools on its points; K1 launches "
        f"{ran['launches']} over the counted run's {RUN_FRAMES} track calls (1 per "
        f"call); peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 20:.0f} MiB; phase "
        f"{time.perf_counter() - t0:.0f} s, total "
        f"{time.perf_counter() - t_start:.0f} s ({card})")

    # 11. the deployment configuration: deferred batched tracking with the
    # mapping thread (bench.py's bench_end_to_end)
    t0 = time.perf_counter()
    dep = phase_deployment(device, card)
    log(f"[11/12] deployment: System(cfg, voc, enable_loop_closing=False, "
        f"async_mapping=True, deferred_tracking=True) tracked the {DEPLOY_FRAMES}-frame "
        f"orbit at pipeline_depth 3 with no DROPFRAME or LOST ({dep['events']['THIN@']} "
        f"THIN; none with synchronous mapping); trajectory {dep['n_traj']} frames, ATE "
        f"{dep['ate']:.4f} m; mean {dep['mean']:.3f} ms/call (synchronous "
        f"{dep['sync']['mean']:.3f}); K1 launches {dep['launches']} over "
        f"{DEPLOY_FRAMES} track calls; {dep['gets']} fused_get waits for "
        f"{dep['dispatches']} dispatches; peak device memory {dep['peak']:.0f} MiB; "
        f"phase {time.perf_counter() - t0:.0f} s, total "
        f"{time.perf_counter() - t_start:.0f} s ({card})")

    # 12. distributed BA: the solver at scale on virtual meshes, phase 9's
    # global BA on a mesh, a mesh-attached System, two ranks sharing the
    # card, eval_tum
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    dist = phase_dist(device, card, loop_sys)
    del loop_sys
    pipe = dist["pipeline"]
    log(f"[12/12] distributed BA: solve_ba_distributed on virtual meshes of "
        f"{' and '.join(map(str, DIST_SHARDS))} shards of {device} in both layouts "
        f"agreed with ba.solve_ba on E={dist['solves']['E']}; phase 9's global BA "
        f"(K, M, E) = ({pipe['K']}, {pipe['M']}, {pipe['E']}) reached the "
        f"distributed solver {'at the default threshold' if pipe['natural'] else 'only when forced'} "
        f"and agreed; a mesh-attached System tracked (K1 launches "
        f"{dist['launches']} over {DIST_SYS_FRAMES} track calls); two gloo ranks "
        f"returned equal costs; eval_tum ATE {dist['tum']['ate_sim3_m']:.4f} m; peak "
        f"device memory {torch.cuda.max_memory_allocated() / 2 ** 20:.0f} MiB; phase "
        f"{time.perf_counter() - t0:.0f} s, total "
        f"{time.perf_counter() - t_start:.0f} s ({card})")

    # launches: the one-frame chain's, the batch's, the synchronous mono
    # system run's, the synchronous dual walk's, the loop run's, the run
    # path's, the deployment run's and the mesh-attached system's, each
    # counted from 0 just before its path ran; times: the pyramid launch, as
    # every path calls it, on the main path's own data
    print(json.dumps({"kernels": [{
        "name": "fast_nms", "route": "cuda",
        "source": "orbslam2_dualcam_tpu_torch/csrc/fast_nms.cu",
        "replaces": "orbslam2_dualcam_tpu/ops/pallas_kernels.py:115",
        "launches": launches, "launches_batched_path": batch_launches,
        "launches_system_path": sys_launches,
        "launches_dual_path": dual_launches,
        "launches_loop_path": loop_launches,
        "launches_run_path": ran["launches"],
        "launches_deployment_path": dep["launches"],
        "launches_dist_path": dist["launches"],
        "max_abs_err": k1_err,
        "ms": k["pyramid_device_ms"], "per_call_ms": k["pyramid_call_ms"],
        "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
        "bound_by": k["bound_by"], "library_ms": None,
        "level0_ms": k["level0_device_ms"], "level0_bound_ms": k["bound0_ms"]}]}),
        flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
