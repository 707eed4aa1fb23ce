#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Drives the port's main paths, the fused dual-camera tracking step
(orbslam2_dualcam_tpu_torch.pipeline.frontend.make_track_fn) and its
batched form (make_track_batch_fn), at the reference's operating point:
2 x 640 x 480 frames, 1300 features per camera, 8 levels x 1.2, a 2048-slot
map store and a random vocabulary tree of ORBvoc's shape (k=10, depth 6).
Phases, each raising on failure:

  1. card: nvidia-smi name and power limit, torch and CUDA versions;
  2. build: the CUDA kernels from csrc/ with nvcc (sm_90a);
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
     its bound.

The last line of standard output is a JSON object with "ok": true; it is
printed only when every phase passed.  There is no CPU path: without a
CUDA card the script exits with an error.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

from orbslam2_dualcam_tpu_torch import _build, dual_default
from orbslam2_dualcam_tpu_torch.ops import fast_nms as k1
from orbslam2_dualcam_tpu_torch.ops.camera import make_rig
from orbslam2_dualcam_tpu_torch.ops.orb import _tables, build_pyramid, level_shapes
from orbslam2_dualcam_tpu_torch.optim import pose_opt
from orbslam2_dualcam_tpu_torch.pipeline import frontend
from orbslam2_dualcam_tpu_torch.utils import synthetic
from orbslam2_dualcam_tpu_torch.utils.convert import desc_to_numpy, desc_to_torch
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 1
    device = torch.device("cuda", torch.cuda.current_device())
    t_start = time.perf_counter()

    # 1. card
    card = card_line()
    name = torch.cuda.get_device_name(0)
    log(f"[1/6] card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {name}, count {torch.cuda.device_count()}")

    # 2. build
    t0 = time.perf_counter()
    built = not _build.library_path().exists()
    _build.load_library()
    log(f"[2/6] build: {'compiled' if built else 'cached'} "
        f"{_build.library_path().name} in {time.perf_counter() - t0:.1f} s")
    for line in _build.library_path().with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line or "error" in line.lower():
            log(f"  ptxas: {line.strip()}")

    # 3. K1 against its plain version
    k1_err = phase_k1(device)
    log(f"[3/6] K1 agrees with its plain version at all level shapes, one level "
        f"per launch and the pyramid in one launch (max |err| {k1_err})")

    # 4. the one-frame path at full width
    cfg = dual_default()
    t0 = time.perf_counter()
    scene = Scene(cfg, device)
    log(f"[4/6] scene: {N_FRAMES} frames 2x{H}x{W}, {scene.n_feats} features/camera, "
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
    log(f"[5/6] batched path: {DEPTH} frames equal the one-by-one run exactly; "
        f"K1 launches {batch_launches} ({batch_launches / DEPTH:g} per frame)")

    # 6. timing
    _, t_rend, _ = run_chain(scene, device)          # warm: timed run
    t_span, spans = run_chain_with_spans(scene, device)
    t_rand = time_random(scene, device)
    med = float(np.median(t_rend))
    log(f"[6/6] step ms/frame ({card}): rendered chain median {med:.3f} "
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
    log(f"  peak device memory {peak:.0f} MiB; total {time.perf_counter() - t_start:.0f} s")

    # launches: the one-frame chain's and the batch's, each counted from 0
    # just before its path ran; times: the pyramid launch, as both paths
    # call it, on the main path's own data
    print(json.dumps({"kernels": [{
        "name": "fast_nms", "route": "cuda",
        "source": "orbslam2_dualcam_tpu_torch/csrc/fast_nms.cu",
        "replaces": "orbslam2_dualcam_tpu/ops/pallas_kernels.py:115",
        "launches": launches, "launches_batched_path": batch_launches,
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
