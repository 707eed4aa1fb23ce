#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Drives the port's main path, the fused dual-camera tracking step
(orbslam2_dualcam_tpu_torch.pipeline.frontend.make_track_fn), at the
reference's operating point: 2 x 640 x 480 frames, 1300 features per
camera, 8 levels x 1.2, a 2048-slot map store and a random vocabulary tree
of ORBvoc's shape (k=10, depth 6).  Phases, each raising on failure:

  1. card: nvidia-smi name and power limit, torch and CUDA versions;
  2. build: the CUDA kernels from csrc/ with nvcc (sm_90a);
  3. K1 (fast_nms) against its plain torch version on the card, at all 8
     main-path level shapes for two cameras and a non-tile-aligned shape;
  4. track a rendered 12-frame orbit: seed the store from frame 0 with
     ground-truth depth, chain frames 1-11 through the step, hold poses and
     match counts to fixed bounds, count 8 K1 launches per frame,
     re-run frame 1 on the host CPU as a cross-check, and run one step with
     host synchronization forbidden;
  5. timing with CUDA events: the step's median ms/frame on the rendered
     chain and on 20 random frames (worst case: the widened retry always
     engages), a per-stage split, and K1 against its plain version.

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
from orbslam2_dualcam_tpu_torch.ops.orb import level_shapes
from orbslam2_dualcam_tpu_torch.optim import pose_opt
from orbslam2_dualcam_tpu_torch.pipeline import frontend
from orbslam2_dualcam_tpu_torch.utils import synthetic
from orbslam2_dualcam_tpu_torch.utils.convert import desc_to_numpy, desc_to_torch
from orbslam2_dualcam_tpu_torch.vocab.bow import Vocabulary

H, W = 480, 640
N_FRAMES = 12
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
    """The rendered orbit, the vocabulary and the seeded store on one
    device."""

    def __init__(self, cfg, device, seed: int = 1):
        rng = np.random.default_rng(seed)
        self.cfg, self.device = cfg, device
        self.n_feats, self.cap = cfg.orb.n_track, cfg.tracker.fused_cap
        self.rig = make_rig(cfg, device)
        self.voc = random_vocabulary(rng, 10, 6, cfg.vocab.direct_index_level,
                                     device)
        self.world = synthetic.make_box_world(rng, half=6.0)
        self.poses = synthetic.orbit_trajectory(
            N_FRAMES, radius=1.5, total_angle=N_FRAMES * STEP_RAD)
        K, T_sc = self.rig.K.cpu().numpy(), self.rig.T_sc.cpu().numpy()
        self.frames = [np.clip(np.round(synthetic.render_rig(
            self.world, K, T_sc, T, H=H, W=W)), 0, 255).astype(np.uint8)
            for T in self.poses]
        self.step = frontend.make_track_fn(cfg, self.n_feats, self.voc,
                                           self.rig, device)
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


def phase_k1(device) -> float:
    """K1 against fast_nms_reference on the card; returns max |error|."""
    rng = np.random.default_rng(2)
    world = synthetic.make_box_world(rng, half=6.0, tex_size=256)
    worst = 0.0
    for h, w in level_shapes(H, W, 8, 1.2) + [(100, 150)]:
        K = np.array([[500.0 * w / W, 0, w / 2], [0, 500.0 * h / H, h / 2], [0, 0, 1]])
        rendered = np.round(synthetic.render_rig(
            world, np.stack([K, K]), np.stack([np.eye(4), np.diag([-1.0, 1, -1, 1])]),
            np.eye(4), H=h, W=w)).astype(np.float32)
        noise = rng.uniform(0, 255, (2, h, w)).astype(np.float32)
        for name, img, atol in (("u8-valued", rendered, 0.0), ("random", noise, 1e-3)):
            x = torch.as_tensor(img, device=device)
            s, sad = k1.fast_nms(x, 20.0, 7.0)
            torch.cuda.synchronize()
            rs, rsad = k1.fast_nms_reference(x, 20.0, 7.0)
            err = max((s - rs).abs().max().item(), (sad - rsad).abs().max().item())
            worst = max(worst, err)
            if err > atol:
                raise AssertionError(f"K1 disagrees at {h}x{w} {name}: "
                                     f"max |err| {err} > {atol}")
        n_corners = int((s > 0).sum())
        log(f"  K1 {h}x{w} x2: agrees (corners kept {n_corners})")
    return worst


def run_chain(scene: Scene, device):
    """Chain frames 1-11 on the card.  Returns the per-frame (FrameData,
    FusedTrackOut), the ms of each step (CUDA events around each call) and
    K1's launch count over the chain."""
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


def time_k1(device, h: int, w: int, n: int = 50):
    """K1 on [2, h, w] random input: (kernel ms per call, plain ms per
    call, kernel device-only ms).  Per-call times are n back-to-back calls
    between CUDA events, alternated plain, kernel, kernel, plain; they
    include the host's launch overhead, which bounds the plain version.
    The device-only time queues the n launches behind a sleep kernel, so
    the events see the launches run back to back."""
    x = torch.rand(2, h, w, device=device) * 255

    def plain():
        return k1.fast_nms_reference(x, 20.0, 7.0)

    def kernel():
        return k1.fast_nms(x, 20.0, 7.0)

    def run(fn, queue_behind_sleep=False):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        fn()
        torch.cuda.synchronize()
        if queue_behind_sleep:
            torch.cuda._sleep(50_000_000)          # ~25 ms of device time
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / n

    p1, k_1, k_2, p2 = run(plain), run(kernel), run(kernel), run(plain)
    return (k_1 + k_2) / 2, (p1 + p2) / 2, run(kernel, queue_behind_sleep=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    t_start = time.perf_counter()

    # 1. card
    card = card_line()
    name = torch.cuda.get_device_name(0)
    log(f"[1/5] card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {name}, count {torch.cuda.device_count()}")

    # 2. build
    t0 = time.perf_counter()
    built = not _build.library_path().exists()
    _build.load_library()
    log(f"[2/5] build: {'compiled' if built else 'cached'} "
        f"{_build.library_path().name} in {time.perf_counter() - t0:.1f} s")
    for line in _build.library_path().with_suffix(".log").read_text().splitlines():
        if "registers" in line or "error" in line.lower():
            log(f"  ptxas: {line.strip()}")

    # 3. K1 against its plain version
    k1_err = phase_k1(device)
    log(f"[3/5] K1 agrees with its plain version at all level shapes "
        f"(max |err| {k1_err})")

    # 4. the slice at full width
    cfg = dual_default()
    t0 = time.perf_counter()
    scene = Scene(cfg, device)
    log(f"[4/5] scene: {N_FRAMES} frames 2x{H}x{W}, {scene.n_feats} features/camera, "
        f"{int(scene.store.valid.sum())}/{scene.cap} store slots seeded, vocabulary "
        f"k=10 depth 6 ({sum(c.numel() * 4 for c in scene.voc.centroids) / 1e6:.1f} MB) "
        f"in {time.perf_counter() - t0:.1f} s")
    outs, _, launches = run_chain(scene, device)
    check_track(scene, outs)
    n_tracked = len(outs)
    if launches != cfg.orb.n_levels * n_tracked:
        raise AssertionError(f"K1 launched {launches} times over {n_tracked} "
                             f"frames, expected {cfg.orb.n_levels} per frame")
    log(f"  K1 launches over the chain: {launches} ({launches // n_tracked} per frame)")
    cross_check_cpu(scene, outs[0][1])
    check_no_host_sync(scene, device)

    # 5. timing
    _, t_rend, _ = run_chain(scene, device)          # warm: timed run
    t_span, spans = run_chain_with_spans(scene, device)
    t_rand = time_random(scene, device)
    med = float(np.median(t_rend))
    log(f"[5/5] step ms/frame ({card}): rendered chain median {med:.3f} "
        f"(min {min(t_rend):.3f}, max {max(t_rend):.3f}); random frames "
        f"(widened retry) median {np.median(t_rand):.3f} "
        f"(max {max(t_rand):.3f})")
    total = sum(t_span)
    log(f"  split of one rendered-chain run with stage events ({len(t_span)} "
        f"frames, {total:.3f} ms, median {np.median(t_span):.3f} ms/frame): " +
        ", ".join(f"{k} {v:.3f} ms ({v / total:.4f})" for k, v in spans.items()) +
        "; optimize_pose runs inside the stages")
    k1_rows = []
    for h, w in level_shapes(H, W, 8, 1.2):
        km, pm, kd = time_k1(device, h, w)
        k1_rows.append((h, w, km, pm))
        log(f"  K1 2x{h}x{w}: per call kernel {km * 1e3:.2f} us, plain "
            f"{pm * 1e3:.2f} us; kernel device-only {kd * 1e3:.2f} us")
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    log(f"  peak device memory {peak:.0f} MiB; total {time.perf_counter() - t_start:.0f} s")

    print(json.dumps({"kernels": [{
        "name": "fast_nms", "route": "cuda",
        "source": "orbslam2_dualcam_tpu_torch/csrc/fast_nms.cu",
        "replaces": "orbslam2_dualcam_tpu/ops/pallas_kernels.py:115",
        "launches": launches, "max_abs_err": k1_err,
        "ms": k1_rows[0][2], "plain_ms": k1_rows[0][3]}]}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
