"""One run of one cell: set-up, the measured window, the trace, and the
comparison with the plain reference that decides `correct`.

Everything that belongs to one configuration, one traffic mix or one
metric is read from its own file, found by name:

- slambench/configs/<config>.json: the settings in the original's
  settings-file keys, the vocabulary, the system's options;
- slambench/traffic/<traffic>.json: the paths and the steps of the
  traffic (traffic_plan), whose kinds are slambench/paths/<kind>.py and
  slambench/steps/<kind>.py;
- slambench/metrics/<metric>.py: a reader `read(run) -> float | None`;
- slambench/limits/<workload>.json: the limit of each number compared.

The system under test is the port, `orbslam2_dualcam_tpu_torch`, built as
its CLI builds it (settings file -> `load_rig_yaml`, a vocabulary,
`System(cfg, voc, enable_loop_closing=True)`), and driven through
`System.track` with u8 frames [ncam, H, W] in host memory.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import sys
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from slambench import generator, traffic_plan
from slambench.reference import geometry, k1_roofline, trajectory
from slambench.reference import orb as ref_orb

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "orbslam2_dualcam_tpu")
# tracker events that mark a frame tracked outside the fused step
OTHER_PATHS = ("LOST", "RELOC", "RESCUE", "FORCED_LOST", "INIT")
# the comparison's samples: frames whose extraction is compared, frames
# whose pose is compared (drawn from the calls that snapshot the map, a
# quarter of them), local BAs compared (the window's last and others)
N_EXTRACT, N_POSE, POSE_RATE, N_BA = 4, 6, 0.25, 3


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that the benchmark may not load,
    compared whole (the port's own name begins with the JAX package's)."""
    import sys
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


# ---------------------------------------------------------------------------
# the configuration
# ---------------------------------------------------------------------------

def settings_yaml(settings: dict) -> str:
    lines = ["%YAML:1.0"]
    for k, v in settings.items():
        lines.append(f"{k}: {v}")
    return "\n".join(lines) + "\n"


def quat_rot(qw: float, qx: float, qy: float, qz: float) -> np.ndarray:
    q = np.array([qw, qx, qy, qz], np.float64)
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


@dataclass
class Cameras:
    """The rig as the settings state it, worked out by the benchmark."""

    K: np.ndarray       # [ncam, 3, 3]
    dist: np.ndarray    # [ncam, 5]
    T_sc: np.ndarray    # [ncam, 4, 4]
    H: int
    W: int
    orb: ref_orb.OrbParams
    n_features: int


def cameras_of(settings: dict) -> Cameras:
    s = settings
    n = int(s.get("nCameras", 1))
    K, dist, T = [], [], []
    for c in range(n):
        p = f"Camera{c}."
        K.append(np.array([[s[p + "fx"], 0, s[p + "cx"]], [0, s[p + "fy"], s[p + "cy"]],
                           [0, 0, 1]], np.float64))
        dist.append([s.get(p + k, 0.0) for k in ("k1", "k2", "p1", "p2", "k3")])
        Tc = np.eye(4)
        Tc[:3, :3] = quat_rot(s.get(p + "qw", 1.0), s.get(p + "qx", 0.0),
                              s.get(p + "qy", 0.0), s.get(p + "qz", 0.0))
        Tc[:3, 3] = [s.get(p + "tx", 0.0), s.get(p + "ty", 0.0), s.get(p + "tz", 0.0)]
        T.append(Tc)
    orb = ref_orb.OrbParams(
        n_levels=int(s.get("ORBextractor.nLevels", 8)),
        scale_factor=float(s.get("ORBextractor.scaleFactor", 1.2)),
        ini_th_fast=float(s.get("ORBextractor.iniThFAST", 20)),
        min_th_fast=float(s.get("ORBextractor.minThFAST", 7)))
    return Cameras(K=np.stack(K), dist=np.asarray(dist, np.float64),
                   T_sc=np.stack(T), H=int(s.get("Camera.height", 480)),
                   W=int(s.get("Camera.width", 640)), orb=orb,
                   n_features=int(s.get("ORBextractor.nFeatures", 1000)))


# ---------------------------------------------------------------------------
# what a run records
# ---------------------------------------------------------------------------

@dataclass
class Run:
    """What the metric readers and the comparison read."""

    workload: str
    setup_s: float = 0.0
    window_s: float = 0.0
    submitted: List[int] = field(default_factory=list)     # fids in the window
    published: List[int] = field(default_factory=list)     # fids published in it
    latency_s: Dict[int, float] = field(default_factory=dict)
    failed: int = 0
    tracker_stages: Dict[str, List[float]] = field(default_factory=dict)
    mapper_stages: Dict[str, List[float]] = field(default_factory=dict)
    events: List[str] = field(default_factory=list)
    fused_frames: int = 0
    trace: Optional[dict] = None
    k1_bound_s_per_frame: Optional[float] = None
    k1_bound_by: Optional[str] = None
    book_s: float = 0.0                      # harness bookkeeping left out


def stages_since(samples: dict, start: dict) -> Dict[str, List[float]]:
    return {k: list(v[start.get(k, 0):]) for k, v in samples.items()
            if len(v) > start.get(k, 0)}


def read_metrics(names: List[str], run: Run, units: Dict[str, str]) -> dict:
    out = {}
    for name in names:
        path = HERE / "metrics" / f"{name}.py"
        spec = importlib.util.spec_from_file_location(
            f"slambench_metric_{name.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        v = mod.read(run)
        if v is not None:
            out[name] = {"value": float(v), "unit": units[name]}
    return out


# ---------------------------------------------------------------------------
# the device trace
# ---------------------------------------------------------------------------

class DeviceTrace:
    """torch.profiler over the window, CUDA activity only (kernels and
    copies), read from the profiler's raw events."""

    def __init__(self, device: torch.device) -> None:
        from torch.profiler import ProfilerActivity, profile
        self.device = device
        self.prof = profile(activities=[ProfilerActivity.CUDA])

    def __enter__(self):
        self.prof.__enter__()
        # a marker kernel ties the trace's clock to the host's
        torch.cuda.synchronize(self.device)
        self.host_mark_ns = time.perf_counter_ns()
        torch.ones(1, device=self.device).mul_(3.0)
        torch.cuda.synchronize(self.device)
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize(self.device)
        self.prof.__exit__(*exc)
        return False

    def events(self):
        """[(name, start_ns, end_ns)] of every device activity, sorted."""
        res = self.prof.profiler.kineto_results
        out = []
        for e in res.events():
            if str(e.device_type()).split(".")[-1] != "CUDA":
                continue
            if hasattr(e, "start_ns"):
                s, d = e.start_ns(), e.duration_ns()
            else:
                s, d = 1000 * e.start_us(), 1000 * e.duration_us()
            out.append((e.name(), int(s), int(s + d)))
        out.sort(key=lambda x: x[1])
        return out


def summarize_trace(events, win0_ns: int, win1_ns: int, labels) -> dict:
    """Busy time (the union of device intervals), kernel counts and times,
    K1's time, and the longest idle gaps with what the host was doing,
    over [win0_ns, win1_ns] on the trace's clock.  `labels(t_ns)` names
    the host's activity at a trace time."""
    kern_n = 0
    by_name: Dict[str, float] = {}
    k1_s, k1_n = 0.0, 0
    busy = 0
    gaps = []
    cur_s = cur_e = None
    for name, s, e in events:
        s, e = max(s, win0_ns), min(e, win1_ns)
        if e <= s:
            continue
        is_copy = name.startswith(("Memcpy", "Memset"))
        if not is_copy:
            kern_n += 1
        by_name[name] = by_name.get(name, 0.0) + (e - s) * 1e-9
        if "fast_nms" in name:
            k1_s += (e - s) * 1e-9
            k1_n += 1
        if cur_e is None:
            if s > win0_ns:
                gaps.append((s - win0_ns, win0_ns))
            cur_s, cur_e = s, e
        elif s <= cur_e:
            cur_e = max(cur_e, e)
        else:
            busy += cur_e - cur_s
            gaps.append((s - cur_e, cur_e))
            cur_s, cur_e = s, e
    if cur_e is not None:
        busy += cur_e - cur_s
        if win1_ns > cur_e:
            gaps.append((win1_ns - cur_e, cur_e))
    gaps.sort(reverse=True)
    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy * 1e-9, "window_s": (win1_ns - win0_ns) * 1e-9,
            "kernels": kern_n, "k1_s": k1_s, "k1_launches": k1_n,
            "device_ops": [[n, v] for n, v in top_ops],
            "idle_gaps": [[labels(t0 + g // 2), g * 1e-9] for g, t0 in gaps[:10]]}


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------

def build_system(config: dict, plan: traffic_plan.Plan, voc, device):
    from orbslam2_dualcam_tpu_torch.pipeline.system import System
    from orbslam2_dualcam_tpu_torch.utils.yaml_config import load_rig_yaml

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "settings.yaml")
        with open(path, "w") as f:
            f.write(settings_yaml(config["settings"]))
        cfg = load_rig_yaml(path)
    if plan.pipeline_depth != cfg.tracker.pipeline_depth:
        import dataclasses
        cfg = dataclasses.replace(cfg, tracker=dataclasses.replace(
            cfg.tracker, pipeline_depth=plan.pipeline_depth))
    opts = config.get("system", {})
    return System(cfg, voc=voc,
                  enable_loop_closing=bool(opts.get("enable_loop_closing", True)),
                  async_mapping=bool(opts.get("async_mapping", False)),
                  deferred_tracking=plan.deferred, device=device)


def train_vocabulary(config: dict, frames: np.ndarray, cams: Cameras, device):
    """k-majority tree over the port's descriptors of the first frames of
    the traffic, as examples/eval_tum.py trains one."""
    from orbslam2_dualcam_tpu_torch.ops import orb
    from orbslam2_dualcam_tpu_torch.utils.config import OrbConfig
    from orbslam2_dualcam_tpu_torch.vocab import bow

    v = config["vocabulary"]
    ocfg = OrbConfig(n_features=cams.n_features, n_levels=cams.orb.n_levels,
                     scale_factor=cams.orb.scale_factor,
                     ini_th_fast=int(cams.orb.ini_th_fast),
                     min_th_fast=int(cams.orb.min_th_fast))
    descs = []
    for img in frames[:int(v["frames"])]:
        f = orb.extract_orb_rig(torch.as_tensor(img, device=device).to(torch.float32),
                                ocfg, ocfg.n_track)
        d = f.desc.cpu().numpy().view(np.uint32)
        ok = f.valid.cpu().numpy()
        descs += [d[c][ok[c]] for c in range(d.shape[0])]
    train = np.concatenate(descs)[:int(v["max_descriptors"])]
    return bow.train_vocabulary(train, branching=int(v["branching"]),
                                depth=int(v["depth"]), seed=int(v["seed"]),
                                weight_docs=descs, device=device)


class Feeder:
    """What the traffic's steps drive through (slambench/steps/<kind>.py):
    the system, each path's cursor, `track` and `call`, and the record of
    the window.  The harness's own bookkeeping inside the window (the map
    snapshots for the pose comparison, the trajectory kept at a reset) is
    timed apart in `t_book` and left out of the window's time and of every
    frame's latency."""

    def __init__(self, system, plan, frames, fps: float, seed: int, n_track: int) -> None:
        self.system, self.tracker, self.mapper = system, system.tracker, system.mapper
        self.plan, self.frames, self.fps, self.n_track = plan, frames, fps, n_track
        self.cursor = {name: 0 for name in plan.length}
        self.idx_of_fid: Dict[int, int] = {}
        self.n_sub = 0
        self.mode = "setup"                     # "setup" | "window" | "drain"
        self.t_book = 0.0
        self.maps: List[list] = []              # composed trajectories of finished maps
        self.calls: List[tuple] = []            # (t0_ns, t1_ns, label) in the window
        self.t_submit: Dict[int, tuple] = {}    # fid -> (call start, t_book then)
        self.run: Optional[Run] = None
        self.kept_frames: List[dict] = []
        self.kept_bas: List[object] = []
        self.init_frames = set()
        self._seen = set()
        self._last_ba = self.mapper.last_ba
        self._pose_rng = np.random.default_rng([seed, 1])

    def initialized(self) -> bool:
        return self.tracker.state != self.tracker.NOT_INITIALIZED

    def _submit(self, idx: int) -> int:
        fid = self.tracker.frame_id
        self.idx_of_fid[fid] = idx
        self.system.track(self.frames[idx], self.n_sub / self.fps)
        self.n_sub += 1
        return fid

    def track(self, idx: int) -> None:
        if self.mode == "setup":
            self._submit(idx)
            return
        tr = self.tracker
        b0 = time.perf_counter()
        n_traj0, ev_before = len(tr.trajectory), len(tr.events)
        snap = self._snapshot() if self.mode == "window" else None
        fused_before = tr.n_fused_frames
        if self.mode == "window" and tr.state == tr.NOT_INITIALIZED:
            self.init_frames.add(tr.frame_id)
        a = time.perf_counter()
        self.t_book += a - b0
        if self.mode == "window":
            self.t_submit[tr.frame_id] = (a, self.t_book)
        fid = self._submit(idx)
        t1 = time.perf_counter()
        if self.mode == "window":
            self.run.submitted.append(fid)
            label = ("track, keyframe" if any(e.startswith("KF@")
                                              for e in tr.events[ev_before:])
                     else "track")
            self.calls.append((int(a * 1e9), int(t1 * 1e9), label))
        self._after_call(n_traj0, t1, ev_before, snap, fused_before)
        self.t_book += time.perf_counter() - t1

    def call(self, method: str) -> None:
        if self.mode == "drain":
            return
        b0 = time.perf_counter()
        kept = self.tracker.composed_trajectory()
        n_before = len(self.tracker.trajectory)
        a = time.perf_counter()
        self.t_book += a - b0
        obj = self.system
        for part in method.split("."):
            obj = getattr(obj, part)
        obj()
        t1 = time.perf_counter()
        if self.mode == "window":
            self.calls.append((int(a * 1e9), int(t1 * 1e9), method))
        if len(self.tracker.trajectory) < n_before:
            self.maps.append(kept)                # the call ended a map
        self.t_book += time.perf_counter() - t1

    def _snapshot(self):
        """Before a call drawn for the pose comparison: every map point's
        position, as the call's tracking will see it."""
        if self._pose_rng.random() >= POSE_RATE:
            return None
        pts = self.system.map.points
        mids = np.fromiter(pts.keys(), np.int64, len(pts))
        return mids, np.stack([pts[int(m)].pos for m in mids]) if len(mids) else None

    def _after_call(self, n_traj0, t1, ev_before, snap, fused_before) -> None:
        """Publication times, the frames and local BAs kept for the
        comparison."""
        tr, run = self.tracker, self.run
        for fid, *_ in tr.trajectory[n_traj0:]:
            if fid in self.t_submit and fid not in run.latency_s:
                a, book = self.t_submit[fid]
                run.latency_s[fid] = (t1 - a) - (self.t_book - book)
        f = tr.last
        if (f is not None and f.frame_id not in self._seen and f.T_cw is not None
                and f.n == self.n_track and f.mp_ids is not None):
            self._seen.add(f.frame_id)
            item = {"fid": f.frame_id, "frame": f}
            # the pose comparison takes frames that the fused step tracked;
            # a relocalized or rescued frame's pose came another way
            other = any(e.split(" ")[0] in (f"{k}@{f.frame_id}" for k in OTHER_PATHS)
                        for e in tr.events[ev_before:])
            if (snap is not None and snap[1] is not None and not other
                    and tr.n_fused_frames > fused_before):
                mids = f.mp_ids[f.mp_ids >= 0]
                order = np.argsort(snap[0])
                j = np.clip(np.searchsorted(snap[0], mids, sorter=order), 0, len(order) - 1)
                if mids.size >= 10 and (snap[0][order[j]] == mids).all():
                    item["X"] = snap[1][order[j]].astype(np.float64)
                    item["T_cw"] = np.array(f.T_cw, np.float64)
            self.kept_frames.append(item)
        if self.mapper.last_ba is not self._last_ba:
            self._last_ba = self.mapper.last_ba
            self.kept_bas.append(self._last_ba)


def drive(d: Feeder, steps: List[dict], cycle: bool):
    """The steps in order, each step's kind from slambench/steps/<kind>.py;
    yields after each call.  With `cycle` the steps start over when they
    end, every path's cursor back at its first frame."""
    kinds = {s["step"]: traffic_plan.load_kind("steps", s["step"]) for s in steps}
    while True:
        n = 0
        for step in steps:
            for _ in kinds[step["step"]].run(d, step):
                n += 1
                yield
        if not cycle:
            return
        if n == 0:
            raise ValueError("the window's steps make no call")
        d.cursor = {name: 0 for name in d.cursor}


def run_cell(workload: dict, config: dict, traffic: dict, limits: dict,
             seed: int, seconds: float, trace: bool, device, t_process0: float,
             e2e: List[dict], per_layer: List[dict], control: bool = False) -> dict:
    """Set up, measure `seconds`, compare; returns the result's fields and
    the comparison's readings.  `control=True` also reads the reference one
    precision lower in the program's place (slambench/calibrate.py)."""
    device = torch.device(device)
    rng = np.random.default_rng(seed)
    cams = cameras_of(config["settings"])
    plan = traffic_plan.make_plan(traffic, seed)

    # inputs from the seed: the room, the frames, rendered on the device
    gen = torch.Generator(device=device).manual_seed(int(seed))
    room = generator.make_room(gen, device, **config.get("room", {}))
    rig = generator.Rig(cams.K, cams.dist, cams.T_sc, cams.H, cams.W, device)
    frames = rig.render_u8(room, plan.poses)
    del room, rig

    voc = train_vocabulary(config, frames, cams, device)
    sys_ = build_system(config, plan, voc, device)
    tr, mapper = sys_.tracker, sys_.mapper
    n_track = tr.cfg.orb.n_track
    d = Feeder(sys_, plan, frames, float(config["settings"].get("Camera.fps", 30.0)),
               seed, n_track)
    for _ in drive(d, plan.setup, cycle=False):
        pass
    if device.type == "cuda":
        torch.cuda.synchronize(device)

    run = d.run = Run(workload=workload["name"])
    d._last_ba = mapper.last_ba
    t0_stage = {k: len(v) for k, v in tr.timer.samples.items()}
    m0_stage = {k: len(v) for k, v in mapper.timer.samples.items()}
    ev0 = len(tr.events)
    fused0 = tr.n_fused_frames

    tracer = DeviceTrace(device) if trace else None
    if tracer:
        tracer.__enter__()
    window = drive(d, plan.window, cycle=True)
    d.mode = "window"
    t_start = time.perf_counter()
    run.setup_s = t_start - t_process0
    for _ in window:
        t_end = time.perf_counter()
        if t_end - t_start - d.t_book >= seconds:
            break
    run.window_s = t_end - t_start - d.t_book
    run.book_s = d.t_book
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    if tracer:
        tracer.__exit__(None, None, None)
    run.tracker_stages = stages_since(tr.timer.samples, t0_stage)
    run.mapper_stages = stages_since(mapper.timer.samples, m0_stage)
    run.events = list(tr.events[ev0:])
    run.fused_frames = tr.n_fused_frames - fused0
    # frames still in flight (deferred tracking): feed on, untimed, until
    # each frame of the window has its pose or can have none
    d.mode = "drain"
    extra = 0
    while (plan.deferred and extra < 2 * plan.pipeline_depth + 2
           and any(f not in run.latency_s for f in run.submitted[-2 * plan.pipeline_depth:])):
        next(window)
        extra += 1
    run.published = [f for f in run.submitted if f in run.latency_s]
    # a frame that gets no pose while the map is being initialized is the
    # initializer's; every other frame without a pose failed
    run.failed = len([f for f in run.submitted
                      if f not in run.latency_s and f not in d.init_frames])
    # the trajectory of every map that the window published into, with
    # the true pose of each frame
    d.maps.append(tr.composed_trajectory())
    window_fids = set(run.submitted)
    truth = [[(T, plan.poses[d.idx_of_fid[fid]]) for fid, _, T in m if fid in d.idx_of_fid]
             for m in d.maps if any(fid in window_fids for fid, _, _ in m)]

    peak = (torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0)
    forbidden = forbidden_modules()

    trace_summary = None
    if tracer:
        events = tracer.events()
        mark = next((s for n, s, e in events if not n.startswith(("Memcpy", "Memset"))), None)
        off = (mark - tracer.host_mark_ns) if mark is not None else 0

        def labels(t_ns, calls=d.calls, off=off):
            h = t_ns - off
            for a, b, lab in calls:
                if a <= h <= b:
                    return lab
            return "between calls"

        trace_summary = summarize_trace(events, int(t_start * 1e9) + off,
                                        int(t_end * 1e9) + off, labels)
        run.trace = trace_summary
        del events
    del tracer

    # the program's answers to host memory, then its state freed
    kept_frames, idx_of_fid = d.kept_frames, d.idx_of_fid
    bas = [to_host_problem(prob, res) for prob, res in pick_bas(d.kept_bas, rng, N_BA)]
    del sys_, tr, mapper, voc, d
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    readings = judge(kept_frames, bas, frames, idx_of_fid, cams, rng, device, control)
    readings["program"].update(trajectory.judge(truth))
    print(f"  window: {run.window_s:.3f} s measured, {run.book_s:.3f} s of the harness's "
          f"bookkeeping left out", file=sys.stderr)
    print("  trajectory against the truth (printed, not compared): " + ", ".join(
        f"{k} {v:.6g}" for k, v in readings["program"].items() if k.startswith("traj")) +
        f"; {sum(len(m) for m in truth)} published frames in {len(truth)} map(s)",
        file=sys.stderr)
    if trace_summary is not None and kept_frames:
        pick = rng.choice(len(kept_frames), size=min(4, len(kept_frames)), replace=False)
        b = []
        for i in pick:
            img = torch.as_tensor(frames[idx_of_fid[kept_frames[i]["fid"]]], device=device)
            levels = k1_roofline.frame_levels(img, cams.orb, n_track)
            b.append(k1_roofline.bound_s(*k1_roofline.counts(
                levels, cams.orb.ini_th_fast, cams.orb.min_th_fast)))
        run.k1_bound_s_per_frame = float(np.mean([x[0] for x in b]))
        run.k1_bound_by = b[0][1]
        print(f"  K1: bound {1e6 * run.k1_bound_s_per_frame:.3f} us per frame, by "
              f"{run.k1_bound_by}; {trace_summary['k1_launches']} launches, "
              f"{1e3 * trace_summary['k1_s']:.3f} ms on the device", file=sys.stderr)

    names = [m["name"] for m in (per_layer if trace else e2e)
             if "workloads" not in m or workload["name"] in m["workloads"]]
    units = {m["name"]: m["unit"] for m in e2e + per_layer}
    metrics = read_metrics(names, run, units)
    checks = {name: {"value": readings["program"].get(name), "limit": lim}
              for name, lim in limits.items()}
    correct = all(c["value"] is not None and c["value"] <= c["limit"]
                  for c in checks.values())
    return {"run": run, "metrics": metrics, "checks": checks, "correct": correct,
            "readings": readings,
            "peak": peak, "forbidden": forbidden, "trace": trace_summary,
            "maps": truth}


def pick_bas(bas: list, rng, n: int) -> list:
    """The last local BA of the window and up to n - 1 others drawn."""
    if not bas:
        return []
    rest = bas[:-1]
    take = rng.choice(len(rest), size=min(n - 1, len(rest)), replace=False) if rest else []
    return [rest[i] for i in sorted(take)] + [bas[-1]]


def to_host_problem(prob, res) -> tuple:
    """A local BA as the program packed and solved it, on the host: the
    starting state, the observations, and the program's result."""
    e = prob.edges
    mask = (e.valid & prob.pose_valid[e.kf] & prob.point_valid[e.mp]).cpu()

    def h(x):
        return x.detach().cpu()
    start = geometry.Problem(
        poses=h(prob.poses).double(), points=h(prob.points).double(),
        kf=h(e.kf)[mask], mp=h(e.mp)[mask], cam=h(e.cam)[mask],
        uv=h(e.uv)[mask].double(), inv_sigma2=h(e.inv_sigma2)[mask].double(),
        pose_fixed=h(prob.pose_fixed) | ~h(prob.pose_valid),
        point_fixed=~h(prob.point_valid))
    return start, start._replace(poses=h(res.poses).double(),
                                 points=h(res.points).double())


# ---------------------------------------------------------------------------
# the comparison
# ---------------------------------------------------------------------------

def judge(frames_kept, bas, frames, idx_of_fid, cams: Cameras, rng, device,
          control: bool) -> dict:
    """The numbers compared, each the widest over its sample:

    - kp_mismatch, desc_bits: extraction of sampled frames against the
      plain extractor on the same u8 images (reference/orb.py);
    - pose_cost_excess: sampled tracked frames' published poses against
      the reference's optimum over their final matches, from the map
      points' positions as the frame's call saw them;
    - ba_shortfall: sampled local BAs (the window's last among them) of
      the program against the reference's solve of the same problem from
      the same start (reference/geometry.py).
    The trajectory's numbers (reference/trajectory.py) are added by the
    caller: they need the true poses and no device.
    Returns {"program": readings} and, with `control`, {"control":
    readings} of the reference in bfloat16 in the program's place."""
    # the reference's float32 is float32: no TF32 in its matrix products
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    modes = ("program", "control") if control else ("program",)
    out = {m: {} for m in modes}

    def worst(m, name, v):
        out[m][name] = max(out[m].get(name, v), v)

    n = min(N_EXTRACT, len(frames_kept))
    for i in (rng.choice(len(frames_kept), size=n, replace=False) if n else []):
        f = frames_kept[i]["frame"]
        img = torch.as_tensor(frames[idx_of_fid[f.frame_id]], device=device)
        ref = ref_orb.extract(img, cams.orb, f.n, cams.K, cams.dist)
        answers = {"program": ref_orb.Keypoints(
            uv=np.asarray(f.uv, np.float64), level=np.asarray(f.level),
            desc=np.asarray(f.desc).view(np.uint32), valid=np.asarray(f.valid, bool))}
        if control:
            answers["control"] = ref_orb.extract(img, cams.orb, f.n, cams.K, cams.dist,
                                                 dtype=torch.bfloat16)
        for m, kp in answers.items():
            mis, bits = ref_orb.compare(kp, ref)
            worst(m, "kp_mismatch", mis)
            worst(m, "desc_bits", bits)

    grig = geometry.rig_from(cams.K, cams.T_sc, device)
    sig2 = cams.orb.scale_factors ** 2
    posed = [f for f in frames_kept if "X" in f]
    n = min(N_POSE, len(posed))
    for i in (rng.choice(len(posed), size=n, replace=False) if n else []):
        f, fr = posed[i], posed[i]["frame"]
        ok = fr.mp_ids >= 0
        k = int(ok.sum())

        def t(a, dt=torch.float64):
            return torch.as_tensor(np.ascontiguousarray(a), device=device).to(dt)
        p = geometry.Problem(
            poses=t(f["T_cw"][None]), points=t(f["X"]),
            kf=t(np.zeros(k, np.int64), torch.long), mp=t(np.arange(k), torch.long),
            cam=t(np.broadcast_to(np.arange(fr.ncam)[:, None], ok.shape)[ok], torch.long),
            uv=t(fr.uv[ok]), inv_sigma2=t(1.0 / sig2[fr.level[ok]]),
            pose_fixed=t(np.zeros(1, bool), torch.bool),
            point_fixed=t(np.ones(k, bool), torch.bool))
        for m in modes:
            worst(m, "pose_cost_excess", geometry.judge_pose(p, grig, m == "control"))

    for start, res in bas:
        start = geometry.Problem(*(x.to(device) for x in start))
        res = geometry.Problem(*(x.to(device) for x in res))
        for m in modes:
            x, (c0, c, c_ref) = geometry.judge_ba(start, res, grig, m == "control")
            print(f"  local BA ({m}): {start.poses.shape[0]} poses, "
                  f"{start.points.shape[0]} points, {len(start.kf)} observations; "
                  f"cost start {c0:.6g}, answer {c:.6g}, reference {c_ref:.6g}, "
                  f"shortfall {x:.6g}", file=sys.stderr)
            worst(m, "ba_shortfall", x)
    return out
