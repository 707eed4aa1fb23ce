"""The port's span recorder (utils/profiling.py) on short CPU runs of the
System at the size of tests/test_torch_system.py::small_cfg: synchronous
with a vocabulary and loop closing, with the mapping thread, and deferred.

Each span lies inside its parent; one track call's spans carry its frame
id, and a deferred frame's processing carries that frame's; local BA is
packing, solving and unpacking; the mapping thread's spans are its own
roots; each component's StageTimer keeps the keys it had, one span per
sample; without a current recorder a span does nothing; overflow is
counted."""

import time

import numpy as np
import pytest
import torch

from orbslam2_dualcam_tpu.utils import synthetic as ref_synthetic
from orbslam2_dualcam_tpu_torch.pipeline.system import System
from orbslam2_dualcam_tpu_torch.utils import profiling

from test_torch_system import _drive, _tiny_voc, small_cfg

torch.set_num_threads(1)

# the stage keys each component's StageTimer had on these runs before the
# spans came: the spans are new, the keys are not
KEYS = {
    "sync": {"tracker": {"extract", "fused", "initialize", "store_refresh", "track"},
             "mapper": {"cross_cam", "fuse", "local_ba", "triangulate"},
             "loop": {"detect"}},
    "async": {"tracker": {"extract", "fused", "initialize", "store_refresh", "track"},
              "mapper": {"cross_cam", "fuse", "local_ba", "triangulate"}},
    "deferred": {"tracker": {"extract", "fused_dispatch", "fused_get",
                             "initialize", "store_refresh", "track"},
                 "mapper": {"cross_cam", "fuse", "local_ba", "triangulate"}},
}


def _run(mode: str, n: int):
    world = ref_synthetic.make_box_world(np.random.default_rng(42),
                                         n_points=2500, half=6.0)
    kw = dict(voc=None, enable_loop_closing=False)
    if mode == "sync":
        kw = dict(voc=_tiny_voc(), enable_loop_closing=True)
    sys_ = System(small_cfg(), device="cpu", async_mapping=mode == "async",
                  deferred_tracking=mode == "deferred", **kw)
    poses = ref_synthetic.orbit_trajectory(45, radius=1.5,
                                           total_angle=0.8 * np.pi)[:n]
    states = _drive(sys_, world, poses, wait_for_mapper=mode == "async")
    sys_.shutdown()
    return sys_, states


@pytest.fixture(scope="module")
def runs():
    return {}


def _get(runs, mode):
    if mode not in runs:
        runs[mode] = _run(mode, {"sync": 10, "async": 10, "deferred": 12}[mode])
    return runs[mode]


def _timers(sys_):
    out = {"tracker": sys_.tracker.timer, "mapper": sys_.mapper.timer}
    if sys_.loop_closer is not None:
        out["loop"] = sys_.loop_closer.timer
    return out


def _children(spans):
    kids = {}
    for s in spans:
        kids.setdefault(s.parent, []).append(s)
    return kids


def _descendants(sid, kids):
    out, todo = [], [sid]
    while todo:
        for c in kids.get(todo.pop(), []):
            out.append(c)
            todo.append(c.id)
    return out


@pytest.mark.parametrize("mode", ["sync", "async", "deferred"])
def test_every_span_lies_inside_its_parent(runs, mode):
    sys_, states = _get(runs, mode)
    assert "OK" in states
    spans = sys_.tracer.spans()
    assert sys_.tracer.dropped == 0 and spans
    by_id = {s.id: s for s in spans}
    assert len(by_id) == len(spans)
    for s in spans:
        assert s.t0_ns <= s.t1_ns
        if s.parent == 0:
            assert s.name in ("system.track", "system.shutdown",
                              "mapper.keyframe"), s
            continue
        p = by_id[s.parent]
        assert p.t0_ns <= s.t0_ns and s.t1_ns <= p.t1_ns, (p, s)
        assert p.thread == s.thread


def test_a_track_call_s_spans_carry_its_frame_id(runs):
    sys_, states = _get(runs, "sync")
    spans = sys_.tracer.spans()
    kids = _children(spans)
    roots = [s for s in spans if s.parent == 0 and s.name != "system.shutdown"]
    assert [s.frame for s in roots] == list(range(len(states)))
    # the mapper's spans carry its keyframe's frame: the initial map's
    # first keyframe is an earlier frame's
    first = sys_.map.keyframes[sys_.map.origin_kid].frame_id
    (init,) = [int(e.split()[0][5:]) for e in sys_.tracker.events
               if e.startswith("INIT@")]
    for r in roots:
        assert r.name == "system.track"
        inner = _descendants(r.id, kids)
        assert inner and r.frame in {s.frame for s in inner}
        assert {s.frame for s in inner} - {r.frame} <= (
            {first} if r.frame == init else set())


def test_deferred_frames_carry_the_processed_frame_id(runs):
    sys_, _ = _get(runs, "deferred")
    spans = sys_.tracer.spans()
    kids = _children(spans)
    by_id = {s.id: s for s in spans}
    frames = [s for s in spans if s.name == "tracker.frame"]
    fused = [s for s in frames if s.attrs["path"] == "fused"]
    assert fused
    for s in frames:
        root = s
        while root.parent:
            root = by_id[root.parent]
        # processed a batch behind the call that submitted it, or by the
        # flush at shutdown
        assert (s.frame < root.frame if root.name == "system.track"
                else root.name == "system.shutdown")
        assert {d.frame for d in _descendants(s.id, kids)} <= {s.frame}
    published = {fid for fid, *_ in sys_.tracker.trajectory}
    assert {s.frame for s in fused} <= published


def test_local_ba_is_pack_solve_unpack(runs):
    sys_, _ = _get(runs, "sync")
    spans = sys_.tracer.spans()
    kids = _children(spans)
    bas = [s for s in spans if s.name == "mapper.local_ba"]
    assert len(bas) == len(sys_.mapper.timer.samples["local_ba"]) >= 3
    cfg = sys_.cfg.ba
    n_chunks = -(-(cfg.local_iters_a + cfg.local_iters_b) // cfg.abort_chunk)
    shapes = []
    for b in bas:
        children = kids[b.id]
        assert [c.name for c in children] == ["ba.pack", "ba.solve", "ba.unpack"]
        pack, solve, unpack = children
        shapes.append(solve.attrs["shape"])
        waits = [c for c in kids.get(solve.id, []) if c.name == "device.wait"]
        assert [w.attrs["kind"] for w in waits] == ["ba_chunk"] * n_chunks
        waits = [c for c in kids.get(unpack.id, []) if c.name == "device.wait"]
        assert [w.attrs["kind"] for w in waits] == ["readback"]
    assert shapes == sys_.mapper.ba_shapes


def test_mapping_thread_spans_are_their_own_roots(runs):
    sys_, _ = _get(runs, "async")
    spans = sys_.tracer.spans()
    kids = _children(spans)
    track_threads = {s.thread for s in spans if s.name == "system.track"}
    roots = [s for s in spans if s.name == "mapper.keyframe"]
    assert len(track_threads) == 1 and roots
    # the frames made keyframes: by the policy, and the initial map's two
    kf_frames = {s.frame for s in spans if s.name == "tracker.keyframe"}
    kf_frames |= {int(e.split()[0][5:]) for e in sys_.tracker.events
                  if e.startswith("INIT@")}
    kf_frames.add(sys_.map.keyframes[sys_.map.origin_kid].frame_id)
    for r in roots:
        assert r.parent == 0 and r.thread not in track_threads
        assert r.frame in kf_frames
        inner = _descendants(r.id, kids)
        assert {"mapper.triangulate", "mapper.fuse"} <= {s.name for s in inner}
        assert {s.frame for s in inner} == {r.frame}
    for s in spans:
        if s.name == "tracker.keyframe":
            assert not [c for c in _descendants(s.id, kids)
                        if c.name.startswith("mapper.")]


def test_keyframe_two_view_and_loop_spans(runs):
    sys_, _ = _get(runs, "sync")
    spans = sys_.tracer.spans()
    by_id = {s.id: s for s in spans}
    n_kf = sum(e.startswith("KF@") for e in sys_.tracker.events)
    kfs = [s for s in spans if s.name == "tracker.keyframe"]
    assert len(kfs) == n_kf >= 3
    for s in spans:
        if s.name == "mapper.keyframe":
            assert by_id[s.parent].name in ("tracker.keyframe",
                                            "tracker.initialize")
        if s.name in ("loop.detect", "mapper.cull", "mapper.connections"):
            assert by_id[s.parent].name == "mapper.keyframe"
        if s.name == "tracker.two_view":
            assert by_id[s.parent].name == "tracker.initialize"
    assert sum(s.name == "tracker.two_view" for s in spans) >= 1
    waits = {s.attrs["kind"] for s in spans if s.name == "device.wait"}
    assert {"readback", "ba_chunk"} <= waits
    ups = [s for s in spans if s.name == "device.upload"]
    assert ups and all(s.attrs["bytes"] > 0 for s in ups)


@pytest.mark.parametrize("mode", ["sync", "async", "deferred"])
def test_stage_timers_keep_their_keys_one_span_per_sample(runs, mode):
    sys_, _ = _get(runs, mode)
    spans = sys_.tracer.spans()
    timers = _timers(sys_)
    assert {c: set(t.samples) for c, t in timers.items()} == KEYS[mode]
    for comp, timer in timers.items():
        for key, xs in timer.samples.items():
            mine = [s for s in spans if s.name == f"{comp}.{key}"]
            assert len(mine) == len(xs), (comp, key)
            np.testing.assert_allclose(
                sorted(1e-9 * (s.t1_ns - s.t0_ns) for s in mine), sorted(xs),
                rtol=0, atol=1e-9)


def test_the_removed_timers_are_gone(runs):
    sys_, _ = _get(runs, "sync")
    assert not hasattr(sys_, "frame_intervals")
    assert not hasattr(sys_.mapper, "ba_intervals")
    assert not hasattr(sys_.tracker, "two_view_ms")
    assert sys_.mapper.ba_shapes and all(
        len(s) == 3 and all(isinstance(x, int) for x in s)
        for s in sys_.mapper.ba_shapes)


def test_a_span_without_a_recorder_does_nothing():
    assert profiling.current() is None
    rec = profiling.SpanRecorder()
    timer = profiling.StageTimer("tracker")
    with profiling.span("device.wait", kind="readback"):
        pass
    with timer("track"):
        pass
    assert len(timer.samples["track"]) == 1
    assert rec.spans() == [] and rec.dropped == 0
    with rec.activate():
        assert profiling.current() is rec
        with timer("track"), profiling.span("device.wait", kind="readback"):
            pass
    assert profiling.current() is None
    track, wait = rec.spans()
    assert (track.name, track.parent, track.frame) == ("tracker.track", 0, -1)
    assert (wait.name, wait.parent, wait.attrs) == ("device.wait", track.id,
                                                    {"kind": "readback"})
    assert len(timer.samples["track"]) == 2


def test_overflow_is_counted():
    rec = profiling.SpanRecorder(capacity=4)
    t0 = time.perf_counter_ns()
    with rec.activate():
        for k in range(10):
            with profiling.span("device.upload", frame=k, bytes=k):
                pass
    spans = rec.spans()
    assert rec.dropped == 6
    assert [s.frame for s in spans] == [6, 7, 8, 9]
    assert rec.dropped_since(t0) == 6
    # a window that starts with the oldest span kept has lost none
    assert rec.dropped_since(spans[0].t0_ns) == 0
    assert [s.frame for s in rec.spans(spans[1].t0_ns, spans[2].t0_ns)] == [7, 8]


def test_activation_nests_and_restores():
    a, b = profiling.SpanRecorder(), profiling.SpanRecorder()
    with a.activate(), profiling.span("system.track", frame=3):
        with a.activate(), profiling.span("tracker.track"):
            pass
        with b.activate():
            with profiling.span("mapper.keyframe", frame=7):
                pass
        with profiling.span("tracker.keyframe"):
            pass
    assert profiling.current() is None
    track, inner, kf = a.spans()
    assert inner.parent == kf.parent == track.id
    assert inner.frame == kf.frame == 3
    (other,) = b.spans()
    assert other.parent == 0 and other.frame == 7
