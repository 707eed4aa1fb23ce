"""slambench/spans.py and slambench/span_report.py on the CPU: the readers
of the program's spans on hand-built spans (None without spans, as against
a program that records none, and None when spans were dropped), the
innermost-span timeline and the gap labels, the busy share inside the BA
solves on a synthetic trace, and one small traced run of the orbit cell
with a stand-in for the device trace."""

import time
from typing import NamedTuple, Optional

import pytest

from slambench import harness, span_report, spans
from slambench.tests.small import small_cell

T = 1_000_000_000   # host clock origin of the hand-built spans (ns)


class Span(NamedTuple):
    """A span as the program records it (utils/profiling.py::Span)."""

    name: str
    t0_ns: int
    t1_ns: int
    id: int
    parent: int
    frame: int
    thread: int
    attrs: Optional[dict]


def sp(sid, name, t0, t1, parent=0, frame=0, thread=1, **attrs):
    return Span(name, T + t0, T + t1, sid, parent, frame, thread, attrs or None)


def frame_spans():
    """Two frames: a keyframe call with local BA, and a plain call."""
    return [
        sp(1, "system.track", 0, 1000),
        sp(2, "tracker.fused", 10, 300, 1),
        sp(3, "device.wait", 200, 290, 2, kind="readback"),
        sp(4, "tracker.track", 310, 990, 1),
        sp(5, "tracker.keyframe", 320, 980, 4),
        sp(6, "mapper.keyframe", 330, 970, 5),
        sp(7, "mapper.local_ba", 400, 900, 6),
        sp(8, "ba.pack", 400, 500, 7),
        sp(9, "ba.solve", 500, 800, 7, shape=(8, 256, 1024)),
        sp(10, "device.wait", 600, 700, 9, kind="ba_chunk"),
        sp(11, "ba.unpack", 800, 900, 7),
        sp(12, "device.wait", 800, 850, 11, kind="readback"),
        sp(13, "loop.detect", 900, 960, 6),
        sp(20, "system.track", 1100, 1500, frame=1),
        sp(21, "tracker.fused", 1110, 1400, 20, frame=1),
        sp(22, "device.wait", 1300, 1390, 21, frame=1, kind="readback"),
    ]


@pytest.mark.parametrize("got,dropped", [(None, 0), ([], 0), ("spans", 3)])
def test_readers_read_nothing_without_spans_or_with_spans_dropped(got, dropped):
    got = frame_spans() if got == "spans" else got
    assert spans.host_wait_ms_per_frame(got, dropped, 2) is None
    assert spans.host_waits_per_frame(got, dropped, 2) is None
    assert spans.ba_pack_ms_per_kf(got, dropped, 1) is None
    assert spans.loop_detect_ms_per_kf(got, dropped, 1) is None
    assert spans.ba_solve_busy(got, dropped, [("k", T, T + 1)], 0) is None
    assert spans.summary(got, dropped, [], T, T + 2000, 0, 2) is None


def test_readers_on_hand_built_spans():
    got = frame_spans()
    assert spans.host_wait_ms_per_frame(got, 0, 2) == pytest.approx(1e-6 * 330 / 2)
    assert spans.host_waits_per_frame(got, 0, 2) == 2.0
    assert spans.ba_pack_ms_per_kf(got, 0, 1) == pytest.approx(1e-6 * 200)
    assert spans.loop_detect_ms_per_kf(got, 0, 1) == pytest.approx(1e-6 * 60)
    assert spans.host_waits_per_frame(got, 0, 0) is None


def test_window_reads_the_program_s_recorder_or_nothing():
    from orbslam2_dualcam_tpu_torch.utils.profiling import SpanRecorder, span

    class Parent:                     # a program without a recorder
        pass

    assert spans.window(Parent(), 0, 10 ** 30) == (None, 0)
    prog = Parent()
    prog.tracer = SpanRecorder(capacity=2)
    with prog.tracer.activate():
        with span("system.track", frame=0):
            pass
        t = time.perf_counter_ns()
        with span("system.track", frame=1):
            pass
    got, dropped = spans.window(prog, t, 10 ** 30)
    assert [s.frame for s in got] == [1] and dropped == 0
    with prog.tracer.activate():
        for k in range(2):
            with span("system.track", frame=2 + k):
                pass
    got, dropped = spans.window(prog, t, 10 ** 30)
    assert [s.frame for s in got] == [2, 3] and dropped == 2


def test_ba_solve_busy_interval_arithmetic():
    got = frame_spans()
    off = 5_000                        # trace clock = host clock + off
    solve0, solve1 = T + 500 + off, T + 800 + off
    events = [("k_before", solve0 - 50, solve0 + 20),   # 20 inside
              ("k_a", solve0 + 100, solve0 + 150),      # 50, overlaps k_b
              ("k_b", solve0 + 120, solve0 + 200),      # 50 more
              ("Memcpy DtoH", solve1 - 10, solve1 + 30),  # 10 inside
              ("k_after", solve1 + 40, solve1 + 90)]
    assert spans.ba_solve_busy(got, 0, events, off) == pytest.approx(100.0 * 130 / 300)
    assert spans.union([(5, 9), (1, 3), (2, 4), (9, 9)]) == [(1, 4), (5, 9)]
    assert spans.overlap([(1, 4), (5, 9)], 3, 6) == 2
    assert spans.ba_solve_busy([sp(1, "system.track", 0, 9)], 0, events, off) is None


def test_timeline_names_the_innermost_span_across_threads():
    got = frame_spans() + [sp(30, "mapper.keyframe", 1150, 1450, frame=0, thread=2),
                           sp(31, "mapper.local_ba", 1200, 1350, 30, frame=0, thread=2),
                           sp(32, "ba.solve", 1220, 1300, 31, frame=0, thread=2)]
    tl = spans.Timeline(got)
    assert tl.depth[12] == 6 and tl.depth[30] == 0
    at = {t: tl.at(T + t) for t in (5, 250, 550, 650, 820, 950, 1050, 1120, 1250, 1395)}
    assert {t: (s.name if s else None) for t, s in at.items()} == {
        5: "system.track", 250: "device.wait", 550: "ba.solve", 650: "device.wait",
        820: "device.wait", 950: "loop.detect", 1050: None,
        1120: "tracker.fused", 1250: "ba.solve", 1395: "tracker.fused"}
    by = tl.time_by_span([(T + 1000, T + 1120), (T + 600, T + 700)])
    assert by == {None: 100, "system.track": 10, "tracker.fused": 10, "device.wait": 100}


def test_labels_keep_the_call_and_name_the_innermost_span():
    got = frame_spans()
    off = 7
    calls = [(T, T + 1000, "track, keyframe"), (T + 1100, T + 1500, "track")]
    name = spans.label(calls, spans.Timeline(got), {s.id: s for s in got}, off)
    assert name(T + 450 + off) == "track, keyframe | mapper.local_ba > ba.pack"
    assert name(T + 5 + off) == "track, keyframe | system.track"
    assert name(T + 1200 + off) == "track | tracker.fused"
    assert name(T + 1050 + off) == "between calls"
    assert spans.label(calls, None, {}, off)(T + 450 + off) == "track, keyframe"


def test_summary_puts_idle_time_and_kernels_on_spans():
    got = frame_spans()
    events = [("k1", T + 0, T + 200), ("k2", T + 500, T + 600),
              ("Memcpy HtoD", T + 1100, T + 1300)]
    s = spans.summary(got, 0, events, T, T + 1500, 0, 2)
    assert s["spans"] == 16 and s["spans_per_frame"] == 8.0
    assert s["idle_s"] == pytest.approx(1e-9 * (300 + 500 + 200))
    idle = dict(s["idle_s_by_span"])
    assert idle[None] == pytest.approx(1e-9 * 100)                 # between the calls
    assert idle["device.wait"] == pytest.approx(1e-9 * (90 + 100 + 50 + 90))
    roots = idle["system.track"]
    assert s["idle_below_root_share"] == pytest.approx(1 - (roots + idle[None]) / s["idle_s"])
    assert dict(s["kernels_by_span"]) == {"system.track": 1, "ba.solve": 1}
    assert spans.idle_intervals(events, T, T + 1500) == [
        (T + 200, T + 500), (T + 600, T + 1100), (T + 1300, T + 1500)]


class _NoDevice:
    """The device trace's stand-in on the CPU: only the marker kernel, at
    the host's mark, so that the trace clock is the host's."""

    def __init__(self, device) -> None:
        pass

    def __enter__(self):
        self.host_mark_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def events(self):
        return [("marker", self.host_mark_ns, self.host_mark_ns + 1)]


def test_traced_run_reads_the_spans_of_a_small_orbit(monkeypatch):
    monkeypatch.setattr(harness, "DeviceTrace", _NoDevice)
    b, w, cfg, traffic, limits = small_cell("mono_tum1.orbit")
    rep = span_report.traced_run(w, cfg, traffic, limits, 2147490011, 6.0, "cpu",
                                 time.perf_counter(), b)
    assert harness.build_system.__name__ == "build_system" and rep["frames"] > 0
    assert rep["spans_dropped"] == 0
    m = rep["span_metrics"]
    assert m["host_wait_ms_per_frame"] > 0 and m["host_waits_per_frame"] >= 1
    assert m["ba_solve_busy"] == 0.0          # no device activity on the CPU
    if rep["keyframes"]:
        assert m["ba_pack_ms_per_kf"] > 0 and m["loop_detect_ms_per_kf"] > 0
    s = rep["summary"]
    assert s["spans_per_frame"] > 5 and s["idle_below_root_share"] > 0.5
    assert [g[0].split(" | ")[0] for g in rep["idle_gaps"]] == \
        [g[0] for g in rep["breakdown_idle_gaps"]]
    assert rep["host_ms_per_frame_by_span"]
