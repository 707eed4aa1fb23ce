"""One traced run of a cell, with the program's spans read beside the trace.

    python3 -m slambench.span_report --workload <cell> --seed <n> --seconds <s>

runs the cell as `slambench.run --trace 1` does (the harness unchanged)
and adds, on standard error and as the last line of standard output, what
slambench/spans.py reads from the program's spans over the window: spans
per frame and dropped, the device's idle seconds by innermost span, kernels
by the span open when they started, the share of idle seconds under a span
deeper than a root, the idle gaps named by span, and
host_wait_ms_per_frame, host_waits_per_frame, ba_pack_ms_per_kf,
ba_solve_busy, loop_detect_ms_per_kf; besides, host milliseconds per frame
by span (self and inclusive), the waits by kind, the window's tracker
events by kind and its frames by path.  Against a program that records no
spans the span readings are null.  With --out, the line is also written to that file.
"""

from __future__ import annotations

import time

T_PROCESS0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    root = Path.cwd()
    from slambench import run as bench_run
    bench_run.cache_dirs(root)
    from slambench import harness

    bench = harness.load_json(root / "BENCHMARK.json")
    w, config_entry = bench_run.find(bench, args.workload)
    import torch
    if not torch.cuda.is_available():
        print("slambench.span_report: needs a CUDA device", file=sys.stderr)
        return 3
    here = Path(harness.__file__).resolve().parent
    config = harness.load_json(root / config_entry["file"])
    traffic = harness.load_json(here / "traffic" / f"{w['traffic']}.json")
    limits = harness.load_json(here / "limits" / f"{w['name']}.json")
    report = traced_run(w, config, traffic, limits, args.seed, args.seconds,
                        torch.device("cuda", 0), T_PROCESS0, bench)
    report["device"] = torch.cuda.get_device_name(0)
    line = json.dumps(report)
    print(f"  spans: {line}", file=sys.stderr)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)
    return 0


def traced_run(w: dict, config: dict, traffic: dict, limits: dict, seed: int,
               seconds: float, device, t_process0: float, bench: dict) -> dict:
    """harness.run_cell with the trace on, the system's spans taken over
    the window as the trace is summarized; returns the report."""
    from slambench import harness, spans
    from slambench.stats import keyframes

    seen = {}
    build_system, summarize_trace = harness.build_system, harness.summarize_trace

    def keep_system(*a, **k):
        seen["system"] = build_system(*a, **k)
        return seen["system"]

    def read_spans(events, win0, win1, labels):
        calls, off = labels.__defaults__
        got, dropped = spans.window(seen.pop("system"), win0 - off, win1 - off)
        seen.update(spans=got, dropped=dropped, events=events, win=(win0, win1),
                    off=off, calls=calls)
        return summarize_trace(events, win0, win1, labels)

    harness.build_system, harness.summarize_trace = keep_system, read_spans
    try:
        out = harness.run_cell(w, config, traffic, limits, seed, seconds, True, device,
                               t_process0, bench["end_to_end"], bench["per_layer"])
    finally:
        harness.build_system, harness.summarize_trace = build_system, summarize_trace
    run = out["run"]
    got, dropped, events, off = seen["spans"], seen["dropped"], seen["events"], seen["off"]
    n_frames, n_kf = len(run.submitted), keyframes(run)
    report = {
        "workload": w["name"], "seed": seed, "correct": bool(out["correct"]),
        "frames": n_frames, "keyframes": n_kf, "fused_frames": run.fused_frames,
        "events": event_counts(run.events),
        "spans_dropped": dropped if got is not None else None,
        "metrics": {k: v["value"] for k, v in out["metrics"].items()},
        "breakdown_idle_gaps": out["trace"]["idle_gaps"],
        "span_metrics": {
            "host_wait_ms_per_frame": spans.host_wait_ms_per_frame(got, dropped, n_frames),
            "host_waits_per_frame": spans.host_waits_per_frame(got, dropped, n_frames),
            "ba_pack_ms_per_kf": spans.ba_pack_ms_per_kf(got, dropped, n_kf),
            "ba_solve_busy": spans.ba_solve_busy(got, dropped, events, off),
            "loop_detect_ms_per_kf": spans.loop_detect_ms_per_kf(got, dropped, n_kf)},
        "summary": spans.summary(got, dropped, events, *seen["win"], off, n_frames),
    }
    if spans.usable(got, dropped):
        tl = spans.Timeline(got)
        name = spans.label(seen["calls"], tl, {s.id: s for s in got}, off)
        report["idle_gaps"] = [[name(a + g // 2), 1e-9 * g]
                               for a, g in gap_starts(out["trace"], events, *seen["win"])]
        waits: dict = {}
        for s in got:
            if s.name == "device.wait":
                n, ns = waits.get(s.attrs["kind"], (0, 0))
                waits[s.attrs["kind"]] = (n + 1, ns + s.t1_ns - s.t0_ns)
        report["waits_by_kind"] = {k: {"n": n, "ms_per_frame": 1e-6 * ns / n_frames}
                                   for k, (n, ns) in waits.items()}
        report["host_ms_per_frame_by_span"] = host_ms_by_span(got, n_frames)
        report["host_ms_per_frame_in_span"] = {
            k: 1e-6 * v / n_frames for k, v in sorted(
                total_ns_by_name(got).items(), key=lambda kv: -kv[1])}
        paths: dict = {}
        for s in got:
            if s.name == "tracker.frame":
                paths[s.attrs["path"]] = paths.get(s.attrs["path"], 0) + 1
        report["tracker_frames_by_path"] = paths
    return report


def event_counts(events) -> dict:
    """The tracker's events of the window by kind (the text before `@`)."""
    out: dict = {}
    for e in events:
        k = e.split("@", 1)[0]
        out[k] = out.get(k, 0) + 1
    return out


def total_ns_by_name(got) -> dict:
    """Nanoseconds inside the spans of each name, children included."""
    out: dict = {}
    for s in got:
        out[s.name] = out.get(s.name, 0) + s.t1_ns - s.t0_ns
    return out


def gap_starts(trace: dict, events, win0: int, win1: int):
    """(start on the trace clock, nanoseconds) of the harness's longest idle
    gaps, found again from the events as the harness finds them."""
    from slambench import spans
    gaps = sorted(((b - a, a) for a, b in spans.idle_intervals(events, win0, win1)),
                  reverse=True)[:len(trace["idle_gaps"])]
    return [(a, g) for g, a in gaps]


def host_ms_by_span(got, n_frames: int) -> dict:
    """Host milliseconds per frame by span name, each span less its
    children (self time), largest first."""
    own = {s.id: s.t1_ns - s.t0_ns for s in got}
    by_id = {s.id: s for s in got}
    for s in got:
        if s.parent in by_id and by_id[s.parent].thread == s.thread:
            own[s.parent] -= s.t1_ns - s.t0_ns
    out: dict = {}
    for s in got:
        out[s.name] = out.get(s.name, 0) + own[s.id]
    return {k: 1e-6 * v / n_frames for k, v in sorted(out.items(), key=lambda kv: -kv[1])}


if __name__ == "__main__":
    raise SystemExit(main())
