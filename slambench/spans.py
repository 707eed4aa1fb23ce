"""The program's spans over the window, read beside the device trace.

The port keeps spans (orbslam2_dualcam_tpu_torch/utils/profiling.py): a
name, start and end on `time.perf_counter_ns` (the clock the harness
stamps its calls with), the enclosing span, the frame id, the thread and a
few attributes.  A System holds them as `system.tracer`; a program without
one yields nothing here, and every function below then returns None.

What is read from them:

- the window's spans, those that start inside it, and whether any of them
  was dropped (`window`);
- the innermost span open at each host time (`Timeline`), which names the
  device's idle gaps and the kernels by layer;
- host_wait_ms_per_frame, host_waits_per_frame (`device.wait` spans),
  ba_pack_ms_per_kf (`ba.pack` + `ba.unpack`), loop_detect_ms_per_kf
  (`loop.detect`) and ba_solve_busy (the device's busy share inside the
  `ba.solve` spans).

Trace times are the profiler's; `off` is the trace clock less the host's,
as the harness finds it from its marker kernel.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Sequence, Tuple

COPY = ("Memcpy", "Memset")


def window(system, t0_ns: int, t1_ns: int) -> Tuple[Optional[list], int]:
    """(spans that start in [t0_ns, t1_ns], spans dropped since t0_ns);
    (None, 0) for a program that records none."""
    rec = getattr(system, "tracer", None)
    if rec is None:
        return None, 0
    return rec.spans(t0_ns, t1_ns), rec.dropped_since(t0_ns)


def usable(spans, dropped: int) -> bool:
    return bool(spans) and dropped == 0


def _total_ns(spans, names: Sequence[str]) -> int:
    return sum(s.t1_ns - s.t0_ns for s in spans if s.name in names)


def host_wait_ms_per_frame(spans, dropped: int, n_frames: int):
    """Milliseconds the host waited on the card (`device.wait` spans) per
    frame submitted."""
    if not usable(spans, dropped) or n_frames <= 0:
        return None
    return 1e-6 * _total_ns(spans, ("device.wait",)) / n_frames


def host_waits_per_frame(spans, dropped: int, n_frames: int):
    """`device.wait` spans per frame submitted."""
    if not usable(spans, dropped) or n_frames <= 0:
        return None
    return sum(s.name == "device.wait" for s in spans) / n_frames


def ba_pack_ms_per_kf(spans, dropped: int, n_kf: int):
    """Milliseconds of BA packing and unpacking on the host per keyframe."""
    if not usable(spans, dropped) or n_kf <= 0:
        return None
    return 1e-6 * _total_ns(spans, ("ba.pack", "ba.unpack")) / n_kf


def loop_detect_ms_per_kf(spans, dropped: int, n_kf: int):
    """Milliseconds of loop detection per keyframe."""
    if not usable(spans, dropped) or n_kf <= 0:
        return None
    return 1e-6 * _total_ns(spans, ("loop.detect",)) / n_kf


def union(intervals: Sequence[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """Sorted, merged intervals."""
    out: List[list] = []
    for a, b in sorted(intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def overlap(merged: Sequence[Tuple[int, int]], a: int, b: int) -> int:
    """Length of [a, b] covered by sorted, merged intervals."""
    i = max(0, bisect.bisect_right(merged, (a, a)) - 1)
    got = 0
    while i < len(merged) and merged[i][0] < b:
        lo, hi = max(merged[i][0], a), min(merged[i][1], b)
        if hi > lo:
            got += hi - lo
        i += 1
    return got


def ba_solve_busy(spans, dropped: int, events, off: int):
    """The union of device intervals (kernels and copies) inside the
    `ba.solve` spans over their summed length, in percent.  The solve ends
    in a synchronize, so its kernels end inside it."""
    if not usable(spans, dropped) or events is None:
        return None
    solves = [(s.t0_ns + off, s.t1_ns + off) for s in spans if s.name == "ba.solve"]
    total = sum(b - a for a, b in solves)
    if total <= 0:
        return None
    busy = union([(s, e) for _, s, e in events])
    return 100.0 * sum(overlap(busy, a, b) for a, b in solves) / total


def depths(spans) -> Dict[int, int]:
    """Depth of each span (a root is 0); a span whose parent is not among
    `spans` counts as a root."""
    by_id = {s.id: s for s in spans}
    out: Dict[int, int] = {}
    for s in spans:
        chain, x = [], s
        while x.id not in out:
            chain.append(x)
            p = by_id.get(x.parent)
            if p is None:
                out[x.id] = 0
                chain.pop()
                break
            x = p
        d = out[x.id]
        for y in reversed(chain):
            d += 1
            out[y.id] = d
    return out


class Timeline:
    """The innermost span open at each host time: pieces (t0, t1, span),
    in order and apart.  A thread's spans nest; where threads overlap the
    deepest span wins."""

    def __init__(self, spans) -> None:
        self.depth = depths(spans)
        threads: Dict[int, list] = {}
        for s in spans:
            threads.setdefault(s.thread, []).append(s)
        pieces = [self._thread_pieces(v) for v in threads.values()]
        self.pieces = pieces[0] if len(pieces) == 1 else self._merge(pieces)
        self.starts = [p[0] for p in self.pieces]

    @staticmethod
    def _thread_pieces(spans) -> list:
        ev = []
        for s in spans:
            ev.append((s.t0_ns, 1, s))
            ev.append((s.t1_ns, 0, s))
        # at one time: ends before starts, and the outer start first
        ev.sort(key=lambda e: (e[0], e[1], -e[2].t1_ns if e[1] else 0))
        out, stack, last = [], [], None
        for t, kind, s in ev:
            if stack and last is not None and t > last:
                out.append((last, t, stack[-1]))
            last = t
            if kind:
                stack.append(s)
            elif s in stack:
                stack.remove(s)
        return out

    def _merge(self, pieces: List[list]) -> list:
        bounds = sorted({t for ps in pieces for p in ps for t in p[:2]})
        idx = [0] * len(pieces)
        out = []
        for a, b in zip(bounds, bounds[1:]):
            best = None
            for k, ps in enumerate(pieces):
                while idx[k] < len(ps) and ps[idx[k]][1] <= a:
                    idx[k] += 1
                if idx[k] < len(ps) and ps[idx[k]][0] <= a:
                    s = ps[idx[k]][2]
                    if best is None or self.depth[s.id] > self.depth[best.id]:
                        best = s
            if best is None:
                continue
            if out and out[-1][2] is best and out[-1][1] == a:
                out[-1] = (out[-1][0], b, best)
            else:
                out.append((a, b, best))
        return out

    def at(self, t_ns: int):
        """The innermost span open at host time t_ns, or None."""
        i = bisect.bisect_right(self.starts, t_ns) - 1
        if i >= 0 and self.pieces[i][0] <= t_ns < self.pieces[i][1]:
            return self.pieces[i][2]
        return None

    def time_by_span(self, intervals: Sequence[Tuple[int, int]]) -> Dict[str, int]:
        """Nanoseconds of sorted, apart host intervals by the name of the
        innermost span open over them; None where no span is open."""
        out: Dict[str, int] = {}
        pieces, i = self.pieces, 0
        for a, b in intervals:
            covered = 0
            i = max(0, bisect.bisect_right(self.starts, a) - 1)
            while i < len(pieces) and pieces[i][0] < b:
                lo, hi = max(pieces[i][0], a), min(pieces[i][1], b)
                if hi > lo:
                    name = pieces[i][2].name
                    out[name] = out.get(name, 0) + hi - lo
                    covered += hi - lo
                i += 1
            if b - a > covered:
                out[None] = out.get(None, 0) + (b - a - covered)
        return out


def idle_intervals(events, win0: int, win1: int) -> List[Tuple[int, int]]:
    """The gaps between device activities inside [win0, win1] (trace
    clock), in order."""
    busy = union([(max(s, win0), min(e, win1)) for _, s, e in events])
    out, cur = [], win0
    for a, b in busy:
        if a > cur:
            out.append((cur, a))
        cur = max(cur, b)
    if win1 > cur:
        out.append((cur, win1))
    return out


def path_of(span, by_id, n: int = 2) -> str:
    """`parent > span`: the span and up to n - 1 of its ancestors below
    the root, outermost first; a root's name alone."""
    names = [span.name]
    p = by_id.get(span.parent)
    while p is not None and p.parent in by_id and len(names) < n:
        names.append(p.name)
        p = by_id.get(p.parent)
    return " > ".join(reversed(names))


def summary(spans, dropped: int, events, win0: int, win1: int, off: int,
            n_frames: int, top: int = 10) -> Optional[dict]:
    """For a traced window: spans per frame, the device's idle seconds by
    innermost span (top `top`), kernels by the span open when they started
    (top `top`), and the idle share under a span deeper than a root."""
    if not usable(spans, dropped) or n_frames <= 0:
        return None
    tl = Timeline(spans)
    idle = [(a - off, b - off) for a, b in idle_intervals(events, win0, win1)]
    by = tl.time_by_span(idle)
    idle_ns = sum(by.values())
    roots = {s.name for s in spans if tl.depth[s.id] == 0}
    deeper = sum(v for k, v in by.items() if k is not None and k not in roots)
    kern: Dict[str, int] = {}
    for name, s, e in events:
        if name.startswith(COPY) or not win0 <= s <= win1:
            continue
        sp = tl.at(s - off)
        key = sp.name if sp is not None else None
        kern[key] = kern.get(key, 0) + 1
    return {
        "spans": len(spans),
        "spans_per_frame": len(spans) / n_frames,
        "idle_s": 1e-9 * idle_ns,
        "idle_below_root_share": deeper / idle_ns if idle_ns else None,
        "idle_s_by_span": [[k, 1e-9 * v] for k, v in
                           sorted(by.items(), key=lambda kv: -kv[1])[:top]],
        "kernels_by_span": [[k, v] for k, v in
                            sorted(kern.items(), key=lambda kv: -kv[1])[:top]],
    }


def label(calls, timeline: Optional[Timeline], by_id, off: int):
    """The harness's gap label with the program's innermost span appended:
    `track, keyframe | mapper.local_ba > ba.pack`."""
    def name(t_ns):
        h = t_ns - off
        lab = "between calls"
        for a, b, what in calls:
            if a <= h <= b:
                lab = what
                break
        sp = timeline.at(h) if timeline is not None else None
        return lab if sp is None else f"{lab} | {path_of(sp, by_id)}"
    return name
