"""Per-stage host timing and the port's span recorder.

`StageTimer` is the port's own copy of
orbslam2_dualcam_tpu/utils/profiling.py::StageTimer: wall-clock seconds per
named stage in `samples`, with summary statistics.  It times the host: a
stage that only queues work on the card and reads nothing back shows its
queueing time, not the card's.

`SpanRecorder` keeps spans.  A span is a named interval on
`time.perf_counter_ns` (the clock a caller stamps its own calls with), with
the id of its enclosing span, the id of the frame it works on, its thread
and a few attributes.  A System owns one recorder, shared by its tracker,
mapper and loop closer, and makes it the thread's current recorder while it
works (`SpanRecorder.activate`): in `System.track` and on the mapping
thread.  Every StageTimer stage is also a span `<component>.<stage>` of the
current recorder, and `span(name)` opens one from code that holds no
handle on a System.  With no current recorder a stage only keeps its
sample and `span` does nothing.

A recorder keeps the newest `capacity` spans at least; once it holds an
eighth more, the oldest beyond `capacity` are dropped, and counted in
`dropped`.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import defaultdict
from typing import Dict, List, NamedTuple, Optional

# spans kept per recorder: the benchmark's busier cell (mono_tum1.orbit)
# records 79-84 spans per frame at about one frame per second on the H100
# (PERF.md), about 4,300 in a 51 s window; this keeps fifteen such windows
_CAPACITY = 1 << 16

_perf_ns = time.perf_counter_ns
_get_ident = threading.get_ident
# .rec: the thread's current recorder; .stack: its open spans, innermost last
_tls = threading.local()


class Span(NamedTuple):
    name: str
    t0_ns: int
    t1_ns: int
    id: int
    parent: int                 # id of the enclosing span; 0 for a root
    frame: int                  # id of the frame worked on; -1 for none
    thread: int                 # threading.get_ident() of its thread
    attrs: Optional[dict]       # e.g. {"kind": "readback"}, {"bytes": n}


def current() -> Optional["SpanRecorder"]:
    """The thread's current recorder, or None."""
    return getattr(_tls, "rec", None)


class _Open:
    """One span while it is open; also a StageTimer stage, which appends
    its duration to `timer.samples[stage]` whether or not a recorder is
    current."""

    __slots__ = ("rec", "name", "frame", "attrs", "timer", "stage", "t0",
                 "id", "parent", "stack")

    def __init__(self, rec, name, frame, attrs, timer=None, stage=None):
        self.rec, self.name, self.frame, self.attrs = rec, name, frame, attrs
        self.timer, self.stage = timer, stage

    def __enter__(self):
        rec = self.rec
        if rec is not None:
            stack = self.stack = _tls.stack
            if stack:
                top = stack[-1]
                self.parent = top.id
                if self.frame is None:
                    self.frame = top.frame
            else:
                self.parent = 0
                if self.frame is None:
                    self.frame = -1
            self.id = next(rec._ids)
            stack.append(self)
        self.t0 = _perf_ns()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = _perf_ns()
        if self.timer is not None:
            self.timer.samples[self.stage].append((t1 - self.t0) * 1e-9)
        rec = self.rec
        if rec is not None:
            self.stack.pop()
            buf = rec._buf
            buf.append((self.name, self.t0, t1, self.id, self.parent,
                        self.frame, _get_ident(), self.attrs))
            if len(buf) > rec._limit:
                rec._trim()
        return False


class _NoSpan:
    """`span()` with no current recorder."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NO_SPAN = _NoSpan()


def span(name: str, frame: Optional[int] = None, **attrs):
    """A span of the current recorder, as a context manager: `frame`
    defaults to the enclosing span's.  A no-op without a recorder."""
    rec = getattr(_tls, "rec", None)
    if rec is None:
        return _NO_SPAN
    return _Open(rec, name, frame, attrs or None)


class _Activation:
    __slots__ = ("rec", "prev")

    def __init__(self, rec) -> None:
        self.rec = rec

    def __enter__(self):
        self.prev = (getattr(_tls, "rec", None), getattr(_tls, "stack", None))
        if self.prev[0] is not self.rec:
            # a recorder's spans nest only in its own spans
            _tls.rec, _tls.stack = self.rec, []
        return self.rec

    def __exit__(self, *exc) -> bool:
        _tls.rec, _tls.stack = self.prev
        return False


class SpanRecorder:
    """The spans of one System (see the module's docstring)."""

    def __init__(self, capacity: int = _CAPACITY) -> None:
        self.capacity = int(capacity)
        self._limit = self.capacity + max(1, self.capacity // 8)
        # closed spans as tuples in Span's order, oldest first; appended
        # without a lock (list.append is atomic), trimmed under one
        self._buf: List[tuple] = []
        self._ids = itertools.count(1)
        self._trim_lock = threading.Lock()
        self.dropped = 0
        self._dropped_t0_ns = -1     # latest start among the dropped spans

    def activate(self) -> _Activation:
        """Context manager: this recorder is the thread's current one
        inside it, the previous one after."""
        return _Activation(self)

    def _trim(self) -> None:
        with self._trim_lock:
            buf = self._buf
            k = len(buf) - self.capacity
            if k <= 0:
                return
            t0 = max(r[1] for r in buf[:k])
            # one statement: spans appended meanwhile stay at the end
            del buf[:k]
            self.dropped += k
            self._dropped_t0_ns = max(self._dropped_t0_ns, t0)

    def spans(self, t0_ns: Optional[int] = None,
              t1_ns: Optional[int] = None) -> List[Span]:
        """The kept spans that start inside [t0_ns, t1_ns] (either bound
        may be None), in order of start."""
        with self._trim_lock:
            buf = list(self._buf)
        lo = -1 if t0_ns is None else t0_ns
        hi = float("inf") if t1_ns is None else t1_ns
        out = [Span._make(r) for r in buf if lo <= r[1] <= hi]
        out.sort(key=lambda s: s.t0_ns)
        return out

    def dropped_since(self, t0_ns: int) -> int:
        """`dropped` if a dropped span started at or after `t0_ns`, else
        0: a window that starts at `t0_ns` has lost none of its spans."""
        return self.dropped if self._dropped_t0_ns >= t0_ns else 0


class StageTimer:
    """Accumulates wall-clock per named stage; each stage is also a span
    `<component>.<stage>` of the current recorder.

    >>> timer = StageTimer("tracker")
    >>> with timer("extract"):
    ...     do_work()
    >>> print(timer.report())
    """

    def __init__(self, component: str = "stage") -> None:
        self.samples: Dict[str, List[float]] = defaultdict(list)
        self.component = component
        self._names: Dict[str, str] = {}

    def __call__(self, name: str) -> _Open:
        full = self._names.get(name)
        if full is None:
            full = self._names[name] = f"{self.component}.{name}"
        return _Open(getattr(_tls, "rec", None), full, None, None, self, name)

    def stats(self, name: str):
        xs = sorted(self.samples.get(name, []))
        if not xs:
            return None
        n = len(xs)
        return {
            "n": n,
            "mean_ms": 1e3 * sum(xs) / n,
            "p50_ms": 1e3 * xs[n // 2],
            "p90_ms": 1e3 * xs[int(n * 0.9)] if n > 1 else 1e3 * xs[0],
            "total_s": sum(xs),
        }

    def report(self) -> str:
        lines = [f"{'stage':<24}{'n':>6}{'mean ms':>10}{'p50 ms':>10}"
                 f"{'p90 ms':>10}{'total s':>10}"]
        for name in sorted(self.samples):
            s = self.stats(name)
            lines.append(f"{name:<24}{s['n']:>6}{s['mean_ms']:>10.2f}"
                         f"{s['p50_ms']:>10.2f}{s['p90_ms']:>10.2f}"
                         f"{s['total_s']:>10.2f}")
        return "\n".join(lines)

    def reset(self) -> None:
        self.samples.clear()
