"""Per-stage host timing.

The port's own copy of orbslam2_dualcam_tpu/utils/profiling.py::StageTimer:
a low-overhead wall-clock stage timer with summary statistics.  It times
the host: a stage that only queues work on the card and reads nothing back
shows its queueing time, not the card's."""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Iterator, List


class StageTimer:
    """Accumulates wall-clock per named stage.

    >>> timer = StageTimer()
    >>> with timer("extract"):
    ...     do_work()
    >>> print(timer.report())
    """

    def __init__(self) -> None:
        self.samples: Dict[str, List[float]] = defaultdict(list)

    @contextlib.contextmanager
    def __call__(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.samples[name].append(time.perf_counter() - t0)

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
