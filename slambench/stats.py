"""Small statistics shared by the metric readers."""

from __future__ import annotations

import math


def percentile(values, q: float):
    """The q-th percentile by the nearest rank (the smallest value with at
    least q% of the values at or below it); None without values."""
    xs = sorted(values)
    if not xs:
        return None
    return xs[max(0, math.ceil(q / 100.0 * len(xs)) - 1)]


def keyframes(run) -> int:
    """Keyframes the tracker inserted in the window (its KF@ events)."""
    return sum(e.startswith("KF@") for e in run.events)
