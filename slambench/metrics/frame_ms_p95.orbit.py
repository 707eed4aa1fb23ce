"""frame_ms_p95.orbit: the statistic of frame_ms_p95 in the orbit cells,
where ~50 frames in a window carry no p95 that should decide a change:
kept per layer (System.track) there."""

from slambench.stats import percentile


def read(run):
    v = percentile([run.latency_s[f] for f in run.submitted if f in run.latency_s], 95)
    return None if v is None else 1e3 * v
