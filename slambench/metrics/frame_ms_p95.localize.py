"""frame_ms_p95.localize: 95th percentile over the window's frames of the
time from the start of the track call that submitted a frame to the end
of the call after which its pose was in tracker.trajectory (host clock,
less the harness's bookkeeping).  Kept per layer (System.track): ~125
frames in a 51 s window make a tail that spreads 0.12-0.21 from run to
run, more than an end-to-end bound may hold."""

from slambench.stats import percentile


def read(run):
    v = percentile([run.latency_s[f] for f in run.submitted if f in run.latency_s], 95)
    return None if v is None else 1e3 * v
