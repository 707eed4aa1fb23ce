"""step_ms: the tracker's fused step per frame that took it: its host
StageTimer samples `fused` (synchronous) or `fused_dispatch` + `fused_get`
(deferred) summed over the window, over the frames whose pose came from
the fused step (tracker.n_fused_frames over the window)."""

STAGES = ("fused", "fused_dispatch", "fused_get")


def read(run):
    if run.fused_frames <= 0:
        return None
    total = sum(sum(run.tracker_stages.get(s, ())) for s in STAGES)
    return 1e3 * total / run.fused_frames
