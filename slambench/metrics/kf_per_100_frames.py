"""kf_per_100_frames: keyframes inserted (the tracker's KF@ events) per 100
frames submitted in the window: shows a change that moves work by moving
the keyframe policy."""

from slambench.stats import keyframes


def read(run):
    if not run.submitted:
        return None
    return 100.0 * keyframes(run) / len(run.submitted)
