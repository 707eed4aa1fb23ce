"""local_ba_ms_per_kf: the local mapper's `local_ba` stage summed over the
window, per keyframe inserted in it."""

from slambench.stats import keyframes


def read(run):
    n = keyframes(run)
    if n == 0:
        return None
    return 1e3 * sum(run.mapper_stages.get("local_ba", ())) / n
