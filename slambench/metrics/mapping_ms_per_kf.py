"""mapping_ms_per_kf: the local mapper's StageTimer, every stage
(`triangulate`, `fuse`, `cross_cam`, `local_ba`; `search_cross` runs
inside `cross_cam` and is not counted twice), summed over the window, per
keyframe inserted in it."""

from slambench.stats import keyframes

NESTED = ("search_cross",)


def read(run):
    n = keyframes(run)
    if n == 0:
        return None
    total = sum(sum(v) for k, v in run.mapper_stages.items() if k not in NESTED)
    return 1e3 * total / n
