"""Back and forth on the circle of `radius_m`, over the part of an orbit
path `over` between the fractions `lo_frac` and `hi_frac` of its arc,
about `step_deg` per frame: one period of the sweep, turned to a phase
drawn from the seed."""

import math

from slambench import generator
from slambench.traffic_plan import Path


def make(params, rng, paths):
    base = paths[params["over"]].meta
    arc = (base["frames"] - 1) * base["step"]
    lo = base["start"] + float(params["lo_frac"]) * arc
    hi = base["start"] + float(params["hi_frac"]) * arc
    n_half = max(1, round((hi - lo) / math.radians(float(params["step_deg"]))))
    period = 2 * n_half
    phase = int(rng.integers(0, period))
    sweep = generator.back_and_forth(float(params["radius_m"]), lo, hi,
                                     (hi - lo) / n_half, period, lo)
    return Path(sweep[phase:] + sweep[:phase], {"lo": lo, "hi": hi, "frames": period})
