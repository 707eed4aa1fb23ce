"""An arc of the orbit: `frames` poses on the circle of `radius_m`,
`step_deg` apart, the rig facing out, from a start angle drawn from the
seed (or `start_deg` where the traffic fixes it)."""

import math

from slambench import generator
from slambench.traffic_plan import Path


def make(params, rng, paths):
    step = math.radians(float(params["step_deg"]))
    start = float(rng.uniform(0.0, 2 * math.pi))
    if "start_deg" in params:
        start = math.radians(float(params["start_deg"]))
    n = int(params["frames"])
    r = float(params["radius_m"])
    return Path(generator.orbit_path(r, start, step, n),
                {"start": start, "step": step, "radius": r, "frames": n})
