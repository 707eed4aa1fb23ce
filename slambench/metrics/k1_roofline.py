"""k1_roofline: K1's least time on the card (reference/k1_roofline.py, on
the pyramids of frames drawn from the window, times K1's launches in the
trace) over K1's device time in the trace, in percent.  Nothing without a
trace or without a K1 launch in it."""


def read(run):
    t = run.trace
    if not t or t["k1_launches"] == 0 or t["k1_s"] <= 0 or run.k1_bound_s_per_frame is None:
        return None
    return 100.0 * run.k1_bound_s_per_frame * t["k1_launches"] / t["k1_s"]
