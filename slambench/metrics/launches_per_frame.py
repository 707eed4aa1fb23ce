"""launches_per_frame: kernels in the trace of the window over the frames
submitted in it."""


def read(run):
    t = run.trace
    if not t or not run.submitted:
        return None
    return t["kernels"] / len(run.submitted)
