"""fps: frames whose pose was published inside the window, over the
window's seconds (host clock, first call's start to last call's end)."""


def read(run):
    return len(run.published) / run.window_s if run.window_s > 0 else None
