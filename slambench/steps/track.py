"""Closed loop, one client: the frames of the path `path` go into
System.track one per call, each after the previous call has returned (as
run.track_stream feeds a video), from the path's cursor on: `frames` of
them, or to the path's end.  With "until": "initialized" the step stops
once the tracker has a map."""


def run(ctx, step):
    name = step["path"]
    end = ctx.plan.length[name]
    if "frames" in step:
        end = min(end, ctx.cursor[name] + int(step["frames"]))
    while ctx.cursor[name] < end:
        if step.get("until") == "initialized" and ctx.initialized():
            return
        k = ctx.cursor[name]
        ctx.cursor[name] = k + 1
        ctx.track(ctx.plan.offset[name] + k)
        yield
