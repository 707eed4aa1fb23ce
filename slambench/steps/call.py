"""One call of the system without arguments, named by its attribute path
from the System object: "reset", "activate_localization_mode",
"tracker.flush"."""


def run(ctx, step):
    ctx.call(step["method"])
    yield
