"""Device milliseconds a step enqueued inside the program's
``step.update`` span (`perfbench.spans`): the optimizer's update of the
parameters and its state."""
from perfbench.spans import device_seconds

LAYER = "optimizer"
UNIT = "ms"
MOVES = "tokens_per_s"


def read(ctx):
    s = device_seconds(ctx, "step.update")
    return None if not s else s * 1e3 / ctx.steps
