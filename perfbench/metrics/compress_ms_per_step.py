"""Device milliseconds a step enqueued inside the program's
``step.compress`` spans (`perfbench.spans`): each worker's compression of
its gradient into the wire payload and its error-feedback residual."""
from perfbench.spans import device_seconds

LAYER = "kernels and EF state: compression"
UNIT = "ms"
MOVES = "tokens_per_s"


def read(ctx):
    s = device_seconds(ctx, "step.compress")
    return None if not s else s * 1e3 / ctx.steps
