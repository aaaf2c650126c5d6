"""Device milliseconds a step enqueued inside the program's ``step.gap``
spans (`perfbench.spans`): the ``track_gap`` passes (the fresh gradients'
running sum and the squares of the stale gap, or the residuals' mean and
squares)."""
from perfbench.spans import device_seconds

LAYER = "update and EF state: the track_gap passes"
UNIT = "ms"
MOVES = "tokens_per_s"


def read(ctx):
    s = device_seconds(ctx, "step.gap")
    return None if not s else s * 1e3 / ctx.steps
