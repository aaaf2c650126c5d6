"""Device milliseconds a step enqueued inside the program's
``step.deliver`` span (`perfbench.spans`): the payloads' gather and K2's
deposit into the delay ring and its take (async), or K4's sum
(synchronous)."""
from perfbench.spans import device_seconds

LAYER = "delivery: K2 ring (async), K4 sum (sync)"
UNIT = "ms"
MOVES = "tokens_per_s"


def read(ctx):
    s = device_seconds(ctx, "step.deliver")
    return None if not s else s * 1e3 / ctx.steps
