"""Device milliseconds a step in elementwise, reduction, copy and cast
kernels: the update and error-feedback state's passes with the
activations'."""
from perfbench.kernel_groups import group_seconds

LAYER = "update and EF state: dist, optim, core/scheduler, with the activations' passes"
UNIT = "ms"
MOVES = "tokens_per_s"


def read(ctx):
    g = group_seconds(ctx.device_ops)
    s = g.get("elementwise / reduce", 0.0) + g.get("copy / cast", 0.0)
    return None if not s else s * 1e3 / ctx.steps
