"""Device milliseconds a step in the library's matrix-product kernels."""
from perfbench.kernel_groups import group_seconds

LAYER = "models, forward and backward: models/transformer, models/layers, models/moe"
UNIT = "ms"
MOVES = "tokens_per_s"


def read(ctx):
    s = group_seconds(ctx.kernels).get("matmul")
    return None if not s else s * 1e3 / ctx.steps
