"""Device milliseconds a step under the program's ``moe_dispatch`` range
(routing and the dispatch product)."""
LAYER = "models, experts: models/moe"
UNIT = "ms"
MOVES = "tokens_per_s"


def read(ctx):
    s = ctx.ranges.get("moe_dispatch")
    return None if not s else s * 1e3 / ctx.steps
