"""Device kernels launched a step in the traced span."""
LAYER = "step dispatch: dist/async_engine.AsyncTrainStep, dist/train.ElasticTrainStep"
UNIT = "launches"
MOVES = "tokens_per_s"


def read(ctx):
    if not ctx.kernels:
        return None
    return len(ctx.kernels) / ctx.steps
