"""The 90th percentile of the window's step times (consecutive step-end
CUDA events), where a cell's tail is not an end-to-end metric: its device
idles most of the traced span, or its window holds fewer than 100
steps."""
import statistics

LAYER = "step dispatch: dist/async_engine.AsyncTrainStep, dist/train.ElasticTrainStep"
UNIT = "ms"
MOVES = "tokens_per_s"


def read(ctx):
    ms = ctx.window["step_ms"]
    if len(ms) < 2:
        return None
    return statistics.quantiles(ms, n=10, method="inclusive")[8]
