"""The program's host waits a step: its ``wait.*`` spans (each a place
where the step's host thread waits for the device) in the span traced
with the host's operations.  A program without ``step.*`` spans names no
waits, and reads nothing."""
LAYER = "step dispatch: dist/async_engine.AsyncTrainStep, dist/train.ElasticTrainStep"
UNIT = "waits"
MOVES = "tokens_per_s"


def read(ctx):
    names = [name for name, _, _ in ctx._host_span[1]]
    if not any(n.startswith("step.") for n in names):
        return None
    return sum(n.startswith("wait.") for n in names) / ctx.steps
