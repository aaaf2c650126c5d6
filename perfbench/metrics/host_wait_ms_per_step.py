"""Host milliseconds a step inside the program's ``wait.*`` spans, in the
span traced with the host's operations.  A program without ``step.*``
spans names no waits, and reads nothing.

Read under the host profiler: a wait lasts until the device has run what
the host queued before it, and recording the host's operations slows the
host (qwen3's step 1.6-2.2 times), so the device's backlog at each wait,
and the wait, are not the untraced step's.  A hint for the layer only:
judge a change to the waits by ``host_waits_per_step``, an exact count,
and by the end-to-end metrics."""
LAYER = "step dispatch: dist/async_engine.AsyncTrainStep, dist/train.ElasticTrainStep"
UNIT = "ms"
MOVES = "tokens_per_s"


def read(ctx):
    host = ctx._host_span[1]
    if not any(name.startswith("step.") for name, _, _ in host):
        return None
    waits = sorted((s, e) for name, s, e in host if name.startswith("wait."))
    total, end = 0.0, float("-inf")
    for s, e in waits:
        total += max(0.0, e - max(s, end))
        end = max(end, e)
    return total * 1e-3 / ctx.steps
