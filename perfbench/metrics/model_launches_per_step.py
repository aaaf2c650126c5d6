"""Kernel launches a step made while the model ran: runtime launch calls
(``cudaLaunchKernel*``, ``cuLaunchKernel*``) of the span traced with the
host's operations whose start lies inside a ``step.forward`` or
``step.backward`` span's host interval.  Autograd launches the backward's
kernels from its own thread, so a launch counts by its time, whatever
thread made it."""
from perfbench.spans import inside

LAYER = "models, forward and backward: models/transformer, models/layers, models/moe"
UNIT = "launches"
MOVES = "tokens_per_s"

LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel")
SPANS = ("step.forward", "step.backward")


def read(ctx):
    host = ctx._host_span[1]
    # the two never overlap
    spans = sorted((s, e) for name, s, e in host if name in SPANS)
    if not spans:
        return None
    return sum(inside(s, spans) for name, s, _ in host
               if name.startswith(LAUNCHES)) / ctx.steps
