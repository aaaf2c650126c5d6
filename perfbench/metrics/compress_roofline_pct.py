"""Compression's share of its roofline, whatever implements it: the least
time K1's work needs (the bytes of `perfbench.counts.kernel_bytes` over
the card's HBM bandwidth) over the device time under the program's
``step.compress`` spans (device operations by the runtime calls that
enqueued them, `perfbench.spans`)."""
from perfbench.spans import device_seconds

LAYER = "kernels: compression, whatever implements it"
UNIT = "%"
MOVES = "tokens_per_s"


def read(ctx):
    s = device_seconds(ctx, "step.compress")
    if not s:
        return None
    work = ctx.kernel_bytes.step_bytes(ctx.leaf_sizes, ctx.traffic)["K1"]
    if not work:
        return None
    return 100.0 * work * ctx.steps / ctx.peaks.HBM_BYTES_PER_S / s
