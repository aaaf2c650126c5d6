"""K1's share of its roofline: the least time its work needs (the bytes
of `perfbench.counts.kernel_bytes` over the card's HBM bandwidth) over
its device time in the traced span."""
from perfbench.kernel_groups import group_seconds

LAYER = "kernels: kernels/topk_ef (K1): compress into the EF residual"
UNIT = "%"
MOVES = "tokens_per_s"


def read(ctx):
    s = group_seconds(ctx.kernels).get("K1")
    if not s:
        return None
    work = ctx.kernel_bytes.step_bytes(ctx.leaf_sizes, ctx.traffic)["K1"]
    if not work:
        return None
    return 100.0 * work * ctx.steps / ctx.peaks.HBM_BYTES_PER_S / s
