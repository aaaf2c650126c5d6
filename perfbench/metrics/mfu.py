"""The whole step's share of the card's bf16 peak: the model FLOPs of the
window's steps (`perfbench.counts.flops`) over its seconds (host clock,
to the final synchronize) and the data sheet's 989 TFLOP/s."""
LAYER = "device, the whole step"
UNIT = "%"
MOVES = "tokens_per_s"


def read(ctx):
    w = ctx.window
    if not w["steps"] or not w["window_s"]:
        return None
    return 100.0 * w["flops_per_step"] * w["steps"] / w["window_s"] \
        / ctx.peaks.BF16_FLOPS
