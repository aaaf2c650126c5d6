"""The share of the window's step in which no operation ran on the device:
the device's busy time a step, from the span traced with the device's
activity alone, over the mean step of the untraced window (from its
step-end events), since tracing stretches the host's part of a step."""
LAYER = "device"
UNIT = "%"
MOVES = "tokens_per_s"


def read(ctx):
    ms = ctx.window["step_ms"]
    if not ctx.device_ops or not ms:
        return None
    return 100.0 * (1.0 - ctx.busy_s() / ctx.steps * 1e3
                    / (sum(ms) / len(ms)))
