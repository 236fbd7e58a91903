"""Share of the profiled fit in which no kernel, copy or fill ran on the
card."""
UNIT = "%"
LAYER = "device"
SOURCE = "device_trace"
MOVES = "train_rows_per_s"


def read(ctx):
    if ctx.trace is None or ctx.trace.window_s <= 0.0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
