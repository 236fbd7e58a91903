"""Share of their roofline the float32 cuBLAS products reach over the
profiled fit (FISTA's K C, the power iteration's K v, the validation and
least-squares products): each call's least time at its launched shapes
(``perfbench.yardstick.bound_s``) over its kernels' device time."""
from perfbench import yardstick

UNIT = "%"
LAYER = "kernels"
SOURCE = "device_trace"
MOVES = "train_rows_per_s"


def read(ctx):
    if ctx.trace is None:
        return None
    gemms = [g for g in ctx.trace.gemms if g.dtype == "float"]
    dev = sum(g.device_s for g in gemms)
    if dev <= 0.0:
        return None
    return 100.0 * sum(yardstick.bound_s(g.flops, g.nbytes)
                       for g in gemms) / dev
