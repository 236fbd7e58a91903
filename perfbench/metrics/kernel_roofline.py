"""Share of their roofline the port's own kernels reach over the profiled
fit: the least time the fit's B1 (D^2, both forms), B2 (epilogue) and B4
(Gauss-Seidel epoch) launches need (``perfbench.yardstick``) over their
device time in the trace."""
from perfbench import yardstick

UNIT = "%"
LAYER = "kernels"
SOURCE = "device_trace"
MOVES = "train_rows_per_s"
NAMES = ("d2_tile_kernel", "d2_rows_kernel", "gram_from_d2_kernel",
         "cd_wave_epoch_kernel")


def read(ctx):
    if ctx.trace is None:
        return None
    dev = sum(sec for name, _, sec in ctx.trace.kernels
              if any(k in name for k in NAMES))
    if dev <= 0.0:
        return None
    bound = sum(yardstick.kernel_bounds_s(ctx.fits[ctx.profiled[0]]).values())
    return 100.0 * bound / dev
