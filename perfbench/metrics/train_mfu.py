"""The whole fit's share of the card's float32 peak: the operations the
fits' inputs need (``perfbench.yardstick.fit_flops``) over their wall time
at 67 TFLOP/s."""
from perfbench import yardstick

UNIT = "%"
LAYER = "whole fit"
SOURCE = "host_clock"
MOVES = "train_rows_per_s"


def read(ctx):
    fits = ctx.span_fits()
    wall = sum(f["wall_s"] for f in fits)
    if wall <= 0.0:
        return None
    flops = sum(yardstick.fit_flops(f) for f in fits)
    return 100.0 * flops / (wall * yardstick.PEAKS["fp32_flops"])
