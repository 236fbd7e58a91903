"""The most device memory one fit of the window held allocated
(``torch.cuda.max_memory_allocated``), in GB."""
UNIT = "GB"
LAYER = "device"
SOURCE = "program_counter"
MOVES = "train_rows_per_s"


def read(ctx):
    peak = max((f["peak_bytes"] for f in ctx.fits), default=0)
    return peak / 1e9 if peak else None
