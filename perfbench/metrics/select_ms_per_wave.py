"""Device milliseconds a wave spends in CV selection (``train.select``:
the validation products, losses and the streaming argmin)."""
UNIT = "ms"
LAYER = "CV selection"
SOURCE = "program_span"
MOVES = "train_rows_per_s"


def read(ctx):
    return ctx.ms_per_wave(("train.select",))

