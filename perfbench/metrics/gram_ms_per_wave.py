"""Device milliseconds a wave spends building its Grams: the wave's D^2
(``train.d2``, B1-sym) and every gamma's epilogue (``train.epilogue``,
B2)."""
UNIT = "ms"
LAYER = "kernel matrix"
SOURCE = "program_span"
MOVES = "train_rows_per_s"


def read(ctx):
    return ctx.ms_per_wave(("train.d2", "train.epilogue"))

