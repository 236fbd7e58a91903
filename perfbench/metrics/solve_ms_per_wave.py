"""Device milliseconds a wave spends solving: the ``train.wave`` span
minus its ``train.stage``, ``train.d2``, ``train.epilogue`` and
``train.select`` children (FISTA with its step estimate and the B4 polish,
or the eigh path)."""
UNIT = "ms"
LAYER = "solver"
SOURCE = "program_span"
MOVES = "train_rows_per_s"
_OTHER = ("train.stage", "train.d2", "train.epilogue", "train.select")


def read(ctx):
    ms, waves = 0.0, 0
    for f in ctx.span_fits():
        for s in f["spans"]:
            if s["device_ms"] is None:
                continue
            if s["name"] == "train.wave":
                ms += s["device_ms"]
                waves += 1
            elif s["name"] in _OTHER:
                ms -= s["device_ms"]
    return ms / waves if waves else None
