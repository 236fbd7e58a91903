"""Seconds a fit spends in host staging: its wall time minus its waves'
spans, plus the waves' ``train.stage`` spans (scaling, the cell plan,
packing, the per-cell gamma grids, gathering each wave's rows)."""
UNIT = "s"
LAYER = "host staging"
SOURCE = "program_span"
MOVES = "train_rows_per_s"


def read(ctx):
    fits = [f for f in ctx.span_fits() if f["spans"]]
    if not fits:
        return None
    total = 0.0
    for f in fits:
        waves = sum(s["dur_s"] for s in f["spans"] if s["name"] == "train.wave")
        stage = sum(s["dur_s"] for s in f["spans"]
                    if s["name"] == "train.stage")
        total += f["wall_s"] - waves + stage
    return total / len(fits)
