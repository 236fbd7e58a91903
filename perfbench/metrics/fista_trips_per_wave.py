"""FISTA loop trips a wave takes: for each gamma, the trips of the batched
loop, which runs until the wave's slowest (slot, fold) stops (the largest
of its box-QP iteration counts), summed over the gammas."""
import numpy as np

UNIT = "count"
LAYER = "solver"
SOURCE = "program_counter"
MOVES = "train_rows_per_s"


def read(ctx):
    trips = []
    for f in ctx.fits:
        if f["solver"] != "hinge" or f["iters"] is None:
            continue
        it = np.asarray(f["iters"])                       # (S, G, F)
        spw = f["slots_per_wave"]
        for lo in range(0, it.shape[0], spw):
            trips.append(it[lo:lo + spw].max(axis=(0, 2)).sum())
    return float(np.mean(trips)) if trips else None
