"""Out-of-core training on the PyTorch/CUDA port: memmap ingestion ->
streaming cells -> wave-scheduled training -> serving bank.

    PYTHONPATH=src python examples/torch_bigdata_train.py [--n 200000]
    PYTHONPATH=src python examples/torch_bigdata_train.py --device cpu --n 20000

The twin of ``examples/bigdata_train.py`` through ``repro_torch``.

The training matrix is written to an on-disk ``.npy`` in chunks and never
loaded whole: scaling statistics stream (`Scaler.fit_stream`), Voronoi
cells are built by the two-pass streaming builder (O(chunk · C) peak, not
(n, C)), and the cell solves run in bounded WAVES of packed slots with a
per-wave checkpoint — kill the process mid-fit and a re-run resumes at
the first unfinished wave.  On the card the cells' nearest centers come
from the assignment kernel (``CELL_BACKEND="kernel"``, the device backend
of cell building) and each wave's D², epilogues and solves run there.
The fitted model hands off to the serving engine via ``to_bank()``
exactly like an in-memory fit.

It runs on the card unless ``--device cpu`` is given, and raises without
one.  The last line is one JSON object: cells, waves, served queries and
their error.
"""
import argparse
import json
import os
import tempfile
import time

import numpy as np

from repro_torch.data.synthetic import covtype_like
from repro_torch.kernels import runtime
from repro_torch.pipeline.assign import assign_stream
from repro_torch.pipeline.dataset import MemmapSource, ScaledSource
from repro_torch.serve.svm_engine import SVMEngine
from repro_torch.train.svm_trainer import LiquidSVM, SVMTrainerConfig

CHUNK = 16384


def write_memmap_dataset(path, n, d=6, seed=0):
    """Stream a synthetic covtype-like problem to disk in chunks."""
    mm = np.lib.format.open_memmap(path, mode="w+", dtype=np.float32,
                                   shape=(n, d))
    labels = np.empty(n, np.float32)
    for lo in range(0, n, CHUNK):
        hi = min(lo + CHUNK, n)
        # covtype_like rounds n down to its mixture count: over-request + slice
        xc, yc = covtype_like(n=hi - lo + 6, d=d, seed=seed + lo,
                              label_noise=0.02, n_modes=3)
        mm[lo:hi] = xc[: hi - lo]
        labels[lo:hi] = np.where(yc[: hi - lo] == 0, -1, 1)
    mm.flush()
    del mm
    return labels


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device (default: the card)")
    ap.add_argument("--n", type=int, default=200_000)
    ap.add_argument("--d", type=int, default=6)
    ap.add_argument("--cell-size", type=int, default=2000)
    ap.add_argument("--wave", type=int, default=16,
                    help="packed cell slots staged+solved per wave")
    ap.add_argument("--queries", type=int, default=2000)
    args = ap.parse_args(argv)
    dev = runtime.resolve_device(args.device)    # raises without a card
    print(f"device: {dev}")

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "train.npy")
        print(f"== write {args.n}x{args.d} memmap dataset ==")
        y = write_memmap_dataset(path, args.n, args.d)

        cfg = SVMTrainerConfig(
            cell_method="voronoi", cell_size=args.cell_size,
            n_folds=3, max_iters=200,
            n_slots_per_wave=args.wave, chunk_size=CHUNK)
        ckpt = os.path.join(tmp, "waves")

        print(f"== fit from memmap source, waves of {args.wave} slots ==")
        t0 = time.time()
        est = LiquidSVM(cfg, device=dev).fit(path, y, ckpt_dir=ckpt)  # path IS the source
        n_waves = len([d_ for d_ in os.listdir(ckpt) if d_.startswith("step_")])
        print(f"fit: {time.time() - t0:.1f}s  cells={est.plan.n_cells} "
              f"k_max={est.plan.k_max} waves={n_waves} (checkpointed)")

        print("== nearest cell of every row: host numpy vs the kernel ==")
        # the fit built its cells with the host's bit-exact numpy
        # assignment; the device backend of cell building ("kernel": the
        # hand-written nearest-center kernel on the card, its plain
        # version on the CPU) streams the same scaled rows past the fit's
        # cell centers
        sc = est.train_result.scaler
        src = ScaledSource(MemmapSource(path), sc.mean, sc.std)
        host = assign_stream(src, est.plan.centers, chunk_size=CHUNK)
        t0 = time.time()
        owner = assign_stream(src, est.plan.centers, chunk_size=CHUNK,
                              backend="kernel", device=dev)
        flips = int((owner != host).sum())
        print(f"{args.n} rows assigned in {time.time() - t0:.2f}s on {dev}:"
              f" {flips} owners differ from the host's (near-ties)")

        print("== hand off to serving bank ==")
        bank = est.to_bank()
        s = bank.stats()
        print(f"bank: {s['n_cells']} cells, SVs {s['sv_raw']} -> {s['sv_live']}"
              f" (compaction {s['compaction']:.2f})")

        eng = SVMEngine(bank, device=dev)
        # evaluate on a sample of the on-disk rows (each chunk is its own
        # mixture, so only the dataset itself is in-distribution)
        nq = min(args.queries, args.n)
        ids = np.random.default_rng(1).choice(args.n, nq, replace=False)
        q = np.asarray(np.load(path, mmap_mode="r")[np.sort(ids)])
        pred = eng.predict_label(q)
        err = float((pred != y[np.sort(ids)]).mean())
        print(f"served {nq} queries, train-sample error={err:.3f}  "
              f"stats={eng.stats()}")
        print(json.dumps({"device": str(dev), "n": args.n,
                          "cells": int(est.plan.n_cells), "waves": n_waves,
                          "owner_flips": flips, "queries": nq,
                          "served": int(pred.shape[0]), "error": err}))


if __name__ == "__main__":
    main()
