"""Quickstart on the PyTorch/CUDA port: the staged liquidSVM cycle.

    PYTHONPATH=src python examples/torch_quickstart.py            # the card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu --scale 0.25

The twin of ``examples/quickstart.py`` through ``repro_torch.api``: the
scenario front-ends (``mcSVM``, ``qtSVM``, ``nplSVM``, ``rocSVM``) over
one staged train -> select -> test cycle.  ``train()`` solves the fold x
grid once and keeps the CV surface; ``select()`` is re-runnable with other
criteria (argmin, Neyman-Pearson constraints, ROC fronts) at the cost of
one targeted wave, never a refit; ``test()`` streams errors.

It runs on the card unless ``--device cpu`` is given, and raises without
one.  ``--scale`` multiplies every sample count (1.0: the reference
script's sizes).  The last line is one JSON object of the held-out
figures.  The same cycle runs as separate processes through the CLI
(``python -m repro_torch.cli train|select|test ... --device cpu``).
"""
import argparse
import json

import numpy as np

from repro_torch.api import SVM, mcSVM, nplSVM, qtSVM, rocSVM
from repro_torch.data.synthetic import banana_mc, regression_1d, train_test_split
from repro_torch.kernels import runtime


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device (default: the card)")
    ap.add_argument("--scale", type=float, default=1.0,
                    help="multiplies every sample count")
    ap.add_argument("--max-iters", type=int, default=400)
    args = ap.parse_args(argv)
    dev = str(runtime.resolve_device(args.device))    # raises without a card
    n = lambda k: max(int(k * args.scale), 120)       # noqa: E731
    it = args.max_iters
    print(f"device: {dev}")

    # ---- multiclass classification (OvA, staged cycle) -------------------
    x, y = banana_mc(n=n(1600), n_classes=4, seed=0)
    xtr, ytr, xte, yte = train_test_split(x, y, 0.25, 0)
    mc = mcSVM(xtr, ytr, FOLDS=3, MAX_ITERATIONS=it, device=dev)
    mc.train()                                   # fold x grid, surface kept
    res = mc.test(xte, yte)                      # selects (argmin) + streams
    print(f"mcSVM      test error: {100 * res.error:.2f}% "
          f"(4 classes, n={len(xtr)})")

    # ---- quantile regression (pinball solver, 3 quantiles) ---------------
    xq, yq = regression_1d(n=n(900), seed=1)
    xtr, ytr, xte, yte = train_test_split(xq, yq, 0.25, 1)
    qt = qtSVM(xtr, ytr, taus=(0.1, 0.5, 0.9), FOLDS=3,
               MAX_ITERATIONS=int(3.75 * it), device=dev)
    qt.train()
    pred = qt.select().predict(xte)              # (m, 3)
    cover = (yte[:, None] <= pred).mean(0)
    print(f"qtSVM      coverage @ tau=0.1/0.5/0.9: "
          f"{cover[0]:.2f}/{cover[1]:.2f}/{cover[2]:.2f}")

    # ---- re-runnable selection: NPL constraints + ROC front --------------
    big_x, big_y = banana_mc(n=n(3000), n_classes=2, seed=2)
    xtr, ytr, xte, yte = train_test_split(big_x, np.where(big_y == 0, -1, 1),
                                          0.25, 2)
    cell = n(500)
    npl = nplSVM(xtr, ytr, constraint=0.05, FOLDS=3, MAX_ITERATIONS=it,
                 VORONOI="voronoi", CELL_SIZE=cell, device=dev)
    npl.train()                                  # ONE training sweep ...
    for alpha in (0.1, 0.05, 0.01):              # ... many selections
        sel = npl.select(alpha=alpha)
        t = sel.test(xte, yte)
        print(f"nplSVM     alpha={alpha:<5} validation FA="
              f"{float(sel.extras['np_fa'][0, sel.default_sub]):.3f} "
              f"test FA={t.details['false_alarm']:.3f} "
              f"detection={t.details['detection']:.3f} "
              f"(re-solved {sel.stats['columns_resolved']} of "
              f"{sel.stats['grid_columns']} columns)")

    # the ROC weight front needs its own weight grid -> its own session
    roc = rocSVM(xtr, ytr, weight_steps=5, FOLDS=3, MAX_ITERATIONS=it,
                 VORONOI="voronoi", CELL_SIZE=cell, device=dev)
    roc.train()
    front = np.asarray(roc.select().extras["roc_front"])[0]  # (S, 2)
    pts = " ".join(f"({fa:.3f},{det:.3f})" for fa, det in front)
    print(f"rocSVM     (FA, detection) front: {pts}")

    # ---- low-level staged session + serving hand-off ----------------------
    sess = SVM(xtr, ytr, scenario="binary", FOLDS=3, MAX_ITERATIONS=it,
               VORONOI="voronoi", CELL_SIZE=cell, device=dev)
    sess.train()
    bank = sess.select().to_bank()               # -> serve.SVMEngine(bank)
    print(f"bank       {bank.stats()['sv_live']} SVs over "
          f"{bank.n_cells} cells "
          f"({100 * bank.stats()['compaction']:.0f}% of raw rows kept)")
    print("embed      token corpora: see examples/torch_lm_svm_head.py and "
          "examples/torch_serve_lm.py --svm-head")
    print(json.dumps({"device": dev, "mc_error": res.error,
                      "qt_coverage": cover.tolist(),
                      "npl_test_fa_at_0.01": t.details["false_alarm"],
                      "npl_detection_at_0.01": t.details["detection"],
                      "bank_cells": bank.n_cells}))


if __name__ == "__main__":
    main()
