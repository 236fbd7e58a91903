"""Distributed cell training on the PyTorch/CUDA port: the cells' solves
split over the ranks of a ``DeviceMesh``.

    PYTHONPATH=src python examples/torch_svm_cells_distributed.py          # the card
    PYTHONPATH=src python examples/torch_svm_cells_distributed.py --device cpu

The twin of ``examples/svm_cells_distributed.py``: the paper's Table-4
Spark layer (coarse Voronoi cells -> fine cells -> bin-packed slots) with
each wave's slots split over the mesh's ranks and gathered.  Where the
reference forces 8 XLA host devices, this script starts real ranks
through ``launch.local.run_local``: 8 CPU gloo ranks with ``--device
cpu``, or by default ranks on the card (gloo carries CPU and CUDA
tensors, so several ranks may share one card; NCCL refuses that).  A
``torchrun`` job does the same over several cards with
``launch.mesh.make_mesh``.

It runs on the card unless ``--device cpu`` is given, and raises without
one.  The last line is one JSON object: both fits' seconds and held-out
errors.
"""
import argparse
import json
import time

import numpy as np

from repro_torch.data.synthetic import covtype_like, train_test_split
from repro_torch.kernels import runtime
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.local import run_local
from repro_torch.train.svm_trainer import LiquidSVM, SVMTrainerConfig


def rank_fit(data, cfg, device_type, n_ranks):
    """One rank: the fit split over an (n_ranks,) ``("data",)`` mesh."""
    xtr, ytr, xte, yte = data
    mesh = mesh_mod.make_mesh((n_ranks,), ("data",), device_type)
    dev = runtime.resolve_device(device_type)
    t0 = time.time()
    est = LiquidSVM(cfg, device=dev, mesh=mesh,
                    mesh_axes=("data",)).fit(xtr, ytr)
    return {"seconds": time.time() - t0, "error": est.error(xte, yte),
            "device": str(dev), "cells": int(est.plan.n_cells),
            "coarse": int(est.plan.coarse_of.max() + 1)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device (default: the card)")
    ap.add_argument("--ranks", type=int, default=None,
                    help="ranks of the mesh (default: 8 CPU ranks, or 2 "
                         "on the card)")
    ap.add_argument("--n", type=int, default=6000)
    ap.add_argument("--max-iters", type=int, default=300)
    args = ap.parse_args(argv)
    dev = runtime.resolve_device(args.device)    # raises without a card
    cpu = dev.type == "cpu"
    n_ranks = args.ranks or (8 if cpu else 2)
    print(f"device: {dev}, {n_ranks} ranks")

    x, yc = covtype_like(n=args.n, d=8, seed=0, label_noise=0.08)
    y = np.where(yc == 0, -1, 1)
    xtr, ytr, xte, yte = train_test_split(x, y, 0.2, 0)
    cfg = SVMTrainerConfig(cell_method="coarse_fine", cell_size=300,
                           n_folds=3, max_iters=args.max_iters)

    t0 = time.time()
    local = LiquidSVM(cfg, device=dev).fit(xtr, ytr)
    t_local = time.time() - t0
    e_local = local.error(xte, yte)

    t0 = time.time()
    ranks = run_local(rank_fit, n_ranks, (xtr, ytr, xte, yte), cfg,
                      "cpu" if cpu else None, n_ranks,
                      backend="gloo" if cpu else "cpu:gloo,cuda:gloo",
                      threads=1 if cpu else None)
    t_dist = time.time() - t0
    r0 = ranks[0]
    print(f"cells: {r0['cells']} fine ({r0['coarse']} coarse groups)")
    print(f"one device    : {t_local:6.1f}s  err {100 * e_local:.2f}%")
    print(f"{n_ranks}-rank mesh   : {t_dist:6.1f}s  err {100 * r0['error']:.2f}%"
          f"  (the fit alone {r0['seconds']:.1f}s; ranks on "
          f"{sorted({r['device'] for r in ranks})})")
    same = all(r["error"] == r0["error"] for r in ranks)
    print("errors match:", abs(e_local - r0["error"]) < 0.02,
          "(the Spark shuffle, statically scheduled); every rank the same:",
          same)
    print(json.dumps({"device": str(dev), "ranks": n_ranks,
                      "local_s": t_local, "local_error": e_local,
                      "mesh_s": t_dist, "mesh_error": r0["error"],
                      "ranks_equal": same}))


if __name__ == "__main__":
    main()
