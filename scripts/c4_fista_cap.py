#!/usr/bin/env python3
"""How many FISTA solves stop at ``max_iters``: the JAX package's CV scan
against the port's, on the same cells, on the CPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 scripts/c4_fista_cap.py \
        [--slots 3] [--n 32004]

Stages the first ``--slots`` slots of the training cell's plan exactly as
``SVM.train`` does (``covtype_like(n, d=54, n_classes=7, seed=0)`` rows,
scaled, ``recursive`` cells of 2000, one-vs-all tasks, per-cell gamma
grids, the fit's fold keys), then runs the gamma scan of each package
over them with the training cell's settings (5 folds, 10 x 10 grid, tol
1e-3, max_iters 1000, cd_polish 2): the port's ``cv_cell`` (which
reports the box-QP iterations of every (slot, gamma, fold) solve) and the
reference's scan rebuilt from its own pieces (``make_fold_masks``,
``CachedGram``, ``power_iteration_l`` and ``_solve_columns``, which
returns its iterations; the rest of ``cv_cell`` only selects).  Prints
one JSON line: solves, solves at the cap, per-package iteration
histograms, and how many solves of one package hit the cap where the
other's converged.

Like the tests, this script imports both packages; it runs on the CPU
(~4 minutes a slot here for both packages).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def stage(n: int, n_slots: int):
    """The first slots' staged arrays, as ``SVM.train``'s ``stage``."""
    import torch

    from repro_torch.core import grids, kernel_fns, prng
    from repro_torch.data.scaling import Scaler
    from repro_torch.data.synthetic import covtype_like
    from repro_torch.distributed.planner import pack_cells
    from repro_torch.pipeline.cell_stream import build_cells_stream
    from repro_torch.pipeline.dataset import ArraySource
    from repro_torch.tasks.builder import make_tasks

    x, y = covtype_like(n=n, d=54, n_classes=7, seed=0)
    scaler = Scaler.fit_stream(ArraySource(x), 65536)
    xs = scaler.transform(x)
    plan = build_cells_stream(ArraySource(xs), cell_size=2000,
                              method="recursive", seed=0)
    packed = pack_cells(plan, 1)
    tasks = make_tasks(y, "ova", taus=(0.05, 0.5, 0.95), weights=(1.0,))
    keys = prng.split(prng.PRNGKey(0), packed.n_slots)[:n_slots]
    k = plan.k_max
    out = {"x": [], "y": [], "tm": [], "m": [], "g": []}
    for s in range(n_slots):
        cid = packed.order[s]
        ids, m = plan.indices[cid], plan.mask[cid]
        xc = xs[ids]
        med = float(kernel_fns.median_heuristic(torch.from_numpy(xc),
                                                torch.from_numpy(m)))
        g = grids.liquid_grid(n=int(m.sum()), dim=54, median_dist=med,
                              grid_choice=0, cell_size=2000)
        out["x"].append(xc)
        out["m"].append(m)
        out["y"].append(tasks.labels[:, ids] * m[None, :])
        out["tm"].append(tasks.task_mask[:, ids] * m[None, :])
        out["g"].append(g.gammas.numpy())
    base = grids.liquid_grid(n=k, dim=54, median_dist=1.0, grid_choice=0,
                             cell_size=2000)
    arrs = {key: np.stack(v).astype(np.float32) for key, v in out.items()}
    return arrs, keys, base.lambdas.numpy().astype(np.float32)


def port_iters(a, keys, lambdas, cfg_kw):
    import torch

    from repro_torch.core import cv
    from repro_torch.core.grids import GridSpec

    cfg = cv.CVConfig(**cfg_kw)
    grid = GridSpec(gammas=torch.ones(1), lambdas=torch.from_numpy(lambdas))
    lam_c, sub_c, task_c, n_lam, n_sub = cv.grid_columns(grid, cfg, 7)
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    sel = cv.cv_cell(t["x"], t["y"], t["tm"], t["m"], t["g"], lam_c, sub_c,
                     task_c, keys, cfg, n_lam, n_sub)
    return sel.iters.numpy()                                  # (S, G, F)


def reference_iters(a, keys, lambdas, cfg_kw):
    import jax
    import jax.numpy as jnp

    from repro.core import cv, kernel_fns
    from repro.core.grids import GridSpec
    from repro.core.solvers import base as qp

    cfg = cv.CVConfig(**cfg_kw)
    grid = GridSpec(gammas=jnp.ones(1), lambdas=jnp.asarray(lambdas))
    lam_c, sub_c, task_c, _, _ = cv.grid_columns(grid, cfg, 7)

    @jax.jit
    def step(k_full, y_cols, tr_cols, c0):
        l_est = qp.power_iteration_l(k_full)
        n_eff = jnp.sum(tr_cols, axis=1)                      # (F, P)

        def per_fold(tc, ne, c):
            return cv._solve_columns(k_full, y_cols, tc, lam_c, sub_c, ne,
                                     cfg, c, l_est)
        return jax.vmap(per_fold)(tr_cols, n_eff, c0)

    out = []
    for s in range(a["x"].shape[0]):
        x, m = jnp.asarray(a["x"][s]), jnp.asarray(a["m"][s])
        y_tasks = jnp.asarray(a["y"][s])
        val = cv.make_fold_masks(jnp.asarray(keys[s]), m, cfg.n_folds,
                                 cfg.fold_scheme, y_tasks[0])
        train = (~val) & (m > 0)[None, :]
        y_cols = y_tasks[task_c].T
        colmask = jnp.asarray(a["tm"][s])[task_c].T * m[:, None]
        tr_cols = train.astype(jnp.float32)[:, :, None] * colmask[None]
        cg = kernel_fns.CachedGram.build(x, name=cfg.kernel)
        c0 = jnp.zeros((cfg.n_folds,) + y_cols.shape, jnp.float32)
        per_g = []
        for g in a["g"][s]:
            c0, iters = step(cg.gram(jnp.float32(g), "f32"), y_cols,
                             tr_cols, c0)
            per_g.append(np.asarray(iters))
        out.append(np.stack(per_g))
    return np.stack(out)                                      # (S, G, F)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--slots", type=int, default=3)
    ap.add_argument("--n", type=int, default=32004)
    ap.add_argument("--max-iters", type=int, default=1000)
    args = ap.parse_args()
    cfg_kw = dict(solver="hinge", n_folds=5, tol=1e-3,
                  max_iters=args.max_iters, cd_polish=2, keep_surface=True)
    a, keys, lambdas = stage(args.n, args.slots)
    t0 = time.perf_counter()
    it_p = port_iters(a, keys, lambdas, cfg_kw)
    t1 = time.perf_counter()
    it_r = reference_iters(a, keys, lambdas, cfg_kw)
    t2 = time.perf_counter()
    cap = args.max_iters
    at_p, at_r = it_p >= cap, it_r >= cap
    print(json.dumps({
        "slots": args.slots, "k_max": int(a["x"].shape[1]),
        "live_rows": a["m"].sum(1).astype(int).tolist(),
        "solves": int(it_p.size), "max_iters": cap,
        "port_at_cap": int(at_p.sum()), "reference_at_cap": int(at_r.sum()),
        "port_only_at_cap": int((at_p & ~at_r).sum()),
        "reference_only_at_cap": int((at_r & ~at_p).sum()),
        "port_iters_median": float(np.median(it_p)),
        "reference_iters_median": float(np.median(it_r)),
        "port_iters": it_p.tolist(), "reference_iters": it_r.tolist(),
        "port_s": t1 - t0, "reference_s": t2 - t1}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
