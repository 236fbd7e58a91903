"""Plain reference of the fit's staging: scaling, labels, the cell partition
(replayed), its centers and the selection rule, with the exact checks of
what the program staged.

Each ``*_faults`` function counts what is wrong; a sound run counts 0.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def scale(x: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Train-statistics standardisation in float64: (scaled x, mean, std),
    std the population deviation, floored at 1e-8."""
    x64 = np.asarray(x, np.float64)
    mean = x64.mean(0)
    std = np.maximum(x64.std(0), 1e-8)
    return (x64 - mean) / std, mean, std


def task_labels(y: np.ndarray, scenario: str
                ) -> Tuple[np.ndarray, np.ndarray]:
    """(labels, task mask), each (T, n): one-vs-all +-1 per class in
    ascending class order, or the +-1 labels of a binary problem."""
    y = np.asarray(y)
    if scenario == "ova":
        labels = np.stack([np.where(y == c, 1.0, -1.0) for c in np.unique(y)])
    elif scenario == "binary":
        labels = np.asarray(y, np.float64)[None]
    else:
        raise ValueError(f"reference staging: scenario {scenario!r}")
    return labels, np.ones_like(labels)


def partition_faults(indices: np.ndarray, mask: np.ndarray,
                     order: np.ndarray, n: int, cell_size: int) -> int:
    """Rows not in exactly one cell, cells over ``cell_size`` or with
    padding before live rows, and slots that do not hold each cell once."""
    bad = 0
    live = mask > 0
    counts = live.sum(1)
    bad += int((counts > cell_size).sum())
    prefix = np.arange(mask.shape[1])[None, :] < counts[:, None]
    bad += int((live != prefix).sum())
    seen = np.bincount(indices[live].astype(np.int64), minlength=n)[:n]
    bad += int((seen != 1).sum()) + int((indices[live] >= n).sum())
    cells = np.sort(order[order >= 0])
    bad += int(cells.shape[0] != indices.shape[0]
               or not np.array_equal(cells, np.arange(indices.shape[0])))
    return bad


# the recursive plan's Lloyd steps, as liquidSVM's VORONOI 6 runs them
LLOYD_STEPS = 8
# a row on the other side of a split than the replay puts it is a fault
# unless the replay's two distances tie to within this share of their sum:
# the program splits in float32, and a row that changed sides in one of its
# Lloyd steps moves the centers by ~1/n of a row.  Sound plans read at most
# 9.9e-4 (92 sets of 17,000 rows), plans of 6 Lloyd steps from 5.9e-3
SPLIT_TIE = 3e-3
# centers off their cell's mean of scaled rows by more than this, relative
# to max(|mean|, 1), are faults (sound plans read <= 8.8e-6 over 92 sets:
# float32 scaling and sums)
CENTER_TOL = 2.0 ** -12


def _two_means(pts: np.ndarray, rng: np.random.Generator
               ) -> "Tuple[np.ndarray, np.ndarray]":
    """One split of the recursive plan: two rows drawn by ``rng`` as
    centers, ``LLOYD_STEPS`` Lloyd steps, the last assignment.  (side of
    each row, |d0 - d1| / (d0 + d1))."""
    c = pts[rng.choice(len(pts), 2, replace=False)].copy()

    def dist():
        return ((pts[:, None, :] - c[None]) ** 2).sum(-1)
    for _ in range(LLOYD_STEPS):
        a = dist().argmin(1)
        for j in (0, 1):
            if (a == j).any():
                c[j] = pts[a == j].mean(0)
    d2 = dist()
    tie = np.abs(d2[:, 0] - d2[:, 1]) / np.maximum(d2.sum(1), 1e-300)
    return d2.argmin(1), tie


def recursive_plan_faults(xs: np.ndarray, indices: np.ndarray,
                          mask: np.ndarray, cell_size: int, seed: int
                          ) -> Tuple[int, float]:
    """The program's cells against liquidSVM's recursive 2-means plan
    (VORONOI 6), replayed in float64 from the reference's scaled rows with
    the plan's generator (``numpy.random.default_rng(seed)``): split every
    part of more than ``cell_size`` rows in two, depth first, part 0 first.

    The replay follows the program's tree: at each split it finds the
    program's two halves among its cells (in plan order), counts the rows
    the two put on different sides beyond ``SPLIT_TIE``, and goes on into
    the program's halves, so one row near a boundary moves nothing else.
    Also a fault: a part the program splits that should stay whole, or
    keeps whole that should be split, or a cell whose rows are not the
    part's.  Returns (faults, the largest tie share of a row on the other
    side)."""
    n_cells = indices.shape[0]
    leaf = np.full(xs.shape[0], -1, np.int64)
    leaves = []
    for cid in range(n_cells):
        ids = indices[cid][mask[cid] > 0].astype(np.int64)
        leaf[ids] = cid
        leaves.append(ids)
    rng = np.random.default_rng(seed)
    faults, worst = 0, 0.0
    stack = [(np.arange(xs.shape[0]), 0, n_cells)]
    while stack:
        ids, lo, hi = stack.pop()
        if len(ids) <= cell_size:
            faults += int(hi - lo != 1 or not np.array_equal(leaves[lo], ids))
            continue
        if hi - lo < 2:
            faults += 1
            continue
        side, tie = _two_means(xs[ids], rng)
        if (side == side[0]).all():       # no split: halves by order
            side = (np.arange(len(ids)) >= len(ids) // 2).astype(np.int64)
            tie = np.ones(len(ids))
        # the program's halves: its cells [lo, mid) and [mid, hi)
        cells = leaf[ids]
        n0 = np.bincount(cells[side == 0] - lo, minlength=hi - lo)
        n1 = np.bincount(cells[side == 1] - lo, minlength=hi - lo)
        agree = [n0[:m].sum() + n1[m:].sum() for m in range(1, hi - lo)]
        mid = lo + 1 + int(np.argmax(agree))
        prog = (cells >= mid).astype(np.int64)
        off = prog != side
        faults += int((off & (tie > SPLIT_TIE)).sum())
        worst = max(worst, float(tie[off].max(initial=0.0)))
        stack.append((ids[prog == 1], mid, hi))
        stack.append((ids[prog == 0], lo, mid))
    return faults, worst


def center_faults(xs: np.ndarray, indices: np.ndarray, mask: np.ndarray,
                  centers: np.ndarray) -> int:
    """Center components off their cell's mean of the reference's scaled
    rows (the held-out rows are routed by them)."""
    bad = 0
    for cid in range(indices.shape[0]):
        mean = xs[indices[cid][mask[cid] > 0]].mean(0)
        tol = CENTER_TOL * np.maximum(np.abs(mean), 1.0)
        bad += int((np.abs(np.asarray(centers[cid], np.float64) - mean)
                    > tol).sum())
    return bad


def staged_faults(xs: np.ndarray, labels: np.ndarray, task_mask: np.ndarray,
                  indices: np.ndarray, mask: np.ndarray, order: np.ndarray,
                  x_cells: np.ndarray, mask_cells: np.ndarray,
                  y_cells: np.ndarray, tmask_cells: np.ndarray,
                  coefs: np.ndarray) -> int:
    """Staged slot arrays against the reference's rows and labels at the
    partition: features beyond float32 rounding of the reference's scaled
    row (2^-20 of its size, at least 2^-20), labels, masks, and any nonzero
    row of an empty or padding position (features or model)."""
    bad = 0
    k = indices.shape[1]
    for s, cid in enumerate(order):
        cid = int(cid)
        if cid < 0:
            want_m = np.zeros(k)
            want_x = np.zeros((k, xs.shape[1]))
            want_y = want_t = np.zeros((labels.shape[0], k))
        else:
            want_m = (mask[cid] > 0).astype(np.float64)
            ids = indices[cid]
            want_x = xs[ids]              # padding positions hold row 0
            want_y = labels[:, ids] * want_m[None]
            want_t = task_mask[:, ids] * want_m[None]
        tol = 2.0 ** -20 * np.maximum(np.abs(want_x), 1.0)
        bad += int((np.abs(x_cells[s] - want_x) > tol).sum())
        bad += int((mask_cells[s] != want_m).sum())
        bad += int((y_cells[s] != want_y).sum())
        bad += int((tmask_cells[s] != want_t).sum())
        bad += int((coefs[s][want_m == 0] != 0).sum())
    return bad


def argmin_winners(surface: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(gamma index, lambda index) of each (slot, task, sub) under the CV
    argmin: the first minimum with gamma outer and lambda inner.  surface
    (S, G, T, L, Sub) -> two (S, T, Sub) arrays."""
    s, g, t, l, u = surface.shape
    flat = surface.transpose(0, 2, 4, 1, 3).reshape(s, t, u, g * l)
    best = np.argmin(flat, axis=-1)
    return best // l, best % l


def selection_faults(surface: np.ndarray, gammas_cells: np.ndarray,
                     lambdas: np.ndarray, gamma: np.ndarray, lam: np.ndarray,
                     val_loss: np.ndarray) -> int:
    """Selected (gamma, lambda) and validation loss of each (slot, task,
    sub) that are not the argmin of the program's own surface."""
    g_idx, l_idx = argmin_winners(surface)
    s_idx = np.arange(surface.shape[0])[:, None, None]
    want_g = gammas_cells[s_idx, g_idx]
    want_l = lambdas[l_idx]
    t_idx = np.arange(surface.shape[2])[None, :, None]
    u_idx = np.arange(surface.shape[4])[None, None, :]
    want_v = surface[s_idx, g_idx, t_idx, l_idx, u_idx]
    return int((gamma != want_g).sum() + (lam != want_l).sum()
               + (val_loss != want_v).sum())
