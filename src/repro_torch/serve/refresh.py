"""Incremental bank refresh: warm-start ONLY the cells new data touched
(the JAX package's ``serve/refresh.py``).

A batch of fresh labelled points arrives; retraining the whole fit to fold
them in would cost a full grid sweep, but the cell decomposition localizes the
change: a new point only alters the decision function of the cell it
routes to.  So the refresh

  1. routes the new points with the FIT's own plan (``CellPlan.route`` —
     the same rule serving uses, so drift lands exactly where queries will
     be routed);
  2. folds each point into its cell's staged rows (padding rows first,
     then a FIFO overwrite of the oldest rows when the cell is full — the
     cell size k is a static shape and stays put);
  3. re-solves every (task, sub) column of the DRIFTED cells only, at the
     already-selected (gamma, lambda) — one targeted
     ``repro_torch.core.cv.resolve_group`` solve per (cell, selected
     gamma), on the fit's device,
     the same warm path ``TrainResult.select`` uses, not a grid sweep
     (the Glasmachers recipe: warm-started re-solves make incremental
     updates cheap enough to run under traffic);
  4. compacts a new :class:`~repro.serve.model_bank.ModelBank` with the
     version bumped, ready for ``SVMEngine.swap_bank``.

Untouched cells keep their coefficient columns bitwise intact, and the
routing centers never move (they define cell ownership; moving them would
silently re-route traffic), so a refreshed bank is a drop-in swap: an
engine mid-traffic re-routes only its queued requests.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Optional, Tuple

import numpy as np

from repro_torch.core import cv as cv_mod
from repro_torch.serve.model_bank import ModelBank

if TYPE_CHECKING:                      # session imports are heavy; type-only
    from repro_torch.api.session import SelectResult, TrainResult


def _labels_for(tasks, y_new: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Per-task (labels, mask) for new rows, under the FIT's task set.

    Mirrors ``repro_torch.tasks.builder.make_tasks`` per scenario, but
    against the ORIGINAL class/pair tables — a refresh batch that happens
    to miss a class must not renumber the tasks.
    """
    y = np.asarray(y_new)
    kind = tasks.kind
    if kind in ("binary", "weighted"):
        lab = np.asarray(y, np.float32)[None, :]
        return lab, np.ones_like(lab)
    if kind == "ova":
        lab = np.stack([np.where(y == c, 1.0, -1.0)
                        for c in tasks.classes]).astype(np.float32)
        return lab, np.ones_like(lab)
    if kind == "ava":
        labs = []
        for a, b in np.asarray(tasks.pairs):
            labs.append(np.where(y == tasks.classes[a], 1.0,
                                 np.where(y == tasks.classes[b], -1.0, 0.0)))
        lab = np.asarray(labs, np.float32)
        return lab, (lab != 0.0).astype(np.float32)
    # regression scenarios: one task, raw targets
    lab = np.asarray(y, np.float32)[None, :]
    return np.repeat(lab, tasks.n_tasks, axis=0), \
        np.ones((tasks.n_tasks, y.shape[0]), np.float32)


def refresh_bank(
    tr: "TrainResult",
    sel: "SelectResult",
    x_new: np.ndarray,
    y_new: np.ndarray,
    *,
    base_version: Optional[int] = None,
    drop_tol: Optional[float] = 0.0,
    dtype: str = "f32",
    dedup: bool = True,
) -> Tuple[ModelBank, dict]:
    """Fold new labelled points into the fit and build a swappable bank.

    Returns ``(bank, info)``: a bank whose version is ``base_version + 1``
    (default: one past the select output's base of 0) and an info dict
    (``drifted_slots``, ``rows_added``, ``rows_evicted``,
    ``resolve_calls``, ``columns_resolved``).  Cells no new point routed
    to are bitwise untouched.
    """
    x_new = np.asarray(x_new, np.float32)
    if x_new.ndim == 1:
        x_new = x_new[None, :]
    dev = tr.device
    xs = tr.scaler.transform(x_new)
    lab_new, msk_new = _labels_for(tr.tasks, y_new)

    cell_of = tr.plan.route(xs)
    slot_of = np.asarray(tr.packed.slot_of_cell)[cell_of]

    x_cells = sel.x_cells.copy()
    mask_cells = sel.mask_cells.copy()
    y_cells = tr.y_cells.copy()
    tmask_cells = tr.tmask_cells.copy()
    coefs = sel.coefs.copy()

    k = x_cells.shape[1]
    info = {"drifted_slots": 0, "rows_added": 0, "rows_evicted": 0,
            "resolve_calls": 0, "columns_resolved": 0}

    if tr.cv_cfg.solver in ("quantile", "expectile"):
        sub_grid = np.asarray(tr.config.taus, np.float32)
    else:
        sub_grid = np.asarray(tr.config.weights, np.float32)

    for c in np.unique(slot_of):
        c = int(c)
        rows = np.flatnonzero(slot_of == c)
        if rows.size > k:                    # cell-sized batch: newest win
            rows = rows[-k:]
        # placement: padding rows first, then FIFO-overwrite the oldest
        free = np.flatnonzero(mask_cells[c] == 0)
        live = np.flatnonzero(mask_cells[c] > 0)
        pos = np.concatenate([free, live])[: rows.size]
        info["rows_evicted"] += int(max(rows.size - free.size, 0))
        info["rows_added"] += int(rows.size)
        x_cells[c, pos] = xs[rows]
        mask_cells[c, pos] = 1.0
        y_cells[c][:, pos] = lab_new[:, rows]
        tmask_cells[c][:, pos] = msk_new[:, rows]
        info["drifted_slots"] += 1

        # re-solve EVERY column of the drifted cell at its already-selected
        # (gamma, lambda) — grouped per selected gamma, padded to the same
        # static (T*S) width select() compiles (shared program); the
        # serving model being replaced is the warm start (the drift moved
        # some rows, not the whole solution)
        for gv in np.unique(sel.gamma[c]):
            ts = np.argwhere(sel.gamma[c] == gv)          # (m, 2)
            (out,), _ = cv_mod.resolve_group(
                x_cells[c][None], y_cells[c][None], tmask_cells[c][None],
                mask_cells[c][None], tr.fold_keys[c][None],
                np.float32([gv]), [ts], sel.lam[c][None], sub_grid,
                sel.coefs[c][None], tr.cv_cfg, dev)
            for j, (t, s) in enumerate(ts):
                coefs[c, :, t, s] = out[:, j]
            info["columns_resolved"] += len(ts)
            info["resolve_calls"] += 1

    if base_version is None:
        base_version = 0
    refreshed = dataclasses.replace(sel, x_cells=x_cells,
                                    mask_cells=mask_cells, coefs=coefs)
    bank = refreshed.to_bank(drop_tol=drop_tol, dtype=dtype, dedup=dedup,
                             version=int(base_version) + 1)
    return bank, info


def refresh_drifted(
    tr: "TrainResult",
    sel: "SelectResult",
    x_feed: np.ndarray,
    y_feed: np.ndarray,
    drifted_slots,
    **kwargs,
) -> Tuple[Optional[ModelBank], dict]:
    """Refresh EXACTLY the drifted cells from a labelled feedback pool.

    The closed loop's refresh half (``serve.monitor`` names the slots, this
    routes the feedback): feedback rows are routed with the fit's own plan
    and only those landing in ``drifted_slots`` are folded in, so
    :func:`refresh_bank` re-solves the drifted cells' columns and nothing
    else — cells the monitor did not flag stay bitwise intact even when the
    feedback pool contains rows for them.

    Returns ``(bank, info)`` like :func:`refresh_bank`, with
    ``feedback_rows`` / ``feedback_used`` added; ``bank`` is ``None`` (no
    refresh, no version bump) when no feedback row routes into a drifted
    slot — the caller keeps serving the current bank.
    """
    x_feed = np.asarray(x_feed, np.float32)
    if x_feed.ndim == 1:
        x_feed = x_feed[None, :]
    y_feed = np.asarray(y_feed)
    drifted = np.unique(np.asarray(list(drifted_slots), np.int64))
    xs = tr.scaler.transform(x_feed)
    slot_of = np.asarray(tr.packed.slot_of_cell)[tr.plan.route(xs)]
    keep = np.isin(slot_of, drifted)
    feed_info = {"feedback_rows": int(x_feed.shape[0]),
                 "feedback_used": int(keep.sum())}
    if not keep.any():
        return None, {"drifted_slots": 0, "rows_added": 0, "rows_evicted": 0,
                      "resolve_calls": 0, "columns_resolved": 0, **feed_info}
    bank, info = refresh_bank(tr, sel, x_feed[keep], y_feed[keep], **kwargs)
    info.update(feed_info)
    return bank, info
