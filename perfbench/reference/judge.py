"""What decides ``correct``: the numbers that hold one fit of the window
against the plain reference, and the same numbers of the control.

A ``Case`` is one fit: the inputs the benchmark made (raw rows, labels,
held-out rows, the configuration's settings) and what the program produced
from them.  ``program_readings`` judges the program; ``control_readings``
puts the reference itself in the program's place, computed one precision
below the configuration's (``numerics.TF32``), and judges that the same
way.  Every number is a gap (0 for a perfect answer); ``compare`` holds each
against its limit.

Numbers, and the layer each holds:

* ``stage_faults`` (count): the cell partition against the reference's
  replay of the recursive plan (``staging.recursive_plan_faults``), its
  centers against the cells' means, and the staged rows, labels and masks
  of every slot against the reference's scaling and labels; model rows off
  the partition not zero.
* ``select_faults`` (count): selected (gamma, lambda) and validation loss
  of every (slot, task) that are not the argmin of the program's surface.
* ``cv_gap``: the cross-validation, the largest of three gaps: the
  validation-loss surface of every slot at its first gamma (where no warm
  start enters), and of ``CHECK_SLOTS`` sampled slots over the whole grid
  (the per-cell gamma grids, B1-sym, B2, every fold's solve, the
  validation products), as a share of the reference's loss where that
  exceeds 1 (least squares: at the grid points whose solves are well posed
  in float32, ``fit.KAPPA_MAX``); and the sampled slots' selected,
  fold-averaged models (FISTA and polish, or the eigh path, and the fold
  mean) by their values at their cell's rows, as a share of
  sum_j |c_j| K_j.  One number: a selected
  hinge model whose rows all sit on their box's bound is exact in any
  precision, so the models alone cannot tell a lower precision on such
  seeds, while the surface cannot see the fold mean.
* ``decision_gap``: the decisions on every held-out row of the fit (the
  test phase: routing, B1, B2, the product), as a share of
  sum_j |c_j| K_j.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from perfbench.reference import decide, fit, staging
from perfbench.reference.numerics import EXACT, TF32, Numerics

NAMES = ("stage_faults", "select_faults", "cv_gap", "decision_gap")
# slots whose whole gamma path the reference solves again; every slot is
# solved at its first gamma
CHECK_SLOTS = 2


@dataclasses.dataclass
class Case:
    """One fit: the benchmark's inputs and the program's outputs."""
    x: np.ndarray            # (n, d) raw training rows
    y: np.ndarray            # (n,) labels as given (class ids or +-1)
    x_held: np.ndarray       # (m, d) raw held-out rows
    settings: Dict           # liquidSVM keys, solver resolved
    indices: np.ndarray      # (cells, k) the partition
    mask: np.ndarray
    centers: np.ndarray      # (cells, d)
    order: np.ndarray        # (slots,) cell of each slot
    slot_of_cell: np.ndarray
    x_cells: np.ndarray      # (slots, k, d)
    mask_cells: np.ndarray
    y_cells: np.ndarray      # (slots, T, k)
    tmask_cells: np.ndarray
    gammas_cells: np.ndarray  # (slots, G)
    lambdas: np.ndarray       # (L,)
    surface: np.ndarray       # (slots, G, T, L, Sub)
    gamma: np.ndarray         # (slots, T, Sub) selected
    lam: np.ndarray
    val_loss: np.ndarray
    coefs: np.ndarray         # (slots, k, T, Sub) selected, fold-averaged
    dec: np.ndarray           # (m, T, Sub) held-out decisions


def live_slots(case: Case) -> np.ndarray:
    """The slots that hold a cell."""
    return np.flatnonzero(case.mask_cells.sum(-1) > 0)


def sample_slots(case: Case, seed: int) -> np.ndarray:
    """``CHECK_SLOTS`` nonempty slots drawn from ``seed`` (all if fewer)."""
    live = live_slots(case)
    rng = np.random.default_rng([seed, 1])
    return np.sort(rng.choice(live, min(CHECK_SLOTS, live.size),
                              replace=False))


def plan_faults(case: Case, xs: np.ndarray) -> int:
    """The partition's faults: structure, the replayed recursive plan and
    the centers (``perfbench.reference.staging``)."""
    st = case.settings
    bad = staging.partition_faults(case.indices, case.mask, case.order,
                                   case.x.shape[0], st["cell_size"])
    if bad:
        return bad
    if st["cell_method"] != "recursive":
        raise ValueError(f"reference plan: cell_method "
                         f"{st['cell_method']!r}")
    replay, _ = staging.recursive_plan_faults(
        xs, case.indices, case.mask, st["cell_size"], st.get("seed", 0))
    return replay + staging.center_faults(xs, case.indices, case.mask,
                                          case.centers)


def _staged(case: Case):
    """The reference's scaled training and held-out rows, labels, task
    mask."""
    xs, mean, std = staging.scale(case.x)
    xs_held = (np.asarray(case.x_held, np.float64) - mean) / std
    labels, tmask = staging.task_labels(case.y, case.settings["scenario"])
    return xs, xs_held, labels, tmask


def mirror(case: Case, slots: Sequence[int], nm: Numerics, device,
           n_gammas=None) -> fit.Mirror:
    """The reference's fit of ``slots`` in ``nm`` (first ``n_gammas``)."""
    xs, _, labels, tmask = _staged(case)
    return fit.fit_slots(nm, xs, labels, tmask, case.indices, case.mask,
                         case.order, case.order.shape[0], case.settings,
                         slots, device, n_gammas)


def _model_gap(case: Case, ref: fit.Mirror, xs: np.ndarray,
               slots: Sequence[int], g_idx: np.ndarray, l_idx: np.ndarray,
               coefs: np.ndarray, gammas: np.ndarray, device) -> float:
    """Selected models of the sampled slots, coefs (S', k, T, Sub) at
    gammas (S', T, Sub), judged by their values at their cell's own rows
    against the reference's models at the same grid points (S', T, Sub),
    as a share of sum_j |c_j| K_j.  Values, not coefficients: a model is
    what it predicts, and coefficients along the Gram's smallest
    eigenvectors are ill-posed where lambda is small."""
    worst = 0.0
    for i, s in enumerate(slots):
        cid = int(case.order[s])
        live = case.mask[cid] > 0
        pts = EXACT.tensor(xs[case.indices[cid]], device)
        d2 = fit.sq_dists(EXACT, pts, pts)[live]
        for t in range(coefs.shape[2]):
            for u in range(coefs.shape[3]):
                g, lam = g_idx[i, t, u], l_idx[i, t, u]
                k_ref = fit.gauss(d2, float(ref.gammas[i, g]))
                c_ref = EXACT.tensor(ref.coefs[i, g, :, t, lam, u], device)
                want = k_ref @ c_ref
                scale = k_ref @ c_ref.abs()
                got = fit.gauss(d2, float(gammas[i, t, u])) @ EXACT.tensor(
                    coefs[i, :, t, u], device)
                gap = ((got - want).abs() / torch.clamp(scale, min=1e-30))
                worst = max(worst, float(gap.max()))
    return worst


def _surface_gap(got: np.ndarray, ref: fit.Mirror) -> float:
    """Largest |loss - reference's| over the well-posed grid points,
    relative where the reference's loss exceeds 1 (squared errors; a 0-1
    loss never does)."""
    gap = np.abs(got - ref.surface) / np.maximum(np.abs(ref.surface), 1.0)
    return float(gap[ref.posed].max(initial=0.0))


def program_readings(case: Case, slots: Sequence[int], device
                     ) -> Tuple[Dict[str, float], Tuple[fit.Mirror, ...]]:
    """Every number of the program's fit, and the exact reference's fits
    of the sampled slots and of every slot's first gamma (to judge the
    control with)."""
    xs, xs_held, labels, tmask = _staged(case)
    ref = mirror(case, slots, EXACT, device)
    live = live_slots(case)
    first = mirror(case, live, EXACT, device, n_gammas=1)
    s = np.asarray(slots)
    out = {
        "stage_faults": float(
            plan_faults(case, xs)
            + staging.staged_faults(xs, labels, tmask, case.indices,
                                    case.mask, case.order, case.x_cells,
                                    case.mask_cells, case.y_cells,
                                    case.tmask_cells, case.coefs)),
        "select_faults": float(staging.selection_faults(
            case.surface, case.gammas_cells, case.lambdas, case.gamma,
            case.lam, case.val_loss)),
    }
    g_idx, l_idx = staging.argmin_winners(case.surface[s])
    out["cv_gap"] = max(_surface_gap(case.surface[live][:, :1], first),
                        _surface_gap(case.surface[s], ref),
                        _model_gap(case, ref, xs, slots, g_idx, l_idx,
                                   case.coefs[s], case.gamma[s], device))
    out["decision_gap"] = float(decide.decision_gaps(
        EXACT, xs_held, case.centers, case.slot_of_cell, xs, case.indices,
        case.mask, case.coefs, case.gamma, case.dec, device).max())
    return out, (ref, first)


def control_readings(case: Case, slots: Sequence[int], device,
                     refs: Tuple[fit.Mirror, ...]) -> Dict[str, float]:
    """The same numbers with the reference in TF32 in the program's place:
    its own fit of the sampled slots, selected by its own argmin, and its
    test phase of the program's models.  Staging and selection are the
    reference's own and read 0."""
    ref, first = refs
    ctl = mirror(case, slots, TF32, device)
    ctl_first = mirror(case, live_slots(case), TF32, device, n_gammas=1)
    xs, xs_held, _, _ = _staged(case)
    g_idx, l_idx = staging.argmin_winners(ctl.surface)
    t_idx = np.arange(ctl.coefs.shape[3])[None, :, None]
    u_idx = np.arange(ctl.coefs.shape[5])[None, None, :]
    i_idx = np.arange(len(slots))[:, None, None]
    sel = ctl.coefs[i_idx, g_idx, :, t_idx, l_idx, u_idx]   # (S',T,Sub,k)
    dec = decide.decisions(TF32, xs_held, case.centers, case.slot_of_cell,
                           xs, case.indices, case.mask, case.coefs,
                           case.gamma, device)
    return {
        "stage_faults": 0.0, "select_faults": 0.0,
        "cv_gap": max(_surface_gap(ctl_first.surface, first),
                      _surface_gap(ctl.surface, ref),
                      _model_gap(case, ref, xs, slots, g_idx, l_idx,
                                 sel.transpose(0, 3, 1, 2),
                                 ctl.gammas[i_idx, g_idx], device)),
        "decision_gap": float(decide.decision_gaps(
            EXACT, xs_held, case.centers, case.slot_of_cell, xs,
            case.indices, case.mask, case.coefs, case.gamma, dec,
            device).max()),
    }


def compare(readings: Dict[str, float], limits: Dict[str, float]
            ) -> Tuple[bool, Dict[str, Dict[str, float]]]:
    """(every reading finite and within its limit, {name: {value, limit}})."""
    rows = {}
    ok = True
    for name in NAMES:
        v, lim = float(readings[name]), float(limits[name])
        rows[name] = {"value": v, "limit": lim}
        ok &= bool(np.isfinite(v) and v <= lim)
    return ok, rows
