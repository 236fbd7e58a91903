"""Selection phase over the retained validation surface (the JAX
package's ``core/select.py``).

Training retains, per slot, the mean validation loss (and, for hinge, the
validation false-alarm and detection counts) at every (gamma, task,
lambda, sub) grid point; a selection rule maps that surface to the
winning grid coordinates per (slot, task, sub).  Registered rules:

  argmin                — CV-loss argmin per (task, sub); the models the
                          train stage cached (nothing is re-solved)
  quantile / expectile  — aliases of argmin (selection is already per tau)
  npl                   — per (task, weight): best validation detection
                          among grid points whose validation false-alarm
                          rate is <= alpha (fallback: smallest false
                          alarm), plus the NP weight pick over the sub axis
  roc                   — argmin winners per weight + the aggregated
                          (false alarm, detection) front over the weight
                          grid, sorted along the false-alarm axis

Counts, not rates, are retained, so aggregating over cells is exact: every
valid sample lands in exactly one validation fold of its one cell.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import numpy as np
import torch


def combine_fold_models(fold_coefs: torch.Tensor, how: str = "average",
                        dim: int = 0) -> torch.Tensor:
    """Average the k fold models along ``dim`` (coefficients are linear in
    the decision function, so this averages the functions).  The sum is
    scaled by 1/k, as jnp.mean does, not divided by k: the two round
    differently in the last bit."""
    if how == "average":
        return fold_coefs.sum(dim=dim) * (1.0 / fold_coefs.shape[dim])
    raise ValueError(how)


@dataclasses.dataclass(frozen=True)
class Surface:
    """The per-slot validation surface a trained session retains."""
    loss: np.ndarray      # (C, G, T, L, S) mean validation loss
    fa: np.ndarray        # (C, G, T, L, S) validation false-alarm counts
    det: np.ndarray       # (C, G, T, L, S) validation detection counts
    neg: np.ndarray       # (C, T) negative-class valid-sample totals
    pos: np.ndarray       # (C, T) positive-class valid-sample totals
    gammas: np.ndarray    # (C, G) per-cell gamma grids
    lambdas: np.ndarray   # (L,) shared lambda grid

    @property
    def grid_columns(self) -> int:
        return int(np.prod(self.loss.shape))


@dataclasses.dataclass(frozen=True)
class SelectContext:
    """Scenario knobs a rule may consult."""
    scenario: str = "binary"
    weights: np.ndarray = dataclasses.field(
        default_factory=lambda: np.ones(1, np.float32))
    taus: np.ndarray = dataclasses.field(
        default_factory=lambda: np.full(1, 0.5, np.float32))
    alpha: float = 0.05
    npl_class: int = -1


@dataclasses.dataclass
class RuleResult:
    """Winning grid coordinates per (slot, task, sub) + rule extras."""
    g_idx: np.ndarray     # (C, T, S)
    l_idx: np.ndarray     # (C, T, S)
    extras: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)


SelectionRule = Callable[[Surface, SelectContext], RuleResult]

_RULES: Dict[str, SelectionRule] = {}


def register_rule(name: str):
    def deco(fn: SelectionRule) -> SelectionRule:
        _RULES[name] = fn
        return fn
    return deco


def get_rule(name: str) -> SelectionRule:
    if name not in _RULES:
        raise KeyError(f"unknown selection rule {name!r}; "
                       f"known: {available_rules()}")
    return _RULES[name]


def available_rules() -> Tuple[str, ...]:
    return tuple(sorted(_RULES))


def _flat_gl(grid: np.ndarray) -> np.ndarray:
    """(C, G, T, L, S) -> (C, T, S, G*L), gamma-major like the train scan."""
    c, g, t, l, s = grid.shape
    return grid.transpose(0, 2, 4, 1, 3).reshape(c, t, s, g * l)


def _unflat_gl(idx: np.ndarray, n_lam: int):
    return idx // n_lam, idx % n_lam


def argmin_winners(loss: np.ndarray):
    """First-occurrence flat argmin over (gamma, lambda) per (slot, t, s):
    the train-time streaming selection (first strict improvement, gamma
    outer, lambda inner)."""
    n_lam = loss.shape[3]
    idx = _flat_gl(np.asarray(loss)).argmin(axis=-1)
    return _unflat_gl(idx, n_lam)


def np_select_weight(false_alarm: np.ndarray, detection: np.ndarray,
                     alpha: float) -> int:
    """Neyman-Pearson pick over the weight axis: the weight with the best
    detection among those with false_alarm <= alpha, else the smallest
    false alarm.  (n_weights,) rates in; the first index wins ties, as
    ``jnp.argmax`` / ``jnp.argmin`` do."""
    false_alarm = np.asarray(false_alarm)
    ok = false_alarm <= alpha
    if ok.any():
        return int(np.where(ok, np.asarray(detection), -np.inf).argmax())
    return int(false_alarm.argmin())


def _constrained_rates(surface: Surface, ctx: SelectContext):
    """Count grids + totals oriented so 'fa' is the constrained class's
    error and 'det' the other class's hit rate (npl_class=-1: the stored
    orientation; npl_class=+1: alarms are +1 samples predicted -1)."""
    neg = surface.neg[:, None, :, None, None]       # (C, 1, T, 1, 1)
    pos = surface.pos[:, None, :, None, None]
    if ctx.npl_class == -1:
        return surface.fa, surface.det, neg, pos
    if ctx.npl_class == 1:
        return pos - surface.det, neg - surface.fa, pos, neg
    raise ValueError(f"npl_class must be +-1, got {ctx.npl_class}")


def _global_rates_at(cnt: np.ndarray, tot: np.ndarray,
                     g_idx: np.ndarray, l_idx: np.ndarray):
    """Aggregate count grids at the winners into whole-set rates (T, S)."""
    c_ax = np.arange(cnt.shape[0])[:, None, None]
    t_ax = np.arange(cnt.shape[2])[None, :, None]
    s_ax = np.arange(cnt.shape[4])[None, None, :]
    picked = cnt[c_ax, g_idx, t_ax, l_idx, s_ax]    # (C, T, S)
    denom = np.maximum(tot[:, 0, :, 0, 0].sum(0), 1.0)       # (T,)
    return picked.sum(0) / denom[:, None]           # (T, S)


@register_rule("argmin")
def rule_argmin(surface: Surface, ctx: SelectContext) -> RuleResult:
    g_idx, l_idx = argmin_winners(surface.loss)
    return RuleResult(g_idx=g_idx, l_idx=l_idx)


_RULES["quantile"] = rule_argmin
_RULES["expectile"] = rule_argmin


@register_rule("npl")
def rule_npl(surface: Surface, ctx: SelectContext) -> RuleResult:
    """Neyman-Pearson: constrained (gamma, lambda) pick per (task, weight).

    Per cell and (task, weight) column: among grid points whose validation
    false-alarm rate (on the constrained class) meets ``ctx.alpha``, take
    the best detection (the first in scan order); if no point qualifies,
    the smallest false alarm.  Extras carry the exact whole-set validation
    rates at the winners and the NP weight pick per task."""
    fa_cnt, det_cnt, fa_tot, det_tot = _constrained_rates(surface, ctx)
    fa_rate = fa_cnt / np.maximum(fa_tot, 1.0)
    det_rate = det_cnt / np.maximum(det_tot, 1.0)

    n_lam = surface.loss.shape[3]
    fa_f = _flat_gl(fa_rate)
    det_f = _flat_gl(det_rate)
    ok = fa_f <= ctx.alpha
    # numpy's argmax over a row of -inf returns 0, the first index, like
    # the reference; those rows take the fallback anyway
    best_ok = np.where(ok, det_f, -np.inf).argmax(axis=-1)
    fallback = fa_f.argmin(axis=-1)
    idx = np.where(ok.any(axis=-1), best_ok, fallback)
    g_idx, l_idx = _unflat_gl(idx, n_lam)

    np_fa = _global_rates_at(fa_cnt, fa_tot, g_idx, l_idx)      # (T, S)
    np_det = _global_rates_at(det_cnt, det_tot, g_idx, l_idx)
    w_idx = np.asarray([np_select_weight(np_fa[t], np_det[t], ctx.alpha)
                        for t in range(np_fa.shape[0])], np.int32)
    return RuleResult(g_idx=g_idx, l_idx=l_idx,
                      extras={"np_fa": np_fa, "np_det": np_det,
                              "np_weight_idx": w_idx,
                              "alpha": np.float32(ctx.alpha),
                              "npl_class": np.int32(ctx.npl_class)})


@register_rule("roc")
def rule_roc(surface: Surface, ctx: SelectContext) -> RuleResult:
    """ROC mode: one working point per class weight.  Winners are the
    per-(task, weight) CV-loss argmins (nothing is re-solved); the extras
    carry the (false alarm, detection) front over the weight grid, sorted
    along the false-alarm axis (``roc_front[t, i] = (fa, det)``)."""
    g_idx, l_idx = argmin_winners(surface.loss)
    fa_cnt, det_cnt, fa_tot, det_tot = _constrained_rates(surface, ctx)
    roc_fa = _global_rates_at(fa_cnt, fa_tot, g_idx, l_idx)     # (T, S)
    roc_det = _global_rates_at(det_cnt, det_tot, g_idx, l_idx)
    order = np.argsort(roc_fa, axis=1, kind="stable")           # (T, S)
    front = np.stack([np.take_along_axis(roc_fa, order, 1),
                      np.take_along_axis(roc_det, order, 1)], axis=-1)
    return RuleResult(g_idx=g_idx, l_idx=l_idx,
                      extras={"roc_fa": roc_fa, "roc_det": roc_det,
                              "roc_order": order.astype(np.int32),
                              "roc_front": front})
