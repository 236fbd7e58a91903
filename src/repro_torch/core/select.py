"""Selection phase over the retained validation surface (the JAX
package's ``core/select.py``).

Training retains, per slot, the mean validation loss (and, for hinge, the
validation false-alarm and detection counts) at every (gamma, task,
lambda, sub) grid point; a selection rule maps that surface to the
winning grid coordinates per (slot, task, sub).  Here: the CV-loss argmin
(``argmin``, and its scenario aliases ``quantile`` / ``expectile``).  The
Neyman-Pearson (``npl``) and ROC (``roc``) rules are not ported yet.
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
_NOT_PORTED = ("npl", "roc")


def register_rule(name: str):
    def deco(fn: SelectionRule) -> SelectionRule:
        _RULES[name] = fn
        return fn
    return deco


def get_rule(name: str) -> SelectionRule:
    if name in _NOT_PORTED:
        raise NotImplementedError(f"selection rule {name!r} is not ported "
                                  f"yet; available: {available_rules()}")
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


def argmin_winners(loss: np.ndarray):
    """First-occurrence flat argmin over (gamma, lambda) per (slot, t, s):
    the train-time streaming selection (first strict improvement, gamma
    outer, lambda inner)."""
    n_lam = loss.shape[3]
    idx = _flat_gl(np.asarray(loss)).argmin(axis=-1)
    return idx // n_lam, idx % n_lam


@register_rule("argmin")
def rule_argmin(surface: Surface, ctx: SelectContext) -> RuleResult:
    g_idx, l_idx = argmin_winners(surface.loss)
    return RuleResult(g_idx=g_idx, l_idx=l_idx)


_RULES["quantile"] = rule_argmin
_RULES["expectile"] = rule_argmin
