"""Scenario front-ends (liquidSVM §3 "Learning Scenarios"; the JAX
package's ``api/scenarios.py``).

The package ships pre-configured entry points — ``mcSVM``, ``lsSVM``,
``qtSVM``, ``exSVM``, ``nplSVM``, ``rocSVM`` — that wire the right task
construction, solver, weight/tau grids AND the right selection rule, so
users never touch hyper-parameters.  Each front-end here returns a
configured :class:`repro_torch.api.session.SVM` session; the staged cycle
is then uniform across scenarios:

    sess = mcSVM(x, y, FOLDS=3)
    sess.train(); sess.select(); print(sess.test(xt, yt).error)

All front-ends accept string config keys (see
:mod:`repro_torch.api.config`) as keyword arguments, e.g. ``qtSVM(x, y,
FOLDS=3, VORONOI="voronoi", CELL_SIZE=500)``, and ``device=`` (None: the
current card; ``"cpu"``: the plain PyTorch path).
"""
from __future__ import annotations

from typing import Optional, Sequence

from repro_torch.api.config import (apply_keys, split_embed_keys,
                                    split_serve_keys, weight_grid)
from repro_torch.api.session import SVM
from repro_torch.kernels import runtime
from repro_torch.train.svm_trainer import SVMTrainerConfig


def _session(scenario: str, x, y, keys: dict,
             select_rule: Optional[str] = None,
             select_kwargs: Optional[dict] = None,
             **cfg_fields) -> SVM:
    device = runtime.resolve_device(keys.pop("device", None))
    base = SVMTrainerConfig(scenario=scenario, **cfg_fields)
    keys, embed_kw = split_embed_keys(keys)
    if embed_kw:
        # EMBED_ARCH flags x as a token corpus: wrap it so the scenario
        # trains over lazily-computed frozen-backbone embeddings
        from repro_torch.embed import embed_source
        x = embed_source(x, device=device, **embed_kw)
    keys, serve_kw = split_serve_keys(keys)
    cfg, key_select = apply_keys(base, keys)
    merged = {**key_select, **(select_kwargs or {})}
    return SVM(x, y, config=cfg, device=device, select_rule=select_rule,
               select_kwargs=merged, serve_kwargs=serve_kw)


def mcSVM(x, y, mc_type: str = "OvA", **keys) -> SVM:
    """Multiclass classification: one-versus-all (default) or all-versus-
    all hinge tasks over the class values in ``y``."""
    kinds = {"ova": "ova", "ava": "ava",
             "ova_hinge": "ova", "ava_hinge": "ava"}
    k = kinds.get(mc_type.lower())
    if k is None:
        raise ValueError(f"mc_type must be OvA|AvA, got {mc_type!r}")
    return _session(k, x, y, keys)


def lsSVM(x, y, **keys) -> SVM:
    """Least-squares regression (kernel ridge on the cells)."""
    return _session("ls", x, y, keys)


def qtSVM(x, y, taus: Sequence[float] = (0.05, 0.1, 0.5, 0.9, 0.95),
          **keys) -> SVM:
    """Quantile regression: pinball solver, one selected model per tau."""
    return _session("quantile", x, y, keys, select_rule="quantile",
                    taus=tuple(float(t) for t in taus))


def exSVM(x, y, taus: Sequence[float] = (0.05, 0.1, 0.5, 0.9, 0.95),
          **keys) -> SVM:
    """Expectile regression: asymmetric-least-squares solver, per tau."""
    return _session("expectile", x, y, keys, select_rule="expectile",
                    taus=tuple(float(t) for t in taus))


def nplSVM(x, y, npl_class: int = -1, constraint: float = 0.05,
           weights: Optional[Sequence[float]] = None, **keys) -> SVM:
    """Neyman-Pearson classification: false alarm on ``npl_class``
    constrained to ``constraint``, detection maximized.

    Trains the class-weight grid once; ``select()`` defaults to the
    ``"npl"`` rule, whose rates come from the retained VALIDATION surface
    (re-runnable with a different ``alpha``/``npl_class`` without
    retraining: ``sess.select(alpha=0.01)``).
    """
    w = tuple(float(v) for v in (weights if weights is not None
                                 else weight_grid(0.25, 4.0, 5)))
    return _session("npsvm", x, y, keys, select_rule="npl",
                    select_kwargs={"alpha": float(constraint),
                                   "npl_class": int(npl_class)},
                    weights=w, np_alpha=float(constraint))


def rocSVM(x, y, weight_steps: int = 9, min_weight: float = 1.0 / 9.0,
           max_weight: float = 9.0, **keys) -> SVM:
    """ROC curve via weighted binary SVMs: one working point per class
    weight, the whole (false alarm, detection) front emitted.

    ``select()`` defaults to the ``"roc"`` rule: winners are the cached
    per-weight CV argmins (nothing is re-solved) and
    ``SelectResult.extras["roc_front"]`` carries the front aggregated
    from the retained validation counts.
    """
    w = weight_grid(min_weight, max_weight, weight_steps)
    return _session("weighted", x, y, keys, select_rule="roc", weights=w)
