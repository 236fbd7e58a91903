"""Scenario-aware label combination (liquidSVM §2 "Managing Working Sets").

A task is a view of the working set with its own +-1 labels (or targets);
a trained model yields one decision column per (task, sub) pair.  This
module turns a (m, n_tasks, n_sub) decision block back into the
scenario's labels:

  binary     — one task, labels +-1                          (svm, hinge)
  ova        — one task per class: class c vs rest           (mcSVM OvA)
  ava        — one task per unordered pair (a, b)            (mcSVM AvA)
  weighted   — binary with a grid of class weights w         (wSVM / rocSVM)
  quantile   — regression; tau grid, selection PER TAU       (qtSVM)
  expectile  — regression; tau grid, selection PER TAU       (exSVM)
  ls         — least-squares regression, one task            (lsSVM)

Task creation (``make_tasks``) belongs to the training side and is not
part of this package yet.
"""
from __future__ import annotations

import numpy as np


def combine_ova(decisions: np.ndarray, classes: np.ndarray) -> np.ndarray:
    """decisions (n_tasks, n_test) -> predicted class values (argmax)."""
    return classes[np.argmax(decisions, axis=0)]


def combine_ava(decisions: np.ndarray, pairs: np.ndarray, classes: np.ndarray) -> np.ndarray:
    """Pairwise voting; decisions (n_tasks, n_test)."""
    n_test = decisions.shape[1]
    votes = np.zeros((len(classes), n_test), np.int32)
    for t, (a, b) in enumerate(pairs):
        win_a = decisions[t] > 0
        votes[a] += win_a
        votes[b] += ~win_a
    return classes[np.argmax(votes, axis=0)]


def combine_decisions(dec: np.ndarray, scenario: str,
                      classes: np.ndarray | None = None,
                      pairs: np.ndarray | None = None,
                      sub: int = 0) -> np.ndarray:
    """Scenario-aware label combination for a (m, n_tasks, n_sub) decision
    block — the serving engine's test-phase combiner.

    binary/weighted -> signs; ova -> argmax over tasks; ava -> pairwise
    votes; quantile/expectile -> the (m, n_taus) prediction matrix.
    """
    dec = np.asarray(dec)
    if scenario in ("binary", "weighted", "npsvm"):
        return np.sign(dec[:, 0, sub])
    if scenario == "ova":
        if classes is None or len(classes) == 0:
            raise ValueError("ova combination needs the class values")
        return combine_ova(dec[:, :, sub].T, np.asarray(classes))
    if scenario == "ava":
        if classes is None or len(classes) == 0 or pairs is None:
            raise ValueError("ava combination needs class values and pairs")
        return combine_ava(dec[:, :, sub].T, np.asarray(pairs),
                           np.asarray(classes))
    if scenario in ("quantile", "expectile"):
        return dec[:, 0, :]
    if scenario == "ls":
        return dec[:, 0, 0]
    raise ValueError(f"unknown scenario {scenario!r}")
