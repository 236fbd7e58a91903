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

``make_tasks`` builds the tasks of a scenario; static shapes: labels
(n_tasks, n) f32 with 0 = excluded from the task.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Sequence

import numpy as np


@dataclasses.dataclass
class TaskSet:
    kind: str
    labels: np.ndarray       # (n_tasks, n) f32: +-1 labels or regression target
    task_mask: np.ndarray    # (n_tasks, n) f32: 1 = sample participates
    classes: np.ndarray      # (n_classes,) original class values (classification)
    pairs: np.ndarray        # (n_tasks, 2) int — AvA class-index pairs (or -1)
    taus: np.ndarray         # (n_taus,) for quantile/expectile else [0.5]
    weights: np.ndarray      # (n_weights,) hinge weight grid else [1.0]

    @property
    def n_tasks(self) -> int:
        return self.labels.shape[0]


def make_tasks(
    y: np.ndarray,
    scenario: str = "binary",
    taus: Sequence[float] = (0.05, 0.5, 0.95),
    weights: Sequence[float] = (1.0,),
) -> TaskSet:
    y = np.asarray(y)
    n = y.shape[0]
    ones = np.ones((1, n), np.float32)

    if scenario in ("binary", "weighted"):
        labels = np.asarray(y, np.float32)[None, :]
        if not set(np.unique(labels)) <= {-1.0, 1.0}:
            raise ValueError("binary labels must be +-1")
        return TaskSet(scenario, labels, ones.copy(), np.array([-1.0, 1.0]),
                       -np.ones((1, 2), np.int32), np.array([0.5], np.float32),
                       np.asarray(weights, np.float32))

    if scenario == "ova":
        classes = np.unique(y)
        labels = np.stack([np.where(y == c, 1.0, -1.0)
                           for c in classes]).astype(np.float32)
        mask = np.ones_like(labels, np.float32)
        return TaskSet(scenario, labels, mask, classes,
                       -np.ones((len(classes), 2), np.int32),
                       np.array([0.5], np.float32), np.array([1.0], np.float32))

    if scenario == "ava":
        classes = np.unique(y)
        pairs = list(itertools.combinations(range(len(classes)), 2))
        labels, masks = [], []
        for a, b in pairs:
            la = np.where(y == classes[a], 1.0,
                          np.where(y == classes[b], -1.0, 0.0))
            labels.append(la)
            masks.append((la != 0.0).astype(np.float32))
        return TaskSet(scenario, np.asarray(labels, np.float32),
                       np.asarray(masks, np.float32), classes,
                       np.asarray(pairs, np.int32), np.array([0.5], np.float32),
                       np.array([1.0], np.float32))

    if scenario in ("quantile", "expectile"):
        labels = np.asarray(y, np.float32)[None, :]
        return TaskSet(scenario, labels, ones.copy(), np.array([]),
                       -np.ones((1, 2), np.int32), np.asarray(taus, np.float32),
                       np.array([1.0], np.float32))

    if scenario == "ls":
        labels = np.asarray(y, np.float32)[None, :]
        return TaskSet(scenario, labels, ones.copy(), np.array([]),
                       -np.ones((1, 2), np.int32), np.array([0.5], np.float32),
                       np.array([1.0], np.float32))

    raise ValueError(f"unknown scenario {scenario!r}")


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
