"""The benchmark's ``covtype_like`` rows: a hard, overlapping class mixture at
a data set's widths and published class shares.

Derived from the program's ``repro_torch.data.synthetic.covtype_like`` (the
same modes, drawn in the same order) and kept here, not imported: a later
change to the program's generator cannot move the yardstick.

Each class is a mixture of ``n_modes`` anisotropic Gaussians whose modes
interleave, with uniform label noise (Covertype has ~20 % Bayes error).  The
configuration's ``data`` block fixes the mixture (``mixture_seed``: the
deployment's data set) and the share of each class (``class_counts``, the
data set's published counts); every training set draws its rows of that
mixture from its own generator, with the same count of rows in each class,
and its label noise from another.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np

Mode = Tuple[int, np.ndarray, np.ndarray]


def mixture(n: int, d: int, n_classes: int, seed: int,
            n_modes: int = 6) -> List[Mode]:
    """The (class, mean, cov_half) of every mode, drawn in the order of
    ``covtype_like(n, d, n_classes, seed)``: each mode's points are drawn
    and skipped, so the parameters match that call's."""
    rng = np.random.default_rng(seed)
    per = n // (n_classes * n_modes)
    modes = []
    for c in range(n_classes):
        for _ in range(n_modes):
            mean = rng.normal(0, 1.6, d)
            a = rng.normal(0, 1, (d, d)) / np.sqrt(d)
            cov_half = 0.55 * a + 0.45 * np.eye(d)
            rng.normal(size=(per, d))
            modes.append((c, mean, cov_half))
    return modes


def class_sizes(n: int, counts: Sequence[float]) -> np.ndarray:
    """``n`` rows shared out in proportion to ``counts`` by largest
    remainder (ties to the lower class id): the same sizes for every
    draw."""
    share = np.asarray(counts, np.float64) / float(np.sum(counts))
    exact = n * share
    sizes = np.floor(exact).astype(np.int64)
    rest = np.argsort(-(exact - sizes), kind="stable")[:n - int(sizes.sum())]
    sizes[rest] += 1
    return sizes


def draw(modes: Sequence[Mode], sizes: Sequence[int],
         rng: np.random.Generator) -> Tuple[np.ndarray, np.ndarray]:
    """``sizes[c]`` rows of class ``c``, split evenly over its modes (the
    first modes take the remainder), shuffled: x (n, d) float32 and each
    row's class, y (n,) int32 (no label noise)."""
    by_class: Dict[int, List[Mode]] = {}
    for mode in modes:
        by_class.setdefault(mode[0], []).append(mode)
    xs, ys = [], []
    for c, group in sorted(by_class.items()):
        per = np.full(len(group), sizes[c] // len(group))
        per[:sizes[c] % len(group)] += 1
        for (_, mean, cov_half), cnt in zip(group, per):
            xs.append(rng.normal(size=(cnt, mean.shape[0])) @ cov_half.T
                      + mean)
            ys.append(np.full(cnt, c))
    x = np.concatenate(xs).astype(np.float32)
    y = np.concatenate(ys).astype(np.int32)
    p = rng.permutation(len(x))
    return x[p], y[p]


def label_noise(y: np.ndarray, n_classes: int, rng: np.random.Generator,
                rate: float = 0.08) -> np.ndarray:
    """``covtype_like``'s label noise: each label replaced, with
    probability ``rate``, by a class drawn uniformly (itself included)."""
    flip = rng.uniform(size=len(y)) < rate
    return np.where(flip, rng.integers(0, n_classes, len(y)),
                    y).astype(np.int32)


def make_draw(data: Dict) -> Callable[..., Tuple[np.ndarray, np.ndarray]]:
    """The configuration's data set as ``draw(n, rows_rng, labels_rng) ->
    (x, y)``: ``n`` rows drawn by ``rows_rng`` with the class sizes of
    ``class_counts``, their labels noised by ``labels_rng``."""
    d, n_cls = data["features"], data["classes"]
    modes = mixture(data["mixture_rows"], d, n_cls, data["mixture_seed"],
                    data["n_modes"])
    counts = data["class_counts"]
    if len(counts) != n_cls:
        raise ValueError(f"class_counts has {len(counts)} entries, "
                         f"classes {n_cls}")

    def draw_rows(n: int, rows_rng: np.random.Generator,
                  labels_rng: np.random.Generator):
        x, y = draw(modes, class_sizes(n, counts), rows_rng)
        return x, label_noise(y, n_cls, labels_rng, data["label_noise"])
    return draw_rows
