"""Synthetic datasets in the spirit of the paper's benchmark suite.

The paper's data (BANK-MARKETING, COD-RNA, COVTYPE, ...) is not shippable;
these generators produce problems with the same qualitative structure:

  banana_mc     — the package's demo set: crescent-shaped classes (2D,
                  multi-class), non-linearly separable
  covtype_like  — overlapping anisotropic Gaussian mixture in d dims with
                  label noise (hard, like COVTYPE at ~20% Bayes error);
                  ``covtype_like_heldout`` draws further rows of one
                  call's mixture (a held-out set)
  gaussian_blobs— easy separable control
  regression_1d — heteroscedastic sine for quantile/expectile demos
"""
from __future__ import annotations

import numpy as np


def _banana(rng: np.random.Generator, n: int, flip: float, shift: np.ndarray,
            rot: float) -> np.ndarray:
    t = rng.uniform(0.2 * np.pi, 1.2 * np.pi, n)
    r = 2.0 + rng.normal(0, 0.35, n)
    pts = np.stack([r * np.cos(t), r * np.sin(t)], 1)
    c, s = np.cos(rot), np.sin(rot)
    pts = pts @ np.array([[c, -s], [s, c]]).T
    return pts * np.array([1.0, flip]) + shift


def banana_mc(n: int = 4000, n_classes: int = 4, seed: int = 0):
    """Multi-class banana set (the package's 'banana-mc' demo)."""
    rng = np.random.default_rng(seed)
    per = n // n_classes
    xs, ys = [], []
    for c in range(n_classes):
        shift = np.array([2.2 * (c % 2) - 0.8, 2.6 * (c // 2) - 0.8])
        xs.append(_banana(rng, per, 1.0 if c % 2 == 0 else -1.0, shift, 0.25 * c))
        ys.append(np.full(per, c))
    x = np.concatenate(xs).astype(np.float32)
    y = np.concatenate(ys).astype(np.int32)
    p = rng.permutation(len(x))
    return x[p], y[p]


def covtype_like(n: int = 10000, d: int = 10, n_classes: int = 2, seed: int = 0,
                 label_noise: float = 0.08, n_modes: int = 6):
    """Hard overlapping mixture: each class is a mixture of anisotropic
    Gaussians; modes of different classes interleave."""
    rng = np.random.default_rng(seed)
    xs, ys = [], []
    per = n // (n_classes * n_modes)
    for c in range(n_classes):
        for m in range(n_modes):
            mean = rng.normal(0, 1.6, d)
            a = rng.normal(0, 1, (d, d)) / np.sqrt(d)
            cov_half = 0.55 * a + 0.45 * np.eye(d)
            pts = rng.normal(size=(per, d)) @ cov_half.T + mean
            xs.append(pts)
            ys.append(np.full(per, c))
    x = np.concatenate(xs).astype(np.float32)
    y = np.concatenate(ys).astype(np.int32)
    flip = rng.uniform(size=len(y)) < label_noise
    y = np.where(flip, rng.integers(0, n_classes, len(y)), y).astype(np.int32)
    p = rng.permutation(len(x))
    return x[p], y[p]


def covtype_like_mixture(n: int = 10000, d: int = 10, n_classes: int = 2,
                         seed: int = 0, n_modes: int = 6):
    """The mixture behind ``covtype_like(n, d, n_classes, seed)``: its
    (class, mean, cov_half) per mode, drawn in covtype_like's order (each
    mode's training points are drawn and skipped, so the parameters of a
    later mode match)."""
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


def covtype_like_heldout(n_new: int, n: int = 10000, d: int = 10,
                         n_classes: int = 2, seed: int = 0,
                         new_seed: int = 1, label_noise: float = 0.08,
                         n_modes: int = 6):
    """``n_new`` further rows of the SAME distribution as
    ``covtype_like(n, d, n_classes, seed)`` (equal share per mode, the
    same label noise), drawn from ``new_seed``: a held-out test set for a
    model trained on that call's rows.  (``covtype_like`` with another
    seed draws another mixture.)"""
    modes = covtype_like_mixture(n, d, n_classes, seed, n_modes)
    rng = np.random.default_rng(new_seed)
    per = -(-n_new // len(modes))
    xs, ys = [], []
    for c, mean, cov_half in modes:
        xs.append(rng.normal(size=(per, d)) @ cov_half.T + mean)
        ys.append(np.full(per, c))
    x = np.concatenate(xs).astype(np.float32)
    y = np.concatenate(ys).astype(np.int32)
    flip = rng.uniform(size=len(y)) < label_noise
    y = np.where(flip, rng.integers(0, n_classes, len(y)), y).astype(np.int32)
    p = rng.permutation(len(x))[:n_new]
    return x[p], y[p]


def gaussian_blobs(n: int = 2000, d: int = 5, n_classes: int = 2, seed: int = 0,
                   sep: float = 3.0):
    rng = np.random.default_rng(seed)
    per = n // n_classes
    xs, ys = [], []
    for c in range(n_classes):
        mean = rng.normal(0, 1, d)
        mean = sep * mean / np.linalg.norm(mean)
        xs.append(rng.normal(size=(per, d)) + mean)
        ys.append(np.full(per, c))
    x = np.concatenate(xs).astype(np.float32)
    y = np.concatenate(ys).astype(np.int32)
    p = rng.permutation(len(x))
    return x[p], y[p]


def regression_1d(n: int = 1000, seed: int = 0, hetero: bool = True):
    """y = sin(3x)/ (heteroscedastic noise) — quantile/expectile demo."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (n, 1)).astype(np.float32)
    noise_scale = 0.08 + (0.25 * (x[:, 0] + 1.0) if hetero else 0.0)
    y = np.sin(3.0 * x[:, 0]) + noise_scale * rng.normal(size=n)
    return x, y.astype(np.float32)


def train_test_split(x: np.ndarray, y: np.ndarray, test_frac: float = 0.25,
                     seed: int = 0):
    """A seeded random split: (x_train, y_train, x_test, y_test)."""
    rng = np.random.default_rng(seed)
    p = rng.permutation(len(x))
    n_test = int(len(x) * test_frac)
    te, tr = p[:n_test], p[n_test:]
    return x[tr], y[tr], x[te], y[te]
