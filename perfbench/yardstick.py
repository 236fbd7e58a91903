"""The card's published peaks and the arithmetic of a fit's work: the FLOPs
and bytes each kernel and the whole fit need, from the fit's own sizes.

Peaks: NVIDIA's H100 SXM data sheet, dense rates at the full 700 W power
limit (each run records the card's ``power.limit`` beside them).  The fit
runs float32 products with TF32 off, so its compute peak is the CUDA cores'
67 TFLOP/s.

Counts are of what the inputs need, at each cell's own live rows n_c (not
the padded k of its slot), so padding a kernel computes counts as waste:

* B1-sym (the wave's D^2): n_c (n_c + 1) / 2 pairs of 2d + 3 operations;
  reads the rows, writes the n_c^2 matrix.
* B2 (a gamma's epilogue): reads and writes n_c^2 floats.
* B4 (a Gauss-Seidel epoch): 2 n_c^2 F P operations (a rank-1 gradient
  update of n_c rows per coordinate, column and fold); reads K once and the
  (F, n_c, P) iterate, box and gradient.
* the test phase: B1 over the m_c rows routed to a cell (m_c n_c pairs of
  2d + 3), B2 writing its P kernels, the product 2 m_c n_c P.
* FISTA (hinge): one K C product, 2 n_c^2 P a fold, per iteration of that
  fold, per residual check (every 10) and once at the end; 33 K v products
  a slot for the step (power iteration); ``cd_polish`` epochs and their
  start gradient; the validation product 2 n_c^2 F P.
* least squares: one symmetric eigendecomposition with vectors a (slot,
  fold), 9 n_c^3 operations (Golub & Van Loan, *Matrix Computations*,
  the symmetric QR algorithm: tridiagonalisation with its Q, then implicit
  QR steps accumulating vectors), and two products of 2 n_c^2 P.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

PEAKS = {
    "fp64_flops": 34e12, "fp32_flops": 67e12, "tf32_flops": 495e12,
    "bf16_flops": 989e12, "fp8_flops": 1979e12, "hbm_bytes_per_s": 3.35e12,
    "memory_bytes": 80e9, "power_w": 700.0,
}
F32 = 4


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: operations at the FP32 peak or
    bytes at the HBM rate, whichever is longer."""
    return max(flops / PEAKS["fp32_flops"], nbytes / PEAKS["hbm_bytes_per_s"])


def kernel_bounds_s(fit: Dict) -> Dict[str, float]:
    """Least seconds of each hand-written kernel family over one fit.

    ``fit``: ``live`` (S,) live rows a slot, ``held`` (S,) held-out rows
    routed to it, ``d``, ``G`` gammas, ``F`` folds, ``P`` columns (tasks x
    lambdas x subs), ``Pt`` test columns (tasks x subs), ``cd_polish``
    epochs, ``solver``."""
    n = np.asarray(fit["live"], np.float64)
    m = np.asarray(fit["held"], np.float64)
    d, g, f, p, pt = fit["d"], fit["G"], fit["F"], fit["P"], fit["Pt"]
    ops_pair = 2.0 * d + 3.0
    n2, mn = n * n, m * n
    # one launch covers every slot: its bound is of the summed work
    b1 = bound_s((n * (n + 1) / 2).sum() * ops_pair,
                 F32 * (n * d + n2).sum())
    b1 += bound_s(mn.sum() * ops_pair, F32 * ((m + n) * d + mn).sum())
    b2 = g * bound_s(3.0 * n2.sum(), 2 * F32 * n2.sum())
    b2 += bound_s(3.0 * pt * mn.sum(), F32 * (1 + pt) * mn.sum())
    b4 = 0.0
    if fit["solver"] == "hinge":
        b4 = g * fit["cd_polish"] * bound_s(
            2.0 * f * p * n2.sum(), F32 * (n2 + 6 * f * p * n).sum())
    return {"B1": b1, "B2": b2, "B4": b4}


def fit_flops(fit: Dict) -> float:
    """Operations one fit needs (see the module docstring); ``fit`` as for
    :func:`kernel_bounds_s`, plus ``iters`` (S, G, F) box-QP iterations."""
    n = np.asarray(fit["live"], np.float64)
    m = np.asarray(fit["held"], np.float64)
    d, g, f, p, pt = fit["d"], fit["G"], fit["F"], fit["P"], fit["Pt"]
    ops_pair = 2.0 * d + 3.0
    n2 = n * n
    total = float((n * (n + 1) / 2 * ops_pair).sum())        # B1-sym
    total += g * float((3.0 * n2).sum())                       # B2
    total += g * float((2.0 * n2 * f * p).sum())               # validation
    if fit["solver"] == "hinge":
        it = np.asarray(fit["iters"], np.float64)              # (S, G, F)
        prods = it + np.floor(it / 10.0) + 1.0
        total += float((2.0 * n2[:, None, None] * p * prods).sum())
        total += g * float((33 * 2.0 * n2).sum())              # power iteration
        total += g * (fit["cd_polish"] + 1) * float((2.0 * n2 * f * p).sum())
    else:
        total += g * f * float((9.0 * n ** 3 + 4.0 * n2 * p).sum())
    total += float((m * n * ops_pair + 3.0 * pt * m * n
                    + 2.0 * m * n * pt).sum())                 # test phase
    return total

