"""Plain PyTorch versions of the Gauss-Seidel CD epochs.

The exact sweep over coordinates 0..n-1, for each coordinate i and every
column p at once (columns are independent problems):

    target = clip(c_i - g_i / max(K_ii, 1e-12), lo_i, hi_i)
    delta  = target - c_i;   c_i = target
    g     += K[:, i] (x) delta            (rank-1 gradient maintenance)

``cd_wave_epoch_ref`` batches the sweep over S slots and F problems per
slot (the CV folds, sharing their slot's Gram).  It stores the clipped
target, as the reference's Pallas body does (its jnp oracle adds delta
instead, which can differ from the target in the last bit), and rounds
after every operation, so the CUDA kernel reproduces it bit for bit on the
card.  ``cd_epoch_blocked_ref`` is the reference's delayed-update variant
(same coordinate order and fixed point, another summation order).
"""
from __future__ import annotations

from typing import Tuple

import torch

WAVE_BLOCK = 32  # delayed-update block width of the blocked sweep


def cd_wave_epoch_ref(k: torch.Tensor, c: torch.Tensor, g: torch.Tensor,
                      lo: torch.Tensor, hi: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One exact epoch.  k (S, n, n); c, g, lo, hi (S, F, n, P).

    Returns new (c, g); the inputs are not modified."""
    c = c.clone()
    g = g.clone()
    diag = torch.clamp(torch.diagonal(k, dim1=-2, dim2=-1), min=1e-12)
    for i in range(k.shape[-1]):
        ci = c[:, :, i]                                   # (S, F, P)
        step = ci - g[:, :, i] / diag[:, i, None, None]
        target = torch.clamp(step, min=lo[:, :, i], max=hi[:, :, i])
        delta = target - ci
        c[:, :, i] = target
        g.add_(k[:, None, :, i, None] * delta[:, :, None, :])
    return c, g


def cd_epoch_ref(k: torch.Tensor, c: torch.Tensor, g: torch.Tensor,
                 lo: torch.Tensor, hi: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One cell: k (n, n); c, g, lo, hi (n, P)."""
    c, g = cd_wave_epoch_ref(k[None], c[None, None], g[None, None],
                             lo[None, None], hi[None, None])
    return c[0, 0], g[0, 0]


def solve_cd_ref(k: torch.Tensor, y: torch.Tensor, lo: torch.Tensor,
                 hi: torch.Tensor, c0: torch.Tensor, epochs: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``epochs`` exact sweeps on min 0.5 c'Kc - c'y over the box, one
    cell: k (n, n); y, lo, hi, c0 (n, P)."""
    c, g = c0, k @ c0 - y
    for _ in range(epochs):
        c, g = cd_epoch_ref(k, c, g, lo, hi)
    return c, g


def cd_epoch_blocked_ref(k: torch.Tensor, c: torch.Tensor, g: torch.Tensor,
                         lo: torch.Tensor, hi: torch.Tensor,
                         block: int = WAVE_BLOCK
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One epoch with delayed trailing updates, one cell (n % block == 0).

    Within a block only the block-local gradient is kept current; the
    update of all n rows lands afterwards as one (n, B) x (B, P) product."""
    n, p = c.shape
    c = c.clone()
    g = g.clone()
    diag = torch.diagonal(k)
    for base in range(0, n, block):
        kb = k[:, base:base + block]                       # (n, B)
        kbb = kb[base:base + block]                        # (B, B)
        g0 = g[base:base + block]
        delta = torch.zeros((block, p), dtype=c.dtype)
        for t in range(block):
            i = base + t
            gt = g0[t] + (kbb[t:t + 1] @ delta)[0]
            d = torch.clamp(diag[i], min=1e-12)
            ct = c[i]
            target = torch.clamp(ct - gt / d, min=lo[i], max=hi[i])
            delta[t] = target - ct
            c[i] = target
        g = g + kb @ delta
    return c, g
