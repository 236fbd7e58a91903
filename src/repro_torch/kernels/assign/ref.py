"""Plain PyTorch version of the nearest-center kernel (B6).

The CPU tests run it, and ``chip_smoke.py`` holds the CUDA kernel against
it on the card.  It follows the Pallas body (``_assign_kernel`` of the
JAX package's ``pipeline/assign.py``) and ``_assign_block_jax``: the
GEMM-form d² is NOT clamped at 0, unlike the host path's ``_d2_chunk``.
Ties go to the lowest center index (``argmin`` returns the first).
"""
from __future__ import annotations

import torch


def assign_ref(x: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """(m, d) x (C, d) -> (m,) int32 argmin_c |x|^2 + |c|^2 - 2 x.c, f32."""
    x = x.to(torch.float32)
    c = centers.to(torch.float32)
    xx = (x * x).sum(1)
    cc = (c * c).sum(1)
    d2 = xx[:, None] + cc[None, :] - 2.0 * (x @ c.T)
    return d2.argmin(1).to(torch.int32)
