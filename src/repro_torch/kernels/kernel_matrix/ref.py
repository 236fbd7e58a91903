"""Plain PyTorch versions of the kernel-matrix kernels.

The CPU tests run these, and ``chip_smoke.py`` holds the CUDA kernels
against them on the card.  The D² and epilogue functions broadcast over
leading axes.
"""
from __future__ import annotations

from typing import Union

import torch


def sq_dists_ref(x: torch.Tensor, z: torch.Tensor,
                 symmetric: bool = False) -> torch.Tensor:
    """(..., n, d) x (..., m, d) -> (..., n, m) f32 squared distances in
    GEMM form, max(|x|^2 + |z|^2 - 2 x.z, 0).

    ``symmetric=True`` (z is x) returns 0.5 (D + D^T), which equals its
    transpose bitwise, as the reference's symmetric contract does."""
    x = x.to(torch.float32)
    z = z.to(torch.float32)
    xx = (x * x).sum(-1)[..., :, None]
    zz = (z * z).sum(-1)[..., None, :]
    d2 = torch.clamp(xx + zz - 2.0 * (x @ z.transpose(-1, -2)), min=0.0)
    if symmetric:
        d2 = 0.5 * (d2 + d2.transpose(-1, -2))
    return d2


def gram_from_d2_ref(d2: torch.Tensor, gamma: Union[float, torch.Tensor],
                     kind: str = "gauss_rbf",
                     out_dtype: str = "f32") -> torch.Tensor:
    """Per-gamma epilogue; ``gamma`` broadcasts against ``d2``."""
    g = torch.as_tensor(gamma, dtype=torch.float32, device=d2.device)
    d2 = d2.to(torch.float32)
    if kind == "gauss_rbf":
        k = torch.exp(-d2 / torch.clamp(g * g, min=1e-12))
    elif kind == "laplacian":
        k = torch.exp(-torch.sqrt(d2 + 1e-12) / torch.clamp(g, min=1e-12))
    else:
        raise ValueError(kind)
    return k.to(torch.bfloat16) if out_dtype == "bf16" else k


def kernel_matrix_ref(x: torch.Tensor, z: torch.Tensor,
                      gamma: Union[float, torch.Tensor],
                      kind: str = "gauss_rbf") -> torch.Tensor:
    """One-shot Gram K = k_gamma(x, z), (n, d) x (m, d) -> (n, m) f32."""
    return gram_from_d2_ref(sq_dists_ref(x, z), gamma, kind)
