"""Error-feedback int8 gradient compression, the single-device half (the
JAX package's ``distributed/compression.py``):

    q = round((g + err) / scale) in int8        scale = max|g + err| / 127
    err' = (g + err) - q * scale                (residual carried forward)

The compressed all-reduce over a mesh axis (``ef_psum``,
``ef_psum_tree``) needs several devices and waits with the rest of the
multi-card work.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.models.layers import tree_map


def quantize_int8(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (int8 values, f32 0-d scale): max|g| / 127, floored at 1e-30;
    values rounded half to even and clipped to +-127."""
    scale = torch.clamp(torch.amax(torch.abs(g)) / 127.0, min=1e-30)
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def ef_compress(g: torch.Tensor, err: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (int8 payload, f32 scale, new error residual)."""
    corrected = g.float() + err
    q, scale = quantize_int8(corrected)
    return q, scale, corrected - dequantize_int8(q, scale)


def init_error_state(params):
    """f32 zeros congruent with ``params`` (a nested dict of tensors)."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
