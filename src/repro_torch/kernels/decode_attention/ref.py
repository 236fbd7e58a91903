"""Plain PyTorch version of fused decode attention (optionally int8 KV)."""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, cache_pos: int, scale: float,
                         k_scale: Optional[torch.Tensor] = None,
                         v_scale: Optional[torch.Tensor] = None,
                         window: int = 0) -> torch.Tensor:
    """q (B, Hk, G, D); caches (B, S, Hk, D) [+ (B, S, Hk, 1) scales].
    Returns (B, Hk, G, D) in q's dtype.  Ring-buffer validity from
    cache_pos: key s is visible when s <= cache_pos or cache_pos >= S, and
    with a window when (cache_pos - s) mod S < window."""
    s = k_cache.shape[1]
    kf = k_cache.float()
    vf = v_cache.float()
    if k_scale is not None:
        kf = kf * k_scale
        vf = vf * v_scale
    logits = torch.einsum("bhgd,bshd->bhgs", q.float(), kf) * scale
    idx = torch.arange(s, device=q.device)
    pos = int(cache_pos)
    valid = (idx <= pos) | (pos >= s)
    if window > 0:
        valid &= torch.remainder(pos - idx, s) < window
    logits = torch.where(valid, logits, torch.tensor(NEG_INF, device=q.device))
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhgs,bshd->bhgd", p, vf).to(q.dtype)
