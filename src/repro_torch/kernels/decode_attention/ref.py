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


def decode_attention_partials_ref(q: torch.Tensor, k_cache: torch.Tensor,
                                  v_cache: torch.Tensor, s0: int, nvis: int,
                                  scale: float,
                                  k_scale: Optional[torch.Tensor] = None,
                                  v_scale: Optional[torch.Tensor] = None):
    """The partials of one block of a ring split over the sequence (the
    flash-decoding split): q (B, Hk, G, D) against the keys (s0 + j) mod S
    of this block's caches (B, S, Hk, D) [+ scales], j < nvis.  Returns
    (out (B, Hk, G, D) f32 normalised over those keys, lse (B, Hk, G) f32
    the log-sum-exp of their logits); with no key, zeros and -inf."""
    b, s, hk, d = k_cache.shape
    g = q.shape[2]
    if nvis <= 0:
        return (torch.zeros(q.shape, dtype=torch.float32, device=q.device),
                torch.full((b, hk, g), float("-inf"), device=q.device))

    def run(t):
        if s0 + nvis <= s:
            return t[:, s0:s0 + nvis]
        return torch.cat([t[:, s0:], t[:, :s0 + nvis - s]], dim=1)

    kf, vf = run(k_cache).float(), run(v_cache).float()
    if k_scale is not None:
        kf = kf * run(k_scale)
        vf = vf * run(v_scale)
    logits = torch.einsum("bhgd,bshd->bhgs", q.float(), kf) * scale
    lse = torch.logsumexp(logits, dim=-1)
    p = torch.exp(logits - lse[..., None])
    return torch.einsum("bhgs,bshd->bhgd", p, vf), lse
