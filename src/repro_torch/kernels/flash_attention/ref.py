"""Plain PyTorch version of flash attention: masked softmax with GQA.

q (B, T, H, D); k, v (B, S, Hk, D) with H % Hk == 0.
mask kinds: "causal" (row >= col, offset so the last q row attends to the
last kv row), "window" (causal AND row - col < window), "bidir".
Computed in f32 with the (T, S) logits materialised; output in q's dtype.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def attention_mask(t: int, s: int, kind: str, window: int = 0,
                   device=None) -> torch.Tensor:
    rows = torch.arange(t, device=device)[:, None] + (s - t)
    cols = torch.arange(s, device=device)[None, :]
    if kind == "bidir":
        return torch.ones((t, s), dtype=torch.bool, device=device)
    causal = rows >= cols
    if kind == "causal":
        return causal
    if kind == "window":
        return causal & (rows - cols < window)
    raise ValueError(kind)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        mask_kind: str = "causal", window: int = 0,
                        scale: Optional[float] = None) -> torch.Tensor:
    b, t, h, d = q.shape
    s, hk = k.shape[1], k.shape[2]
    g = h // hk
    scale = (d ** -0.5) if scale is None else scale
    qf = q.float().reshape(b, t, hk, g, d)
    logits = torch.einsum("bthgd,bshd->bhgts", qf, k.float()) * scale
    m = attention_mask(t, s, mask_kind, window, q.device)
    logits = torch.where(m, logits, torch.tensor(NEG_INF, device=q.device))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgts,bshd->bthgd", p, v.float())
    return out.reshape(b, t, h, d).to(q.dtype)
