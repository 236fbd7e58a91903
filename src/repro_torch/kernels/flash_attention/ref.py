"""Plain PyTorch version of flash attention: masked softmax with GQA.

q (B, T, H, D); k, v (B, S, Hk, D) with H % Hk == 0.
mask kinds: "causal" (row >= col, offset so the last q row attends to the
last kv row), "window" (causal AND row - col < window), "bidir".
Computed in f32 with the (T, S) logits materialised; output in q's dtype.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

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


SEEN = -1e20    # a row max above this came from a visible logit
BLOCK_Q = 64    # query rows a block of the CUDA-core kernel


def tile_runs(t: int, s: int, block_k: int, mask_kind: str, window: int,
              nsplit: int) -> List[List[Tuple[int, int]]]:
    """For each block of BLOCK_Q query rows, the runs [first, end) of kv
    tiles (``block_k`` rows each) its splits take, as the CUDA-core kernel
    cuts them: the block's visible tiles in runs of ceil(n / nsplit), one
    run a split in split order (fewer runs than ``nsplit`` where the block
    sees fewer tiles); a block that sees nothing has one empty run."""
    off = s - t
    out = []
    for q0 in range(0, t, BLOCK_Q):
        lo, hi = 0, s - 1
        if mask_kind != "bidir":
            hi = min(hi, min(q0 + BLOCK_Q, t) - 1 + off)
            if mask_kind == "window":
                lo = max(0, q0 + off - window + 1)
        n = hi // block_k - lo // block_k + 1 if hi >= lo else 0
        chunk = max(1, -(-n // nsplit))
        first = lo // block_k if n else 0
        out.append([(first + j, first + min(n, j + chunk))
                    for j in range(0, max(n, 1), chunk)])
    return out


def flash_attention_split_ref(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, mask_kind: str = "causal",
                              window: int = 0, nsplit: int = 1,
                              block_k: int = 64) -> torch.Tensor:
    """The CUDA-core kernel's split over the keys in plain PyTorch: each
    split's run of kv tiles (:func:`tile_runs`) gives its rows' max m,
    sum l and unnormalised output over its keys, and the runs merge in
    split order: M = max m_j, w_j = exp(m_j - M), out = sum w_j acc_j /
    max(sum w_j l_j, 1e-30).  A row with no visible column gives 0 (where
    :func:`flash_attention_ref` averages the value rows)."""
    b, t, h, d = q.shape
    s, hk = k.shape[1], k.shape[2]
    g = h // hk
    qf = q.float().reshape(b, t, hk, g, d)
    kf, vf = k.float(), v.float()
    mask = attention_mask(t, s, mask_kind, window, q.device)
    out = torch.zeros(b, t, hk, g, d, dtype=torch.float32, device=q.device)
    runs = tile_runs(t, s, block_k, mask_kind, window, nsplit)
    for qi, block in enumerate(runs):
        r0, r1 = qi * BLOCK_Q, min((qi + 1) * BLOCK_Q, t)
        parts = []
        for first, end in block:
            c0, c1 = first * block_k, min(end * block_k, s)
            logits = torch.einsum("bthgd,bshd->bhgts", qf[:, r0:r1],
                                  kf[:, c0:c1]) * (d ** -0.5)
            vis = mask[r0:r1, c0:c1]
            logits = torch.where(vis, logits,
                                 torch.tensor(NEG_INF, device=q.device))
            m = (logits.amax(-1) if c1 > c0 else torch.full(
                logits.shape[:-1], NEG_INF, device=q.device))
            p = torch.where((m > SEEN)[..., None],
                            torch.exp(logits - m[..., None]),
                            torch.zeros((), device=q.device))
            parts.append((m, p.sum(-1), torch.einsum(
                "bhgts,bshd->bhgtd", p, vf[:, c0:c1])))
        mx = torch.stack([m for m, _, _ in parts]).amax(0)
        lsum = torch.zeros_like(mx)
        acc = torch.zeros_like(parts[0][2])
        for m, l, a in parts:
            w = torch.where(mx > SEEN, torch.exp(m - mx),
                            torch.zeros((), device=q.device))
            lsum = lsum + l * w
            acc = acc + a * w[..., None]
        out[:, r0:r1] = (acc / lsum.clamp_min(1e-30)[..., None]
                         ).permute(0, 3, 1, 2, 4)
    return out.reshape(b, t, h, d).to(q.dtype)
