"""KV-cache utilities: prefill-cache padding, ring-buffer semantics, sizing.

Cache layout (see ``repro_torch.models.model.cache_struct``):
  {"stack": {"pos<i>": {leaves stacked over n_periods}}, "tail<j>": {...}}
  attention leaves "k"/"v": (..., B, S, Hk, D), and for an int8 cache
  "k_scale"/"v_scale": (..., B, S, Hk, 1) f32; the mamba ("conv" (..., B,
  d_conv - 1, d_inner), "ssm") and rwkv leaves are O(1) recurrent states
  that never grow with S, so padding leaves them as they are.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

# kv in the compute dtype -> (int8, per-(token, head) f32 scale)
from repro_torch.models.attention import quantize_kv as _quantize_kv
from repro_torch.models.model import ModelConfig

_SCALE_PAD = 1e-10   # scale of a never-written (padded) slot


def _pad_seq(leaf: torch.Tensor, target_len: int, value: float
             ) -> torch.Tensor:
    seq_axis = leaf.dim() - 3
    cur = leaf.shape[seq_axis]
    if cur >= target_len:
        return leaf
    shape = list(leaf.shape)
    shape[seq_axis] = target_len - cur
    pad = torch.full(shape, value, dtype=leaf.dtype, device=leaf.device)
    return torch.cat([leaf, pad], dim=seq_axis)


def _pad_layer_cache(piece: Dict[str, torch.Tensor], target_len: int,
                     quantize: bool) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    for name, leaf in piece.items():
        if name in ("k", "v"):
            if quantize and leaf.dtype != torch.int8:
                leaf, sc = _quantize_kv(leaf)
                out[name + "_scale"] = sc
            leaf = _pad_seq(leaf, target_len, 0)
        out[name] = leaf
    for name in ("k_scale", "v_scale"):
        if name in out:
            out[name] = _pad_seq(out[name], target_len, _SCALE_PAD)
    return out


def pad_cache(cfg: ModelConfig, cache: Dict[str, Any], target_len: int
              ) -> Dict[str, Any]:
    """Right-pad every attention kv cache to ``target_len`` slots (and
    quantize prefill kv when the config serves an int8 cache).

    Padded slots are masked in decode (never-written ring positions), so
    prefill(T) + pad(S) + decode at pos=T is exact.
    """
    quant = cfg.kv_cache_dtype == "int8"
    out: Dict[str, Any] = {}
    for key, piece in cache.items():
        if key == "stack":
            out["stack"] = {p: _pad_layer_cache(lc, target_len, quant)
                            for p, lc in piece.items()}
        else:
            out[key] = _pad_layer_cache(piece, target_len, quant)
    return out


def cache_bytes(cfg: ModelConfig, batch: int, seq: int) -> int:
    """Total decode-state bytes (capacity planning / roofline memory term)."""
    from repro_torch.models.layers import tree_items
    from repro_torch.models.model import cache_struct
    return sum(int(np.prod(s.shape)) * s.dtype.itemsize
               for _, s in tree_items(cache_struct(cfg, batch, seq)))
