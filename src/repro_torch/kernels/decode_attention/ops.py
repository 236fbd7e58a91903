"""Wrapper for the fused decode attention kernel (B10): checks, dispatch.

A tensor on the CPU goes to the plain version in ``ref.py``; a CUDA tensor
goes to the hand-written kernel in ``csrc/decode_attention.cu`` or the call
raises.  Unlike the TPU wrapper nothing is transposed or padded: the
kernel reads the (B, S, Hk, D) cache layout and its real S as they are.
``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from repro_torch.kernels import runtime
from repro_torch.kernels.decode_attention import ref

HEAD_DIMS = (16, 64, 128, 256)
GROUPS = (1, 2, 4, 8)           # query heads per kv head the kernel takes
_Q_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_GRID_MAX = 65535

launches: Dict[str, int] = {"decode_attention": 0}


def _lib() -> ctypes.CDLL:
    lib = runtime.library("decode_attention")
    if not getattr(lib, "_bound", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.decode_attention_fwd.argtypes = [p, p, p, p, p, p, i, i, i, i, i,
                                             i, i, i, i, f, p]
        lib.decode_attention_fwd.restype = i
        lib._bound = True
    return lib


def decode_attention_fused(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, cache_pos: int,
                           scale: float,
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None,
                           window: int = 0) -> torch.Tensor:
    """q (B, Hk, G, D); caches (B, S, Hk, D) in q's dtype, or int8 with f32
    scales (B, S, Hk, 1).  Returns (B, Hk, G, D) in q's dtype."""
    runtime.check_tensor("q", q, tuple(_Q_DTYPES), ndim=4)
    b, hk, g, d = q.shape
    s = k_cache.shape[1] if k_cache.dim() == 4 else -1
    quant = k_cache.dtype == torch.int8
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        runtime.check_tensor(name, t, (q.dtype, torch.int8), ndim=4)
        if t.shape != (b, s, hk, d) or t.dtype != k_cache.dtype:
            raise ValueError(f"decode_attention_fused: q {tuple(q.shape)}, "
                             f"{name} {tuple(t.shape)} {t.dtype} disagree")
    if quant != (k_scale is not None) or (k_scale is None) != (v_scale is None):
        raise ValueError("decode_attention_fused: an int8 cache needs both "
                         "scales, and only an int8 cache takes them")
    if quant:
        for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            runtime.check_tensor(name, t, (torch.float32,), ndim=4)
            if t.shape != (b, s, hk, 1):
                raise ValueError(f"decode_attention_fused: {name} "
                                 f"{tuple(t.shape)} is not {(b, s, hk, 1)}")
    pos = int(cache_pos)
    operands = [q, k_cache, v_cache] + ([k_scale, v_scale] if quant else [])
    if q.device.type == "cpu":
        if any(t.device != q.device for t in operands):
            raise ValueError("decode_attention_fused: operands on several "
                             "devices")
        return ref.decode_attention_ref(q, k_cache, v_cache, pos, scale,
                                        k_scale, v_scale, window)

    runtime.check_launch("decode_attention", operands, q.device)
    if (d not in HEAD_DIMS or g not in GROUPS or hk > _GRID_MAX
            or b > _GRID_MAX or s < 1 or pos < 0):
        raise ValueError(f"decode_attention_fused: head_dim {d} not in "
                         f"{HEAD_DIMS}, group {g} not in {GROUPS}, B={b}, "
                         f"Hk={hk}, S={s} or cache_pos={pos} out of range")
    out = torch.empty_like(q)
    if not out.numel():
        return out
    null = ctypes.c_void_p(0)
    rc = _lib().decode_attention_fwd(
        runtime.ptr(q), runtime.ptr(k_cache), runtime.ptr(v_cache),
        runtime.ptr(k_scale) if quant else null,
        runtime.ptr(v_scale) if quant else null, runtime.ptr(out),
        b, s, hk, g, d, _Q_DTYPES[q.dtype], int(quant), pos, int(window),
        float(scale), runtime.stream_handle(q.device))
    runtime.raise_on_error("decode_attention", rc)
    launches["decode_attention"] += 1
    return out
