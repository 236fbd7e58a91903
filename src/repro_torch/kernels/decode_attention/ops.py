"""Wrapper for the fused decode attention kernel (B10): checks, dispatch.

A tensor on the CPU goes to the plain version in ``ref.py``; a CUDA tensor
goes to the hand-written kernel in ``csrc/decode_attention.cu`` or the call
raises.  Unlike the TPU wrapper nothing is transposed or padded: the
kernel reads the (B, S, Hk, D) cache layout and its real S as they are.
The wrapper turns the cache position and window into the run of visible
ring positions (:func:`visible_range`) and picks how many blocks split it
(:func:`split_count`); a split launch merges its partials in the block
that finishes last, found through a per-(batch, head) ticket in a zeroed
counter buffer kept per device (the kernel leaves it zeroed, so calls on
one device must not overlap on two streams).  A group of query heads the
kernel has no instance of runs as consecutive slices of it, each slice
its own blocks of the one launch (:func:`group_slices`: 16 as two slices
of 8).  ``launches`` counts kernel launches.

The partials mode (:func:`decode_attention_partials`, the flash-decoding
split of a cache over the sequence) runs the same kernel on one block of
the ring and returns its output in f32, normalised over the block's
visible keys, with their log-sum-exp; the caller merges the blocks.  Its
launches count apart, as ``decode_attention_partials``.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import runtime
from repro_torch.kernels.decode_attention import ref

# every head dim of the configurations; other dims raise
HEAD_DIMS = (8, 16, 64, 80, 128, 160, 256)
# query heads per kv head the wrapper takes (every configuration's), and
# the kernel's own instances; 12 and 16 run as slices of 4 and 8
GROUPS = (1, 2, 4, 5, 8, 12, 16)
KERNEL_GROUPS = (1, 2, 4, 5, 8)
MULTI_HEAD_DIMS = (16, 64)      # dims with instances of 2 or 4 heads a block
_Q_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_GRID_MAX = 65535
SPLIT_MAX = 64                  # the kernel's workspace weights hold 64
SPLIT_MIN_KEYS = 256            # keys a split streams at least
BLOCKS_PER_SM = 4               # resident blocks an SM a split aims for
LONG_KEYS = 4096                # visible keys from which a run is "long"

launches: Dict[str, int] = {"decode_attention": 0,
                             "decode_attention_partials": 0}


def _lib() -> ctypes.CDLL:
    lib = runtime.library("decode_attention")
    if not getattr(lib, "_bound", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.decode_attention_fwd.argtypes = [p, p, p, p, p, p, p, p, p, p, i,
                                             i, i, i, i, i, i, i, i, i, i, i,
                                             i, f, p]
        lib.decode_attention_fwd.restype = i
        lib._bound = True
    return lib


def visible_range(s: int, pos: int, window: int = 0) -> Tuple[int, int]:
    """The reference's visible keys as one run of ring positions: key
    (s0 + j) mod S for j < nvis.  Key s is visible when s <= pos or pos >=
    S, and with a window when (pos - s) mod S < window."""
    if pos < s:
        first = 0 if window <= 0 else max(0, pos - window + 1)
        return first, pos - first + 1
    if window <= 0 or window >= s:
        return 0, s
    return (pos - window + 1) % s, window


def block_visible_range(s_total: int, pos: int, window: int, lo: int,
                        n: int) -> Tuple[int, int]:
    """The visible keys of a ring of ``s_total`` (:func:`visible_range`)
    that lie in the block [lo, lo + n) of it, as one run of the block's
    own positions: key (s0 + j) mod n for j < nvis (nvis 0: none).  The
    run of the ring meets the block in at most two pieces, and then they
    touch the block's two ends, so they join into one run modulo n."""
    g0, nv = visible_range(s_total, pos, window)
    pieces = []
    for a, b in ((g0, min(g0 + nv, s_total)), (0, g0 + nv - s_total)):
        a, b = max(a, lo), min(b, lo + n)
        if a < b:
            pieces.append((a - lo, b - lo))
    if not pieces:
        return 0, 0
    if len(pieces) == 1:
        return pieces[0][0], pieces[0][1] - pieces[0][0]
    (a1, b1), (a2, b2) = pieces            # [a1, n) and then [0, b2)
    return a1, (b1 - a1) + (b2 - a2)


def heads_per_block(b: int, hk: int, d: int, cache: torch.dtype,
                    nvis: int, n_sm: int) -> int:
    """Kv heads a block reads side by side (a key's rows of adjacent heads
    are one contiguous run): with bf16 queries and D 16 or 64, an int8
    cache takes 2 (its 64-byte rows fill a 128-byte line), 4 over long
    runs; a bf16 cache takes 2 over long runs when B x Hk / 2 blocks still
    cover the card; else 1 (every other D: the kernel has no instance of
    several heads there).  Hk must be a multiple."""
    if d not in MULTI_HEAD_DIMS:
        return 1
    if cache == torch.int8:
        if nvis >= LONG_KEYS and hk % 4 == 0:
            return 4
        return 2 if hk % 2 == 0 else 1
    if (cache == torch.bfloat16 and nvis >= LONG_KEYS and hk % 2 == 0
            and b * hk // 2 >= n_sm):
        return 2
    return 1


def split_count(pairs: int, nvis: int, n_sm: int) -> int:
    """Blocks that share the visible keys of one (batch, head block) pair:
    1 while the pairs alone give every SM a block; else as many as put
    at most BLOCKS_PER_SM blocks on each SM, each with at least
    SPLIT_MIN_KEYS keys, at most SPLIT_MAX."""
    if pairs >= n_sm:
        return 1
    want = BLOCKS_PER_SM * n_sm // pairs
    return max(1, min(want, nvis // SPLIT_MIN_KEYS, SPLIT_MAX))


def group_slices(g: int) -> Tuple[int, int]:
    """(query heads a slice, slices) for a group of ``g``: the kernel's
    own instance of ``g``, else slices of the largest instance that
    divides it."""
    if g in KERNEL_GROUPS:
        return g, 1
    gl = max(x for x in KERNEL_GROUPS if g % x == 0)
    return gl, g // gl


def _check(q, k_cache, v_cache, k_scale, v_scale, caller: str) -> bool:
    """Operand checks of both modes; returns whether the cache is int8."""
    runtime.check_tensor("q", q, tuple(_Q_DTYPES), ndim=4)
    b, hk, g, d = q.shape
    s = k_cache.shape[1] if k_cache.dim() == 4 else -1
    quant = k_cache.dtype == torch.int8
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        runtime.check_tensor(name, t, (q.dtype, torch.int8), ndim=4)
        if t.shape != (b, s, hk, d) or t.dtype != k_cache.dtype:
            raise ValueError(f"{caller}: q {tuple(q.shape)}, "
                             f"{name} {tuple(t.shape)} {t.dtype} disagree")
    if quant != (k_scale is not None) or (k_scale is None) != (v_scale is None):
        raise ValueError(f"{caller}: an int8 cache needs both "
                         "scales, and only an int8 cache takes them")
    if quant:
        for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            runtime.check_tensor(name, t, (torch.float32,), ndim=4)
            if t.shape != (b, s, hk, 1):
                raise ValueError(f"{caller}: {name} "
                                 f"{tuple(t.shape)} is not {(b, s, hk, 1)}")
    operands = [q, k_cache, v_cache] + ([k_scale, v_scale] if quant else [])
    if q.device.type == "cpu":
        if any(t.device != q.device for t in operands):
            raise ValueError(f"{caller}: operands on several devices")
        return quant
    runtime.check_launch("decode_attention", operands, q.device)
    if (d not in HEAD_DIMS or g not in GROUPS or b > _GRID_MAX or s < 1):
        raise ValueError(f"{caller}: head_dim {d} not in "
                         f"{HEAD_DIMS}, group {g} not in {GROUPS}, B={b}, "
                         f"Hk={hk} or S={s} out of range")
    if any(t.data_ptr() % 16 for t in (q, k_cache, v_cache)):
        raise ValueError(f"{caller}: the kernel copies 16-byte "
                         "chunks; q and the caches must start on a 16-byte "
                         "boundary")
    return quant


def _launch(q, k_cache, v_cache, k_scale, v_scale, quant: bool, s0: int,
            nvis: int, scale: float, out, out_f32=None, lse=None) -> None:
    """One launch over the visible run (s0, nvis) of the caches: the
    normalised output into ``out`` (q's dtype), or with ``lse`` into
    ``out_f32`` with the log-sum-exp beside it (the partials mode)."""
    b, hk, g, d = q.shape
    s = k_cache.shape[1]
    n_sm = runtime.sm_count(q.device)
    heads = (1 if q.dtype != torch.bfloat16
             else heads_per_block(b, hk, d, k_cache.dtype, nvis, n_sm))
    gl, ng = group_slices(g)
    n_split = split_count(b * hk * ng // heads, nvis, n_sm)
    chunk = -(-nvis // n_split)
    n_split = -(-nvis // chunk)
    null = ctypes.c_void_p(0)
    ws = cnt = None
    if n_split > 1:               # partials: (B slices Hk, split, G, D + 2)
        ws = torch.empty(b * ng * hk * n_split * gl * (d + 2),
                         dtype=torch.float32, device=q.device)
        cnt = runtime.ticket_counters("decode_attention", q.device,
                                      b * ng * hk // heads)

    def ptr(t):
        return null if t is None else runtime.ptr(t)

    rc = _lib().decode_attention_fwd(
        runtime.ptr(q), runtime.ptr(k_cache), runtime.ptr(v_cache),
        ptr(k_scale if quant else None), ptr(v_scale if quant else None),
        ptr(out), ptr(out_f32), ptr(lse), ptr(ws), ptr(cnt),
        b, s, hk, gl, ng, d, _Q_DTYPES[q.dtype], int(quant), heads, s0,
        nvis, n_split, chunk, float(scale), runtime.stream_handle(q.device))
    runtime.raise_on_error("decode_attention", rc)


def decode_attention_fused(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, cache_pos: int,
                           scale: float,
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None,
                           window: int = 0) -> torch.Tensor:
    """q (B, Hk, G, D); caches (B, S, Hk, D) in q's dtype, or int8 with f32
    scales (B, S, Hk, 1).  Returns (B, Hk, G, D) in q's dtype."""
    quant = _check(q, k_cache, v_cache, k_scale, v_scale,
                   "decode_attention_fused")
    pos = int(cache_pos)
    if q.device.type == "cpu":
        return ref.decode_attention_ref(q, k_cache, v_cache, pos, scale,
                                        k_scale, v_scale, window)
    if pos < 0:
        raise ValueError(f"decode_attention_fused: cache_pos={pos} < 0")
    out = torch.empty_like(q)
    if not out.numel():
        return out
    s0, nvis = visible_range(k_cache.shape[1], pos, int(window))
    _launch(q, k_cache, v_cache, k_scale, v_scale, quant, s0, nvis, scale,
            out)
    launches["decode_attention"] += 1
    return out


def decode_attention_partials(q: torch.Tensor, k_cache: torch.Tensor,
                              v_cache: torch.Tensor, cache_pos: int,
                              scale: float,
                              k_scale: Optional[torch.Tensor] = None,
                              v_scale: Optional[torch.Tensor] = None,
                              window: int = 0, *, block: Tuple[int, int]
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The partials mode: the caches (B, S_loc, Hk, D) [+ scales] are the
    ring positions [lo, lo + S_loc) of a ring of ``s_total`` (``block`` =
    (lo, s_total)), and q (B, Hk, G, D) attends to the visible keys among
    them (:func:`block_visible_range`).  Returns (out (B, Hk, G, D) f32
    normalised over those keys, lse (B, Hk, G) f32 their log-sum-exp); a
    block with no visible key gives zeros and -inf, with no launch."""
    quant = _check(q, k_cache, v_cache, k_scale, v_scale,
                   "decode_attention_partials")
    lo, s_total = (int(v) for v in block)
    n = k_cache.shape[1]
    if not (0 <= lo and lo + n <= s_total) or int(cache_pos) < 0:
        raise ValueError(f"decode_attention_partials: block [{lo}, "
                         f"{lo + n}) of a ring of {s_total}, cache_pos "
                         f"{cache_pos}")
    s0, nvis = block_visible_range(s_total, int(cache_pos), int(window),
                                   lo, n)
    if q.device.type == "cpu":
        return ref.decode_attention_partials_ref(q, k_cache, v_cache, s0,
                                                 nvis, scale, k_scale,
                                                 v_scale)
    if nvis == 0 or not q.numel():
        return (torch.zeros(q.shape, dtype=torch.float32, device=q.device),
                torch.full(q.shape[:3], float("-inf"), device=q.device))
    # the launch writes every element of both (each row's output and
    # log-sum-exp, by its block or by the split's merge): no fill
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    _launch(q, k_cache, v_cache, k_scale, v_scale, quant, s0, nvis, scale,
            None, out, lse)
    launches["decode_attention_partials"] += 1
    return out, lse
