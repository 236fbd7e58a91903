"""Wrapper for the flash attention kernel (B9): checks, dispatch by device.

A tensor on the CPU goes to the plain version in ``ref.py``; a CUDA tensor
goes to the hand-written kernel in ``csrc/flash_attention.cu`` or the call
raises: bf16 at a head dim that is a multiple of 16 to the tensor-core
kernel (wgmma, TMA-fed tiles), f32 and bf16 at D 8 (below the bf16 wgmma K
step) to the CUDA-core kernel (:func:`kernel_name`).  Unlike the TPU
wrapper nothing is transposed, repeated or padded: the kernel reads the
public (B, T, H, D) / (B, S, Hk, D) layout as it is, maps query head h to
kv head h // (H / Hk) itself and masks the ragged T and S edges.  Operands must start on a 16-byte boundary (TMA and
16-byte loads); a view that does not is refused, never copied.
The CUDA-core kernel splits the keys of each block of 64 query rows over
:func:`split_count` blocks when a row's own blocks would leave SMs idle;
the block that finishes last merges the splits in split order within the
same launch.  ``launches`` counts kernel launches: one a call, split or
not.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict

import torch

from repro_torch.kernels import runtime
from repro_torch.kernels.flash_attention import ref

MASK_KINDS = {"causal": 0, "window": 1, "bidir": 2}
# every head dim of the configurations; other dims raise
HEAD_DIMS = (8, 16, 64, 80, 128, 160, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_GRID_MAX = 65535
_ALIGN = 16          # bytes: TMA and 16-byte loads

# the CUDA-core kernel (csrc/flash_attention.cu, CcCfg): kv rows a tile
# and the blocks an SM holds, by head dim
CC_BLOCK_K = {8: 64, 16: 64, 64: 64, 80: 48, 128: 32, 160: 32, 256: 32}
CC_BLOCKS_PER_SM = {8: 2, 16: 2, 64: 2, 80: 2, 128: 2, 160: 1, 256: 1}
SPLIT_MAX = 32       # the kernel's cap on splits over the keys

launches: Dict[str, int] = {"flash_attention": 0}


def _lib() -> ctypes.CDLL:
    lib = runtime.library("flash_attention")
    if not getattr(lib, "_bound", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.flash_attention_fwd.argtypes = [p, p, p, p, p, p, i, i, i, i, i,
                                            i, i, i, i, f, i, p]
        lib.flash_attention_fwd.restype = i
        lib.flash_attention_cc_blocks_per_sm.argtypes = [i, i]
        lib.flash_attention_cc_blocks_per_sm.restype = i
        lib._bound = True
    return lib


def kernel_name(dtype: torch.dtype, d: int) -> str:
    """The kernel a CUDA launch of this dtype and head dim runs."""
    if dtype == torch.bfloat16 and d % 16 == 0:
        return "flash_fwd_tc_kernel"
    return "flash_fwd_kernel"


@functools.lru_cache(maxsize=4096)
def split_count(t: int, s: int, h: int, d: int, mask_kind: str, window: int,
                n_sm: int) -> int:
    """Splits over the keys for each block of the CUDA-core kernel, from
    the row's own quantities and the SM count, never the batch (so a row
    is the same bits whatever shares its launch): 1 while the row's
    ceil(T / 64) x H blocks cover half the SMs or more; else as many as
    fill the card's CC_BLOCKS_PER_SM[d] x n_sm slots, at most a block's
    visible kv tiles and SPLIT_MAX."""
    n_blocks = -(-t // ref.BLOCK_Q) * h
    if 2 * n_blocks >= n_sm:
        return 1
    runs = ref.tile_runs(t, s, CC_BLOCK_K[d], mask_kind, window, 1)
    most = max(end - first for [(first, end)] in runs)
    want = -(-n_sm * CC_BLOCKS_PER_SM[d] // n_blocks)
    return max(1, min(want, most, SPLIT_MAX))


def cc_blocks_per_sm(d: int, dtype: torch.dtype = torch.float32) -> int:
    """Blocks of the CUDA-core kernel an SM holds at head dim ``d``, by the
    card's occupancy calculator (needs a card; CC_BLOCKS_PER_SM is the
    planner's copy)."""
    return int(_lib().flash_attention_cc_blocks_per_sm(int(d),
                                                       _DTYPES[dtype]))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask_kind: str = "causal", window: int = 0
                    ) -> torch.Tensor:
    """q (B, T, H, D); k, v (B, S, Hk, D); returns (B, T, H, D) in q's
    dtype.  Scale D**-0.5, f32 softmax and accumulation."""
    if mask_kind not in MASK_KINDS:
        raise ValueError(f"unknown mask kind {mask_kind!r}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        runtime.check_tensor(name, t, tuple(_DTYPES), ndim=4)
    b, t, h, d = q.shape
    s, hk = k.shape[1], k.shape[2]
    if (k.shape != (b, s, hk, d) or v.shape != k.shape or hk == 0
            or h % hk or k.dtype != q.dtype or v.dtype != q.dtype):
        raise ValueError(f"flash_attention: q {tuple(q.shape)} {q.dtype}, "
                         f"k {tuple(k.shape)} {k.dtype}, v {tuple(v.shape)} "
                         f"{v.dtype} disagree")
    if q.device.type == "cpu":
        if k.device != q.device or v.device != q.device:
            raise ValueError("flash_attention: operands on several devices")
        return ref.flash_attention_ref(q, k, v, mask_kind, window)

    runtime.check_launch("flash_attention", (q, k, v), q.device)
    if (d not in HEAD_DIMS or h > _GRID_MAX or b > _GRID_MAX
            or -(-t // 64) > _GRID_MAX):
        raise ValueError(f"flash_attention: head_dim {d} not in {HEAD_DIMS} "
                         f"or B={b}, H={h}, T={t} beyond the grid")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.data_ptr() % _ALIGN:
            raise ValueError(f"flash_attention: {name} starts at "
                             f"{x.data_ptr():#x}, not on a {_ALIGN}-byte "
                             f"boundary")
    out = torch.empty_like(q)
    if not out.numel():
        return out
    nsplit, ws, cnt = 1, None, None
    if kernel_name(q.dtype, d) == "flash_fwd_kernel":
        nsplit = split_count(t, s, h, d, mask_kind, int(window),
                             runtime.sm_count(q.device))
    if nsplit > 1:            # partials: (B, T / 64, H, split, 64 (D + 2))
        blocks = b * -(-t // ref.BLOCK_Q) * h
        ws = torch.empty(blocks * nsplit * ref.BLOCK_Q * (d + 2),
                         dtype=torch.float32, device=q.device)
        cnt = runtime.ticket_counters("flash_attention", q.device, blocks)

    def ptr(x):
        return ctypes.c_void_p(0) if x is None else runtime.ptr(x)

    rc = _lib().flash_attention_fwd(
        runtime.ptr(q), runtime.ptr(k), runtime.ptr(v), runtime.ptr(out),
        ptr(ws), ptr(cnt), b, t, s, h, hk, d, _DTYPES[q.dtype],
        MASK_KINDS[mask_kind], int(window), float(d ** -0.5), nsplit,
        runtime.stream_handle(q.device))
    runtime.raise_on_error("flash_attention", rc)
    launches["flash_attention"] += 1
    return out
