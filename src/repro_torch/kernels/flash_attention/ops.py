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
``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
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

launches: Dict[str, int] = {"flash_attention": 0}


def _lib() -> ctypes.CDLL:
    lib = runtime.library("flash_attention")
    if not getattr(lib, "_bound", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.flash_attention_fwd.argtypes = [p, p, p, p, i, i, i, i, i, i, i,
                                            i, i, f, p]
        lib.flash_attention_fwd.restype = i
        lib._bound = True
    return lib


def kernel_name(dtype: torch.dtype, d: int) -> str:
    """The kernel a CUDA launch of this dtype and head dim runs."""
    if dtype == torch.bfloat16 and d % 16 == 0:
        return "flash_fwd_tc_kernel"
    return "flash_fwd_kernel"


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
    rc = _lib().flash_attention_fwd(
        runtime.ptr(q), runtime.ptr(k), runtime.ptr(v), runtime.ptr(out),
        b, t, s, h, hk, d, _DTYPES[q.dtype], MASK_KINDS[mask_kind],
        int(window), float(d ** -0.5), runtime.stream_handle(q.device))
    runtime.raise_on_error("flash_attention", rc)
    launches["flash_attention"] += 1
    return out
