"""Wrapper for the nearest-center kernel (B6): checks, dispatch by device.

A tensor on the CPU goes to the plain version in ``ref.py``; a CUDA tensor
goes to the hand-written kernel in ``csrc/assign.cu`` or the call raises.
Nothing is padded: the kernel masks the ragged row and center edges
itself, so no sentinel center rows are needed.  ``launches`` counts kernel
launches (never plain-version calls).
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch.kernels import runtime
from repro_torch.kernels.assign import ref

launches: Dict[str, int] = {"assign": 0}


def _lib() -> ctypes.CDLL:
    lib = runtime.library("assign")
    if not getattr(lib, "_bound", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.assign_f32.argtypes = [p, p, p, i, i, i, p]
        lib.assign_f32.restype = i
        lib._bound = True
    return lib


def assign(x: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """Nearest-center id per row: (m, d) x (C, d) -> (m,) int32.

    d² in GEMM form with the cross term in fp32, not clamped; the lowest
    index wins a tie, as numpy's and torch's ``argmin`` do.
    """
    runtime.check_tensor("x", x, (torch.float32,), ndim=2)
    runtime.check_tensor("centers", centers, (torch.float32,), ndim=2)
    if x.shape[1] != centers.shape[1]:
        raise ValueError(f"assign: x {tuple(x.shape)} and centers "
                         f"{tuple(centers.shape)} disagree on d")
    if x.device != centers.device:
        raise ValueError(f"assign: x on {x.device}, centers on "
                         f"{centers.device}")
    if centers.shape[0] == 0:
        raise ValueError("assign: no centers")
    if x.device.type == "cpu":
        return ref.assign_ref(x, centers)
    runtime.check_launch("assign", (x, centers), x.device)
    m, d = x.shape
    out = torch.empty(m, dtype=torch.int32, device=x.device)
    if m == 0:
        return out
    if m >= 2 ** 31 or centers.shape[0] >= 2 ** 31:
        raise ValueError(f"assign: {m} rows or {centers.shape[0]} centers "
                         f"exceed the kernel's 32-bit counts")
    rc = _lib().assign_f32(runtime.ptr(x), runtime.ptr(centers),
                           runtime.ptr(out), m, centers.shape[0], d,
                           runtime.stream_handle(x.device))
    runtime.raise_on_error("assign", rc)
    launches["assign"] += 1
    return out
