"""Wrapper for the nearest-center kernel (B6): checks, dispatch by device.

A tensor on the CPU goes to the plain version in ``ref.py``; a CUDA tensor
goes to the hand-written kernel in ``csrc/assign.cu`` or the call raises.
Nothing is padded: the kernel masks the ragged row and center edges
itself, so no sentinel center rows are needed.  :func:`assign_plan` picks
the kernel's path: the center table resident in shared memory when it fits
(:func:`assign_resident`), else streamed through a ring.  ``launches``
counts kernel launches (never plain-version calls).
"""
from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple

import torch

from repro_torch.kernels import runtime
from repro_torch.kernels.assign import ref

launches: Dict[str, int] = {"assign": 0}

SMEM_MAX = 232448     # bytes of shared memory a block may use on sm_90
ROW_TILE = 256        # resident path: rows a tile (A operand)
STREAM_ROWS = 64      # streamed path: rows a block (B operand)
STREAM_CENTERS = 256  # streamed path: centers a ring stage (A operand)
STREAM_K = 32         # streamed path: features a ring stage
STREAM_STAGES = 3
ROW_STAGES = 2        # resident path: row tiles in flight


class AssignPlan(NamedTuple):
    resident: bool
    grid: int        # blocks
    dp: int          # d rounded up to 2: the feature loop's length
    cp: int          # resident: C rounded up to 4, the table's row stride
    lda: int         # row stride of the row-major operand, 2 mod 4 words
    smem: int        # dynamic shared memory bytes


def _lda(width: int) -> int:
    """Row stride (words) of an operand read 8 bytes a row by 4 rows 4
    apart in one warp: 2 mod 4, so the 4 rows land in 4 bank pairs."""
    return width if width % 4 == 2 else width + 2


def _resident_smem(c: int, d: int) -> int:
    dp = d + d % 2
    cp = -(-c // 4) * 4
    return 4 * (dp * cp + cp + ROW_STAGES * ROW_TILE * _lda(dp))


def assign_resident(c: int, d: int) -> bool:
    """Whether a table of ``c`` centers of width ``d`` stays resident in
    shared memory (feature-major, with its norms, beside two row tiles):
    Covertype's 291 x 54 does, a HIGGS-width 5500 x 28 does not."""
    return _resident_smem(c, d) <= SMEM_MAX


def assign_plan(n: int, c: int, d: int, n_sm: int) -> AssignPlan:
    """The kernel's launch for ``n`` rows, ``c`` centers of width ``d`` on
    a card with ``n_sm`` SMs: resident, one block an SM walking row tiles
    (at most one block a tile); streamed, one block per 64 rows."""
    dp = d + d % 2
    if assign_resident(c, d):
        cp = -(-c // 4) * 4
        return AssignPlan(True, min(-(-n // ROW_TILE), n_sm), dp, cp,
                          _lda(dp), _resident_smem(c, d))
    lda = _lda(min(STREAM_K, dp))
    smem = 4 * STREAM_STAGES * (STREAM_CENTERS * lda + STREAM_K * STREAM_ROWS)
    return AssignPlan(False, -(-n // STREAM_ROWS), dp, 0, lda, smem)


def _lib() -> ctypes.CDLL:
    lib = runtime.library("assign")
    if not getattr(lib, "_bound", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.assign_f32.argtypes = [p, p, p, i, i, i, i, i, i, i, i, i, i, p]
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
    c = centers.shape[0]
    plan = assign_plan(m, c, d, runtime.sm_count(x.device))
    # 8-byte copies of the row-major operand where its rows allow them
    src = x if plan.resident else centers
    vw = 2 if d % 2 == 0 and src.data_ptr() % 8 == 0 else 1
    rc = _lib().assign_f32(runtime.ptr(x), runtime.ptr(centers),
                           runtime.ptr(out), m, c, d, int(plan.resident),
                           plan.grid, plan.dp, plan.cp, plan.lda, vw,
                           plan.smem, runtime.stream_handle(x.device))
    runtime.raise_on_error("assign", rc)
    launches["assign"] += 1
    return out
