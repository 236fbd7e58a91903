"""Wrappers for the fused predict kernel: checks, dispatch by device.

Two entry points:

  * ``svm_predict_cells`` — the serving engine's multi-cell launch (B3):
                            per-cell SV tables, one gamma per column;
  * ``svm_predict``       — f = K(x_test, sv) @ coefs for one cell and one
                            gamma (B8): B3's kernel launched at C = 1 with
                            every column given the same gamma, counted as
                            its own entry.

A tensor on the CPU goes to the plain version in ``ref.py``; a CUDA tensor
goes to the hand-written kernel in ``csrc/svm_predict.cu`` or the call
raises.  Unlike the TPU wrapper, nothing is padded: the kernel masks the
ragged query-row and SV edges itself, so a serving wave's ``m_pad`` (a
multiple of 8) is launched as it is, and a bank of more than 64 columns is
one launch over blocks of 64 columns.  :func:`predict_plan` sizes the
kernel's shared-memory ring and picks :func:`predict_splits`, the blocks
that share one slot's SV table when slots are too few to fill the card;
a split launch merges its partials in the block that finishes last,
found through a per-(slot, row tile, column block) ticket in a zeroed
counter buffer kept per device (the kernel leaves it zeroed, so calls on
one device must not overlap on two streams).  ``launches`` counts kernel
launches.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, NamedTuple

import torch

from repro_torch.kernels import runtime
from repro_torch.kernels.runtime import copy_width, smem_stride
from repro_torch.kernels.kernel_matrix.ops import KINDS
from repro_torch.kernels.svm_predict import ref

_GRID_MAX = 65535
_P_BLOCK = 64                # columns per block (ROWS * P <= 64 registers)
SMEM_MAX = 232448            # bytes a block may use on sm_90
_SMEM_STATIC = 1536          # the kernel's static arrays, rounded up
SV_TILE = 128                # SV rows a ring stage (one a thread)
CHUNKS = (64, 32, 16, 8, 4)  # feature chunks, widest first
STAGES = 2                   # the kernel's ring of SV chunks
BLOCKS_PER_SM = 2            # resident blocks an SM a split aims for
BULK_BANK_WAYS = 16          # most-way bank conflict of the TMA path's
                             # coefficient reads (stride P: gcd(P, 32) ways);
                             # at 32 ways per-thread copies are faster

launches: Dict[str, int] = {"svm_predict_cells": 0, "svm_predict": 0}


class PredictPlan(NamedTuple):
    rows: int        # query rows a block
    v: int           # floats a copy and a shared vector load
    bulk: bool       # each tile as two contiguous spans by the TMA unit
    dk: int          # feature chunk (one chunk when d <= dk)
    ld: int          # shared row stride of a chunk
    cld: int         # shared row stride of the coefficient rows
    stage: int       # floats a ring stage (16-byte multiple)
    splits: int      # blocks sharing one slot's SV tiles
    tiles: int       # SV tiles a split
    smem: int        # dynamic shared memory bytes


def _lib() -> ctypes.CDLL:
    lib = runtime.library("svm_predict")
    if not getattr(lib, "_bound", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.svm_predict_cells_f32.argtypes = [p, p, p, p, p, p, p] + [i] * 15 \
            + [p]
        lib.svm_predict_cells_f32.restype = i
        lib._bound = True
    return lib


def _rows_per_block(p: int) -> int:
    return 8 if p <= 8 else 4 if p <= 16 else 2 if p <= 32 else 1


def _round4(n: int) -> int:
    return -(-n // 4) * 4


def predict_splits(c: int, m: int, k: int, p: int, n_sm: int) -> int:
    """Blocks that share one slot's SV tiles: 1 while the (slot, row tile,
    column block) units alone give every SM a block; else as many as put
    about BLOCKS_PER_SM blocks on each SM, at most one a tile of 128 SV
    rows, evened out so that every split has the same number of tiles
    but the last."""
    units = c * -(-m // _rows_per_block(p)) * -(-p // _P_BLOCK)
    tiles = -(-k // SV_TILE)
    if units >= n_sm or tiles <= 1:
        return 1
    want = max(1, min(tiles, BLOCKS_PER_SM * n_sm // units))
    per = -(-tiles // want)
    return -(-tiles // per)


def predict_plan(c: int, m: int, k: int, d: int, p: int, n_sm: int,
                 v: int, aligned: bool = False) -> PredictPlan:
    """The kernel's launch, which alone fixes its shared-memory layout:
    the widest feature chunk (64, or the whole row when d <= 64) whose two
    ring stages fit in shared memory beside the block's query rows, the
    coefficient row stride and the split count.  A tile moves as two
    contiguous spans by the TMA unit (``bulk``) when its rows are whole in
    one chunk and stored at their own stride, the block takes every column
    (P <= 64) and reads them at their own stride P with at most
    BULK_BANK_WAYS-way bank conflicts, and every span is 16-byte aligned
    (``aligned``: both tables start so, and k d and k P are multiples of
    4): the serving wave's shape.  Else the coefficient rows are copied
    per thread to an odd stride (conflict-free) wide enough for the
    widest column block.  Raises ValueError when not even 4-feature chunks
    fit (the query rows stay resident: ROWS x d floats)."""
    rows = _rows_per_block(p)
    x_bytes = 4 * _round4(rows * d)
    for dk in CHUNKS:
        ld = smem_stride(min(dk, d), v)
        bulk = (aligned and d <= dk and ld == d and p <= _P_BLOCK
                and math.gcd(p, 32) <= BULK_BANK_WAYS
                and (k * d) % 4 == 0 and (k * p) % 4 == 0)
        cld = p if bulk else min(p, _P_BLOCK) | 1
        stage = _round4(SV_TILE * (ld + cld))
        smem = x_bytes + STAGES * 4 * stage
        if smem + _SMEM_STATIC <= SMEM_MAX:
            splits = predict_splits(c, m, k, p, n_sm)
            tiles = -(-k // SV_TILE)
            return PredictPlan(rows, v, bulk, dk, ld, cld, stage, splits,
                               -(-tiles // splits), smem)
    raise ValueError(f"svm_predict_cells: d={d} query rows ({rows} a block) "
                     f"and 2 SV stages do not fit in shared memory")


def svm_predict_cells(xt: torch.Tensor, sv: torch.Tensor, coefs: torch.Tensor,
                      gammas: torch.Tensor, kind: str = "gauss_rbf"
                      ) -> torch.Tensor:
    """Batched per-cell multi-column prediction — the serving-engine launch.

    xt (C, m, d) routed+padded queries; sv (C, k, d) compacted SV tables;
    coefs (C, k, P) per-(task, sub) columns; gammas (C, P) per-column
    selected gammas.  Returns (C, m, P) f32.  Zero-coefficient padding rows
    (SV axis) and zero-coefficient cells contribute exactly zero.
    """
    if kind not in KINDS:
        raise ValueError(f"unknown kernel kind {kind!r}")
    for name, t in (("xt", xt), ("sv", sv), ("coefs", coefs)):
        runtime.check_tensor(name, t, (torch.float32,), ndim=3)
    runtime.check_tensor("gammas", gammas, (torch.float32,), ndim=2)
    c_count, m, d = xt.shape
    k = sv.shape[1]
    p = coefs.shape[2]
    if (sv.shape != (c_count, k, d) or coefs.shape != (c_count, k, p)
            or gammas.shape != (c_count, p)):
        raise ValueError(
            f"svm_predict_cells: xt {tuple(xt.shape)}, sv {tuple(sv.shape)}, "
            f"coefs {tuple(coefs.shape)}, gammas {tuple(gammas.shape)} "
            f"disagree")
    if xt.device.type == "cpu":
        if any(t.device != xt.device for t in (sv, coefs, gammas)):
            raise ValueError("svm_predict_cells: operands on several devices")
        return ref.svm_predict_cells_ref(xt, sv, coefs, gammas, kind)
    out, launched = _launch(xt, sv, coefs, gammas, kind)
    launches["svm_predict_cells"] += launched
    return out


def svm_predict(x_test: torch.Tensor, sv: torch.Tensor, coefs: torch.Tensor,
                gamma: float, kind: str = "gauss_rbf") -> torch.Tensor:
    """f = K(x_test, sv) @ coefs for one cell and one gamma, f32.

    x_test (nt, d), sv (ns, d), coefs (ns, P) -> (nt, P), or coefs (ns,)
    -> (nt,).  K is never written out: on the card this is B3's kernel at
    one cell with ``gamma`` in every column; the ragged row and SV edges
    are masked, nothing is padded.
    """
    if kind not in KINDS:
        raise ValueError(f"unknown kernel kind {kind!r}")
    runtime.check_tensor("x_test", x_test, (torch.float32,), ndim=2)
    runtime.check_tensor("sv", sv, (torch.float32,), ndim=2)
    runtime.check_tensor("coefs", coefs, (torch.float32,))
    squeeze = coefs.dim() == 1
    cols = coefs[:, None] if squeeze else coefs
    if (cols.dim() != 2 or sv.shape[1] != x_test.shape[1]
            or cols.shape[0] != sv.shape[0]):
        raise ValueError(f"svm_predict: x_test {tuple(x_test.shape)}, sv "
                         f"{tuple(sv.shape)}, coefs {tuple(coefs.shape)} "
                         f"disagree")
    if any(t.device != x_test.device for t in (sv, coefs)):
        raise ValueError("svm_predict: operands on several devices")
    g = float(gamma)
    if x_test.device.type == "cpu":
        out = ref.svm_predict_ref(x_test, sv, cols, g, kind)
    else:
        gammas = torch.full((1, cols.shape[1]), g, dtype=torch.float32,
                            device=x_test.device)
        out, launched = _launch(x_test[None], sv[None],
                                cols.contiguous()[None], gammas, kind)
        out = out[0]
        launches["svm_predict"] += launched
    return out[:, 0] if squeeze else out


def _launch(xt: torch.Tensor, sv: torch.Tensor, coefs: torch.Tensor,
            gammas: torch.Tensor, kind: str):
    """B3 on checked (C, m, d), (C, k, d), (C, k, P), (C, P) CUDA operands:
    (out, 1 if the kernel was launched else 0)."""
    c_count, m, d = xt.shape
    k = sv.shape[1]
    p = coefs.shape[2]
    runtime.check_launch("svm_predict_cells", (xt, sv, coefs, gammas),
                         xt.device)
    if c_count > _GRID_MAX or -(-p // _P_BLOCK) > _GRID_MAX:
        raise ValueError(f"svm_predict_cells: C={c_count} or P={p} beyond "
                         f"the kernel's grid")
    plan = predict_plan(c_count, m, k, d, p, runtime.sm_count(xt.device),
                        copy_width(d, sv.data_ptr()),
                        sv.data_ptr() % 16 == 0 and coefs.data_ptr() % 16 == 0)
    out = torch.empty((c_count, m, p), dtype=torch.float32, device=xt.device)
    if not out.numel():
        return out, 0
    if k == 0:
        return out.zero_(), 0
    units = c_count * -(-m // plan.rows) * -(-p // _P_BLOCK)
    ws = cnt = None
    if plan.splits > 1:                  # partials: (unit, split, 64)
        ws = torch.empty(units * plan.splits * 64, dtype=torch.float32,
                         device=xt.device)
        cnt = runtime.ticket_counters("svm_predict", xt.device, units)
    null = ctypes.c_void_p(0)
    rc = _lib().svm_predict_cells_f32(
        runtime.ptr(xt), runtime.ptr(sv), runtime.ptr(coefs),
        runtime.ptr(gammas), runtime.ptr(out),
        null if ws is None else runtime.ptr(ws),
        null if cnt is None else runtime.ptr(cnt), c_count, m, k, d, p,
        KINDS[kind], plan.v, int(plan.bulk), plan.dk, plan.ld, plan.cld,
        plan.stage, plan.splits, plan.tiles, plan.smem,
        runtime.stream_handle(xt.device))
    runtime.raise_on_error("svm_predict_cells", rc)
    return out, 1
