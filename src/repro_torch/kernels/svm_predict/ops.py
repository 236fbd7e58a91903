"""Wrapper for the fused multi-cell predict kernel: checks, dispatch by device.

A tensor on the CPU goes to the plain version in ``ref.py``; a CUDA tensor
goes to the hand-written kernel in ``csrc/svm_predict.cu`` or the call
raises.  Unlike the TPU wrapper, nothing is padded: the kernel masks the
ragged query-row and SV edges itself, so a serving wave's ``m_pad`` (a
multiple of 8) is launched as it is, and a bank of more than 64 columns is
one launch over blocks of 64 columns.  ``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch.kernels import runtime
from repro_torch.kernels.kernel_matrix.ops import KINDS
from repro_torch.kernels.svm_predict import ref

_GRID_MAX = 65535
_P_BLOCK = 64                # columns per block (ROWS * P <= 64 registers)
_SMEM_MAX = 232448           # bytes a block may use on sm_90
_SMEM_STATIC = 20480         # the kernel's static tiles, rounded up
_SV_TILE = 256
_DK = 16

launches: Dict[str, int] = {"svm_predict_cells": 0}


def _lib() -> ctypes.CDLL:
    lib = runtime.library("svm_predict")
    if not getattr(lib, "_bound", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.svm_predict_cells_f32.argtypes = [p, p, p, p, p, i, i, i, i, i,
                                              i, p]
        lib.svm_predict_cells_f32.restype = i
        lib._bound = True
    return lib


def _rows_per_block(p: int) -> int:
    return 8 if p <= 8 else 4 if p <= 16 else 2 if p <= 32 else 1


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

    runtime.check_launch("svm_predict_cells", (xt, sv, coefs, gammas),
                         xt.device)
    dpad = -(-d // _DK) * _DK
    smem = (4 * (_rows_per_block(p) * dpad + _SV_TILE * min(p, _P_BLOCK))
            + _SMEM_STATIC)
    if (c_count > _GRID_MAX or -(-p // _P_BLOCK) > _GRID_MAX
            or smem > _SMEM_MAX):
        raise ValueError(f"svm_predict_cells: C={c_count}, P={p} or d={d} "
                         f"beyond the kernel's limits")
    out = torch.empty((c_count, m, p), dtype=torch.float32, device=xt.device)
    if not out.numel():
        return out
    if k == 0:
        return out.zero_()
    rc = _lib().svm_predict_cells_f32(
        runtime.ptr(xt), runtime.ptr(sv), runtime.ptr(coefs),
        runtime.ptr(gammas), runtime.ptr(out), c_count, m, k, d, p,
        KINDS[kind], runtime.stream_handle(xt.device))
    runtime.raise_on_error("svm_predict_cells", rc)
    launches["svm_predict_cells"] += 1
    return out
