"""Wrappers for the Gauss-Seidel CD kernels: checks, dispatch by device.

Entry points (the JAX package's ``kernels/cd_solver/ops.py`` names):

* :func:`cd_wave_epoch`  — one epoch over S slots x F problems per slot
  (B4), the launch everything below goes through;
* :func:`cd_epoch` / :func:`cd_epochs` — one epoch / ``epochs`` sweeps of
  one cell (B5: the same kernel at one slot, counted as its own entry);
* :func:`cd_epochs_wave` — ``epochs`` sweeps of a wave of cells;
* :func:`cd_polish`      — the CV solver's polish after FISTA: a wave of
  slots, each with its folds sharing the slot's Gram, in one launch per
  epoch.

K must be symmetric, as every Gram is (B1-sym makes the training Gram
equal its transpose bitwise): the kernel reads row i of K where the plain
sweep reads column i, and the two agree bit for bit only on such a K.
A CPU tensor goes to the plain exact sweep in ``ref.py``; a CUDA tensor
goes to ``csrc/cd_solver.cu`` or the call raises.  Unlike the reference,
which runs a delayed-update blocked sweep off the TPU (one GEMM a block,
another summation order), the port runs the exact sweep everywhere: on
the card the kernel runs it in panels of 32 coordinates whose deltas reach
every row in coordinate order, so it is the exact sweep bit for bit.
``launches`` counts kernel launches (never plain-version calls).
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from repro_torch.kernels import runtime
from repro_torch.kernels.cd_solver import ref

_BULK = 480                  # threads of a block that hold g's rows
_G_REGS = 64                 # registers of g a thread: rows x columns
_ROWS = (1, 2, 4, 8, 16, 32)
_GRID_MAX = 65535

launches: Dict[str, int] = {"cd_wave_epoch": 0, "cd_epoch": 0}


def _lib() -> ctypes.CDLL:
    lib = runtime.library("cd_solver")
    if not getattr(lib, "_bound", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.cd_wave_epoch.argtypes = [p, p, p, p, p, i, i, i, i, i, i, p]
        lib.cd_wave_epoch.restype = i
        lib._bound = True
    return lib


def thread_rows(n: int) -> int:
    """Rows of g each of the kernel's 480 bulk threads holds in registers:
    the least of 1, 2, 4, .., 32 with 480 rows >= n."""
    for r in _ROWS:
        if _BULK * r >= n:
            return r
    raise ValueError(f"cd kernel: {n} coordinates exceed the "
                     f"{_BULK * _ROWS[-1]} rows its registers hold")


def _kernel_cols(n: int, p: int, slots: int, n_sm: int) -> int:
    bc = min(16, _G_REGS // thread_rows(n))
    if bc == 16 and slots * -(-p // 16) < n_sm:
        bc = 8
    return bc


def block_cols(n: int, p: int, slots: int = 1, n_sm: int = 0) -> int:
    """Columns a block holds (of a slot's ``p`` = F x P): 16, fewer where
    the rows a thread holds times the columns would pass 64 registers; 8
    where ``slots`` x the 16-column blocks would leave some of ``n_sm``
    SMs idle.  At most ``p``."""
    return max(min(_kernel_cols(n, p, slots, n_sm), p), 1)


def _check(k: torch.Tensor, c, g, lo, hi) -> None:
    runtime.check_tensor("k", k, (torch.float32,), ndim=3)
    for name, t in (("c", c), ("g", g), ("lo", lo), ("hi", hi)):
        runtime.check_tensor(name, t, (torch.float32,), ndim=4)
        if t.shape != c.shape or t.device != k.device:
            raise ValueError(f"cd: {name} {tuple(t.shape)} on {t.device} for "
                             f"c {tuple(c.shape)}, k on {k.device}")
    s, n = k.shape[0], k.shape[1]
    if k.shape != (s, n, n) or c.shape[0] != s or c.shape[2] != n:
        raise ValueError(f"cd: k {tuple(k.shape)} and c {tuple(c.shape)} "
                         f"disagree: need (S, n, n) and (S, F, n, P)")


def _launch(k: torch.Tensor, c: torch.Tensor, g: torch.Tensor,
            lo: torch.Tensor, hi: torch.Tensor, counter: str) -> None:
    """One epoch in place on ``c`` and ``g``; ``k`` symmetric per slot."""
    s, f, n, p = c.shape
    runtime.check_launch("cd_wave_epoch", (k, c, g, lo, hi), c.device)
    if s > _GRID_MAX or f * p >= 2 ** 31:
        raise ValueError(f"cd: {s} slots x {f * p} columns exceed the grid")
    if c.numel() == 0:
        return
    rows = thread_rows(n)
    cols = _kernel_cols(n, f * p, s, runtime.sm_count(c.device))
    rc = _lib().cd_wave_epoch(
        runtime.ptr(k), runtime.ptr(c), runtime.ptr(g), runtime.ptr(lo),
        runtime.ptr(hi), s, f, n, p, rows, cols,
        runtime.stream_handle(c.device))
    runtime.raise_on_error("cd_wave_epoch", rc)
    launches[counter] += 1


def _epochs(k: torch.Tensor, c: torch.Tensor, g: torch.Tensor,
            lo: torch.Tensor, hi: torch.Tensor, epochs: int, counter: str
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    _check(k, c, g, lo, hi)
    if k.device.type == "cpu":
        for _ in range(epochs):
            c, g = ref.cd_wave_epoch_ref(k, c, g, lo, hi)
        return c, g
    k = k.contiguous()
    c, g = c.contiguous().clone(), g.contiguous().clone()
    lo, hi = lo.contiguous(), hi.contiguous()
    for _ in range(epochs):
        _launch(k, c, g, lo, hi, counter)
    return c, g


def cd_wave_epoch(k: torch.Tensor, c: torch.Tensor, g: torch.Tensor,
                  lo: torch.Tensor, hi: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One Gauss-Seidel epoch: k (S, n, n) symmetric; c, g, lo, hi
    (S, F, n, P) f32.  Returns the new (c, g)."""
    return _epochs(k, c, g, lo, hi, 1, "cd_wave_epoch")


def cd_epoch(k_mat: torch.Tensor, c: torch.Tensor, g: torch.Tensor,
             lo: torch.Tensor, hi: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One epoch of one cell (B5): k_mat (n, n); c, g, lo, hi (n, P) f32.
    Returns the new (c, g)."""
    c, g = _epochs(k_mat[None], c[None, None], g[None, None], lo[None, None],
                   hi[None, None], 1, "cd_epoch")
    return c[0, 0], g[0, 0]


def slot_matmul(k: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """(S, n, n) x (S, F, n, P) -> (S, F, n, P): each slot's K against all
    of its problems' columns in one product, K never copied per problem."""
    s, f, n, p = c.shape
    cols = c.permute(0, 2, 1, 3).reshape(s, n, f * p)
    return torch.bmm(k, cols).reshape(s, n, f, p).permute(0, 2, 1, 3)


def _cols(y: torch.Tensor, shape) -> torch.Tensor:
    return y.to(torch.float32).expand(shape).contiguous()


def cd_epochs(k_mat: torch.Tensor, y: torch.Tensor, lo: torch.Tensor,
              hi: torch.Tensor, c0: torch.Tensor, epochs: int = 1
              ) -> torch.Tensor:
    """``epochs`` sweeps on min 0.5 c'Kc - c'y, lo <= c <= hi, one cell.

    k_mat (n, n); y (n,) or (n, P); lo, hi, c0 (n, P).  Returns c (n, P).
    Padding coordinates must have lo == hi == 0.  On the card this is the
    wave kernel at one slot (B5)."""
    if y.dim() == 1:
        y = y[:, None]
    k = k_mat.to(torch.float32)[None]
    c0 = c0.to(torch.float32)[None, None]
    g0 = slot_matmul(k, c0) - _cols(y, c0.shape)
    c, _ = _epochs(k, c0, g0, _cols(lo, c0.shape), _cols(hi, c0.shape),
                   epochs, "cd_epoch")
    return c[0, 0]


def cd_epochs_wave(k_mats: torch.Tensor, y: torch.Tensor, lo: torch.Tensor,
                   hi: torch.Tensor, c0: torch.Tensor, epochs: int = 1
                   ) -> torch.Tensor:
    """Wave form of :func:`cd_epochs`: k_mats (S, n, n); y (S, n) or
    (S, n, P); lo, hi, c0 (S, n, P).  Returns c (S, n, P)."""
    if y.dim() == 2:
        y = y[:, :, None]
    k = k_mats.to(torch.float32)
    c0 = c0.to(torch.float32)[:, None]
    g0 = slot_matmul(k, c0) - _cols(y[:, None], c0.shape)
    c, _ = _epochs(k, c0, g0, _cols(lo[:, None], c0.shape),
                   _cols(hi[:, None], c0.shape), epochs, "cd_wave_epoch")
    return c[:, 0]


def cd_polish(k_mat: torch.Tensor, y: torch.Tensor, lo: torch.Tensor,
              hi: torch.Tensor, c0: torch.Tensor, epochs: int
              ) -> torch.Tensor:
    """Polish box-QP iterates with ``epochs`` Gauss-Seidel sweeps.

    k_mat (S, n, n) in any float dtype (the sweep runs in f32); y, lo, hi,
    c0 (S, F, n, P): the F problems of a slot (its CV folds) share the
    slot's Gram.  Starts are clipped into the box first (from a feasible
    start the descent is monotone).  One launch per epoch for the whole
    wave.  Returns c (S, F, n, P)."""
    k = k_mat.to(torch.float32)
    y, lo, hi = (t.to(torch.float32) for t in (y, lo, hi))
    c0 = torch.clamp(c0.to(torch.float32), min=lo, max=hi)
    g0 = slot_matmul(k, c0) - y
    c, _ = _epochs(k, c0, g0, lo.contiguous(), hi.contiguous(), epochs,
                   "cd_wave_epoch")
    return c
