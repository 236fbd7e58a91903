#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port: serving, training, LM and
cell-construction paths.

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (``nvcc``); builds the port's
kernels from ``src/repro_torch/csrc/`` into ``build/kernels/`` and then:

  1. prints the card (``nvidia-smi`` name and power limit) and the build,
     and requires HGMMA (``wgmma``) instructions in the SASS of B9's
     library (``cuobjdump`` from the CUDA toolkit);
  2. holds each kernel against its plain PyTorch version on the card at
     the serving wave's shapes (B2 also with bf16 in and out and with the
     Laplacian kernel, B3 also Laplacian and at 70 columns, more than one
     64-column block);
  3. serves ~8k cluster-routed requests in waves of 1024 through
     ``SVMEngine`` over a Covertype-shaped bank (UCI Covertype: d=54,
     7 classes, one-vs-all; liquidSVM's default cell size 2000 ->
     256 cells of 2048 SV rows): fused with nearest routing, fused with an
     overlap bank, unfused, and one ``sweep_gammas`` over 8 gammas; checks
     the decisions against plain end-to-end references, each value within
     its own error bound, and reads the kernels' launch counts of each of
     those four runs (each must launch its own kernels and no other);
  4. times the serving waves;
  5. training (``LiquidSVM.fit`` -> cells -> fused CV gamma scan -> FISTA
     + Gauss-Seidel polish -> ``to_bank``) at Covertype's widths (d=54,
     7 classes one-vs-all, liquidSVM's recursive cells of 2000, 5 folds,
     the default 10 x 10 grid; rows from ``covtype_like``, 32004 for
     training and 8000 held out): holds the symmetric D² (B1-sym) and the
     Gauss-Seidel epoch (B4, and B5 at one slot) against their plain
     versions at the training wave's shapes (16 slots x 5 folds x k_max
     rows x 70 columns), fits a small set on the CPU and on the card and
     compares plans, fold masks, surfaces and selections, then fits the
     full set on the card with the launches of every wave counted, its
     stage times, FISTA iterations and test error through
     ``decision_function`` and through the bank served by ``SVMEngine``;
     drives ``cd_epochs`` (B5's entry point) on one fitted cell;
  6. the LM path at stablelm-1.6b's full width (seed-initialised, bf16):
     holds flash attention (B9) and fused decode attention (B10) against
     their plain versions (every mask kind, GQA, head_dim 64 and 256, bf16
     and int8 caches, partial and wrapped ring caches, windows); embeds a
     three-domain token corpus (3 x 1024 sequences of 256 tokens) through
     write-through caches, one block also through the plain attention,
     then replays the shards; trains the SVM head on the embeddings with
     ``SVM(source, None)`` (labels from the source), tests it on the
     held-out sequences and serves them through ``EmbedServe``; generates
     64 tokens for 8 prompts of 256 with a bf16 and an int8 cache, and at
     the smoke configs in f32 checks the tokens through the kernels equal
     the plain path's; each run's launches are counted on their own;
  7. cell construction at UCI Covertype's full size (covtype_like rows,
     580,986 x 54, written to a memmap under ``build/chip_smoke_cells/``,
     removed at the start and the end of the phase): holds the
     nearest-center kernel (B6) against its plain version at the chunk
     shape (65,536 x 291 centers), at a HIGGS-width table (5500 x 28,
     larger than shared memory), with duplicated centers and off every
     tile, the one-shot Gram (B7) and the one-cell predict (B8); runs the
     spatial builder's pass 0 (3 Lloyd sweeps of 291 centers and the
     owners) through ``MemmapSource`` with the B6 backend (exactly 36
     launches) and with numpy, every owner flip within its D² bound;
     minibatch k-means on the card twice (bitwise equal); one cell
     through ``kernel_matrix`` (B7), a kernel ridge solve and
     ``svm_predict`` (B8) with its test error;
  8. times each kernel at the main path's shapes beside its plain version,
     its bound from bytes and operations, and a one-call PyTorch yardstick
     where one exists (B9 and B10 also at long contexts, B2 also
     at the training gamma step: 16 slots of 1824^2, one gamma; B3 also
     at the LM head's wave, EmbedServe's most frequent launch shape,
     held against its plain version within ``predict_bound``); prints
     one JSON line per phase, the kernel table, and last
     ``{"ok": true, "device": {...}}``.

Any mismatch or exception ends the run with a non-zero exit code.  Without
a card, or without the rest of the repository beside it, it exits non-zero
before printing any result.
"""
from __future__ import annotations

import collections
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# Covertype-shaped cell model (see the module docstring)
N_CELLS, K_SV, DIM, N_TASKS, N_SUB = 256, 2048, 54, 7, 1
N_REQ, WAVE, N_SWEEP, SEED = 8192, 1024, 8, 0
ZERO_FRAC = 0.6          # share of zero (non-SV) dual rows per raw cell
OVERLAP_FRAC = 0.25      # share of overlap-bank queries near a cell border
WIDE_P, WIDE_SLOTS = 70, 32   # the B3 check past one 64-column block
BOUND_FLOOR = 1e-30      # absolute slack of the decision bounds (subnormals)

# training slice: UCI Covertype's widths (d=54, 7 classes, one-vs-all,
# cell size 2000) on covtype_like rows; liquidSVM's VORONOI=6 (recursive)
# cells keep every cell within the cell size (k_max 1824 vs 6858 for
# plain Voronoi on these rows), and the wave is 16 slots of them
N_CLASSES, TRAIN_N, HELDOUT_N, HELDOUT_SEED = 7, 32004, 8000, 2
TRAIN_CFG = dict(scenario="ova", cell_method="recursive", cell_size=2000,
                 n_folds=5, grid_choice=0, tol=1e-3, max_iters=1000,
                 cd_polish=2, n_slots_per_wave=16)
SMALL_N, SMALL_SEED = 1008, 1      # the CPU-vs-card fit
SMALL_CFG = dict(scenario="ova", cell_method="recursive", cell_size=500,
                 n_folds=3, tol=1e-3, max_iters=1000, cd_polish=2)
CD_EPOCHS = 2
FISTA_PROFILE_ITERS = 20
# surfaces of the CPU and the card fit: at most this share of a column's
# validation samples may change sides (see small_fit_parity)
FLIP_SHARE = 0.01

# LM slice: stablelm-1.6b at full width (hf:stabilityai/stablelm-2-1_6b: 24
# layers, d_model 2048, 32 heads of 64, d_ff 5632, vocab 100352, bf16),
# seed-initialised (no weights are downloaded); a three-domain token corpus
# made with numpy, 1024 sequences of 256 tokens per class (768 to train,
# 256 held out); the SVM head with the settings of examples/lm_svm_head.py
LM_ARCH, LM_SEQ, LM_BATCH = "stablelm-1.6b", 256, 32
LM_CLASSES, LM_TRAIN_PER_CLASS, LM_HELD_PER_CLASS = 3, 768, 256
LM_DOMAIN, LM_ZIPF, LM_SHARED = 4096, 1.1, 0.5
LM_SVM_CFG = dict(scenario="ova", cell_method="voronoi", cell_size=800,
                  n_folds=3, max_iters=400)
GEN_BATCH, GEN_PROMPT, GEN_NEW = 8, 256, 64
# long contexts for the kernel table: B9 (B, T = S), B10 (B, S) at a batch
# of 16 and at batch 1 (B10's split over the keys)
LONG_B9, LONG_B10, LONG_B10_ONE = (1, 4096), (16, 32768), (1, 32768)
# kernels vs the plain path through the bf16 backbone, relative to the
# largest |value|: B9 and the plain attention agree to f32 rounding before
# each layer rounds its output to bf16, so a value next to a rounding
# boundary may land one bf16 ulp (2^-8 relative) away, and the 24 layers
# that follow carry such flips (PERF.md, LM slice)
LM_EMBED_TOL = 3e-2
LM_LOGIT_TOL = 3e-2

# cell-construction slice: UCI Covertype at full size (581,012 rows of 54
# features, 7 classes; covtype_like rounds n down to 580,986), the spatial
# builder's pass 0 with liquidSVM's cell size 2000 -> 291 centers and the
# builder's default 3 Lloyd sweeps, chunks of 65,536 rows (9 per pass);
# minibatch k-means with the reference's defaults (20 steps of 4096)
CELLS_N, CELL_SIZE, LLOYD_ITERS, CHUNK = 581012, 2000, 3, 65536
MBK_ITERS, MBK_BATCH = 20, 4096
CELLS_DIR = ROOT / "build" / "chip_smoke_cells"
# B6 also at a HIGGS-width table (11 M rows in cells of 2000 -> 5500
# centers of d 28: 616 KB, more than a block's shared memory)
HIGGS_C, HIGGS_D = 5500, 28
# one cell through the kernel layer's entry points: B7 on 2048 training
# rows, kernel ridge over the 7 one-vs-all columns, B8 on 8192 test rows
ONE_CELL_N, ONE_CELL_TEST, ONE_CELL_LAMBDA = 2048, 8192, 1e-3

# the card's published peaks (H100 SXM data sheet, dense, 700 W)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12
SLEEP_CYCLES = 20_000_000   # ~10 ms at the H100's ~1.98 GHz boost clock

KERNELS = {  # name -> (wrapper source, TPU kernel it replaces)
    "sq_dists": ("src/repro_torch/csrc/kernel_matrix.cu",
                 "src/repro/kernels/kernel_matrix/kernel_matrix.py:134"),
    "gram_from_d2": ("src/repro_torch/csrc/kernel_matrix.cu",
                     "src/repro/kernels/kernel_matrix/kernel_matrix.py:190"),
    "svm_predict_cells": ("src/repro_torch/csrc/svm_predict.cu",
                          "src/repro/kernels/svm_predict/svm_predict.py:122"),
    "sq_dists_sym": ("src/repro_torch/csrc/kernel_matrix.cu",
                     "src/repro/kernels/kernel_matrix/kernel_matrix.py:98"),
    "cd_wave_epoch": ("src/repro_torch/csrc/cd_solver.cu",
                      "src/repro/kernels/cd_solver/cd_solver.py:160"),
    "cd_epoch": ("src/repro_torch/csrc/cd_solver.cu",
                 "src/repro/kernels/cd_solver/cd_solver.py:115"),
    "flash_attention": (
        "src/repro_torch/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention/flash_attention.py:89"),
    "decode_attention": (
        "src/repro_torch/csrc/decode_attention.cu",
        "src/repro/kernels/decode_attention/decode_attention.py:78"),
    "assign": ("src/repro_torch/csrc/assign.cu",
               "src/repro/pipeline/assign.py:237"),
    "gram": ("src/repro_torch/csrc/kernel_matrix.cu",
             "src/repro/kernels/kernel_matrix/kernel_matrix.py:62"),
    "svm_predict": ("src/repro_torch/csrc/svm_predict.cu",
                    "src/repro/kernels/svm_predict/svm_predict.py:63"),
}


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


class Mismatch(AssertionError):
    pass


def check(name: str, err: float, tol: float, **extra) -> float:
    emit({"phase": "check", "name": name, "max_abs_err": err, "tol": tol,
          "ok": bool(err <= tol), **extra})
    if not err <= tol:
        raise Mismatch(f"{name}: max abs err {err} > tol {tol}")
    return err


def check_bound(name: str, got, want, bnd, **extra) -> float:
    """Hold every value against its own bound: |got - want| <= bnd
    elementwise.  Reports the max abs error, the largest error/bound ratio,
    and the share of values that are not zero (an underflowed decision is
    zero on both sides and can show no error)."""
    got, want, bnd = (np.asarray(a, np.float64) for a in (got, want, bnd))
    diff = np.abs(got - want)
    ratio = float((diff / bnd).max())
    err = float(diff.max())
    emit({"phase": "check", "name": name, "max_abs_err": err,
          "max_err_over_bound": ratio, "max_bound": float(bnd.max()),
          "nonzero_share": float((np.abs(want) > BOUND_FLOOR).mean()),
          "ok": bool(ratio <= 1.0), **extra})
    if not ratio <= 1.0:
        raise Mismatch(f"{name}: error {ratio} times its bound")
    return err


def predict_bound(torch, sq_dists_ref, xt, sv, co, ga, kind: str,
                  dd2: float):
    """Elementwise bound on |svm_predict_cells - its plain version| when
    the two D² differ by at most ``dd2`` (the D² tolerance): a D² error
    scales each kernel value K by at most exp(dd2 / gamma^2) (Gaussian) or
    exp(min(sqrt(dd2), dd2 / 2r) / gamma) (Laplacian, r = sqrt(D²)); exp's
    rounding and the f32 sum over k rows add k * eps of each term.  Returns
    (C, m, P): sum_j |coef_jp| K_jp (expm1(...) + k eps) + floor."""
    eps = float(np.finfo(np.float32).eps)
    d2 = sq_dists_ref(xt, sv)[:, None]                       # (C, 1, m, k)
    g = ga[:, :, None, None]                                 # (C, P, 1, 1)
    if kind == "gauss_rbf":
        den = torch.clamp(g * g, min=1e-12)
        kk = torch.exp(-d2 / den)
        rel = torch.expm1(dd2 / den)
    else:
        root = torch.sqrt(d2 + 1e-12)
        den = torch.clamp(g, min=1e-12)
        kk = torch.exp(-root / den)
        droot = torch.clamp(dd2 / (2.0 * root), max=dd2 ** 0.5)
        rel = torch.expm1(droot / den)
    terms = kk * (rel + sv.shape[1] * eps)                   # (C, P, m, k)
    return (torch.matmul(terms, co.abs().transpose(1, 2)[..., None])[..., 0]
            .transpose(1, 2) + BOUND_FLOOR)


def make_bank_and_traffic(bank_cls, seed: int = SEED):
    """Synthetic trained cell batch after the serving benchmark's recipe:
    clustered cells, sparse hinge-like duals, per-(task, sub) gammas all
    distinct; queries clustered around the cell centers, plus a set of
    near-border queries for the overlap bank."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(N_CELLS, DIM)).astype(np.float32) * 5.0
    sv = (centers[:, None, :]
          + rng.normal(size=(N_CELLS, K_SV, DIM))).astype(np.float32)
    coefs = rng.normal(size=(N_CELLS, K_SV, N_TASKS, N_SUB)).astype(np.float32)
    coefs[rng.random((N_CELLS, K_SV)) < ZERO_FRAC] = 0.0
    gammas = rng.uniform(0.6, 4.0,
                         size=(N_CELLS, N_TASKS, N_SUB)).astype(np.float32)
    mask = np.ones((N_CELLS, K_SV), np.float32)
    classes = np.arange(N_TASKS, dtype=np.float32)
    # full width: every raw row kept, zero rows are exact-zero padding
    full = bank_cls.from_cells(sv, mask, coefs, gammas, centers,
                               drop_tol=None, dedup=False, classes=classes,
                               scenario="ova")
    # compacted (zero rows dropped, duplicates merged), 2-NN routed
    overlap = bank_cls.from_cells(sv, mask, coefs, gammas, centers,
                                  drop_tol=0.0, classes=classes,
                                  scenario="ova", routing="overlap")
    owners = rng.integers(0, N_CELLS, N_REQ)
    queries = (centers[owners]
               + rng.normal(size=(N_REQ, DIM)) * 0.5).astype(np.float32)
    border = np.where(rng.random(N_REQ) < OVERLAP_FRAC)[0]
    other = rng.integers(0, N_CELLS, border.size)
    q_overlap = queries.copy()
    q_overlap[border] = (0.5 * (centers[owners[border]] + centers[other])
                         + rng.normal(size=(border.size, DIM)) * 0.05)
    return full, overlap, queries, q_overlap.astype(np.float32)


def plain_decisions(bank, x, overlap, device, torch, svm_ref, sq_dists_ref,
                    nearest_center, nearest_top2_dists, blend_weights):
    """End-to-end plain reference: route on the host, evaluate each cell's
    rows with the plain PyTorch predict on the card, blend.  Returns the
    decisions and each one's error bound (:func:`predict_bound`, with the
    D² tolerance of the bank's largest norms, blended with the same
    weights)."""
    eps = float(np.finfo(np.float32).eps)
    xs = ((x - bank.feat_mean) / bank.feat_std).astype(np.float32)
    m = xs.shape[0]
    if overlap:
        c1, c2, d1, d2 = nearest_top2_dists(xs, bank.centers)
        w1, w2 = blend_weights(d1, d2)
        parts = [(c1, w1), (c2, w2)]
    else:
        c1 = nearest_center(xs, bank.centers)
        parts = [(c1, np.ones(m, np.float32))]
    sv, co = bank.cell_arrays_f32(device)
    ga = torch.as_tensor(bank.gammas).to(device)
    dd2 = 64 * eps * (float((xs * xs).sum(-1).max())
                      + float((sv * sv).sum(-1).max()))
    out = np.zeros((m, bank.n_tasks * bank.n_sub), np.float32)
    bnd = np.zeros_like(out)
    for cells, w in parts:
        for c in np.unique(cells[w > 0]):
            rows = np.where((cells == c) & (w > 0))[0]
            xt = torch.as_tensor(xs[rows]).to(device)[None]
            one = (xt, sv[c:c + 1], co[c:c + 1], ga[c:c + 1])
            dec = svm_ref(*one, kind=bank.kernel)[0].cpu().numpy()
            b = predict_bound(torch, sq_dists_ref, *one, bank.kernel,
                              dd2)[0].cpu().numpy()
            out[rows] += w[rows, None] * dec
            bnd[rows] += w[rows, None] * b
    shape = (m, bank.n_tasks, bank.n_sub)
    return out.reshape(shape), bnd.reshape(shape)


def serve(engine, queries):
    """Double-buffered serving: wave w is in flight while w+1 is admitted.
    Returns the decisions in request order and the seconds spent in
    ``submit`` (host routing and admission)."""
    res = {}
    ids = []
    submit_s = 0.0
    for lo in range(0, queries.shape[0], WAVE):
        t0 = time.perf_counter()
        ids.append(engine.submit(queries[lo:lo + WAVE]))
        submit_s += time.perf_counter() - t0
        if engine.in_flight:
            res.update(engine.finish_step())
        engine.begin_step()
    res.update(engine.finish_step())
    ids = np.concatenate(ids)
    return np.stack([res[int(i)] for i in ids]), submit_s


def zero_counts(tables) -> None:
    for table in tables:
        for name in table:
            table[name] = 0


def read_counts(tables) -> dict:
    return {name: n for table in tables for name, n in table.items()}


def require_launches(label: str, counts: dict, expect: dict) -> None:
    """``expect``: kernel -> exact count; every other kernel must be 0."""
    for name, n in counts.items():
        want = expect.get(name, 0)
        if n != want:
            raise Mismatch(f"{label}: kernel {name} launched {n} times, "
                           f"expected {want}")


def wave_problem(torch, x_w, mask_w, n_folds: int, n_cols: int, seed: int):
    """A hinge-like wave of box QPs on the cells' own Gram: per-slot gamma
    from the mean valid D², random fold partitions and labels, one box
    scale per column spread over the grid's range; padding rows and each
    fold's validation rows are pinned (lo == hi == 0), as in the CV solve.
    Returns d2 (B1-sym's output on the card), K, c0, g0, lo, hi."""
    from repro_torch.kernels.cd_solver import ops as cd_ops
    from repro_torch.kernels.kernel_matrix import ops as km_ops
    dev = x_w.device
    s, k = mask_w.shape
    d2 = km_ops.sq_dists(x_w, x_w, symmetric=True)
    pair = mask_w[:, :, None] * mask_w[:, None, :]
    gam = torch.sqrt((d2 * pair).sum((1, 2)) / pair.sum((1, 2)).clamp(min=1))
    kk = km_ops.gram_from_d2(d2, gam[:, None].contiguous())[:, 0]
    gen = torch.Generator().manual_seed(seed)
    y = torch.where(torch.rand(s, 1, k, 1, generator=gen) < 0.5, -1.0, 1.0)
    fold = torch.randint(0, n_folds, (s, k), generator=gen)
    train = ((fold[:, None, :] != torch.arange(n_folds)[None, :, None])
             .float() * mask_w.cpu()[:, None, :])[..., None]     # (S,F,k,1)
    cost = torch.logspace(-3, 1, n_cols)[None, None, None, :]
    edge = y * cost * train
    lo, hi = edge.clamp(max=0.0), edge.clamp(min=0.0)
    c0 = torch.clamp(torch.randn(s, n_folds, k, n_cols, generator=gen) * cost,
                     min=lo, max=hi)
    lo, hi, c0 = lo.to(dev), hi.to(dev), c0.to(dev)
    y_eff = (y * train).expand_as(lo).to(dev)
    g0 = (cd_ops.slot_matmul(kk, c0) - y_eff).contiguous()
    return d2, kk, c0.contiguous(), g0, lo.contiguous(), hi.contiguous()


def train_kernel_checks(torch, x_w, mask_w, n_folds: int, n_cols: int):
    """B1-sym, B4 and B5 against their plain versions at the training
    wave's shapes.  B1-sym: bitwise equal to its transpose, and within
    B1's 64 ulps of the largest |x|^2 + |z|^2 of the plain 0.5 (D + D^T).
    B4: CD_EPOCHS epochs bitwise equal to the plain exact sweep on the
    card (every operation rounded on its own on both sides).  B5: each of
    three slots alone (its folds' columns side by side, K shared) bitwise
    equal to B4's result for that slot."""
    from repro_torch.kernels.cd_solver import ops as cd_ops
    from repro_torch.kernels.cd_solver import ref as cd_ref
    from repro_torch.kernels.kernel_matrix import ref as km_ref
    eps = float(np.finfo(np.float32).eps)
    errs = {}
    prob = wave_problem(torch, x_w, mask_w, n_folds, n_cols, SEED)
    d2, kk, c0, g0, lo, hi = prob
    want = km_ref.sq_dists_ref(x_w, x_w, symmetric=True)
    torch.cuda.synchronize()
    sym = bool(torch.equal(d2, d2.transpose(1, 2)))
    scale = float(2 * (x_w * x_w).sum(-1).max())
    errs["sq_dists_sym"] = check(
        "sq_dists_sym", float((d2 - want).abs().max()), 64 * eps * scale,
        shape=list(d2.shape), bitwise_symmetric=sym)
    if not sym:
        raise Mismatch("sq_dists_sym: result differs from its transpose")
    del want

    kc, kg, pc, pg = c0, g0, c0, g0
    for _ in range(CD_EPOCHS):
        kc, kg = cd_ops.cd_wave_epoch(kk, kc, kg, lo, hi)
        pc, pg = cd_ref.cd_wave_epoch_ref(kk, pc, pg, lo, hi)
    torch.cuda.synchronize()
    same = bool(torch.equal(kc, pc) and torch.equal(kg, pg))
    moved = float((kc != c0).float().mean())
    errs["cd_wave_epoch"] = check(
        "cd_wave_epoch", float(max((kc - pc).abs().max(),
                                   (kg - pg).abs().max())), 0.0,
        shape=list(kc.shape), epochs=CD_EPOCHS, bitwise=same,
        moved_share=moved)
    if not same or moved == 0.0:
        raise Mismatch("cd_wave_epoch: not bitwise equal to the plain sweep "
                       "or nothing moved")
    del pc, pg
    s, f, n, p = c0.shape
    worst = 0.0
    for si in range(3):
        def cols(t):   # (F, n, P) -> (n, F P): the slot's folds side by side
            return t[si].permute(1, 0, 2).reshape(n, f * p).contiguous()
        oc, og = cols(c0), cols(g0)
        for _ in range(CD_EPOCHS):
            oc, og = cd_ops.cd_epoch(kk[si], oc, og, cols(lo), cols(hi))
        torch.cuda.synchronize()
        diff = float(max((oc - cols(kc)).abs().max(),
                         (og - cols(kg)).abs().max()))
        worst = max(worst, diff)
        if not (torch.equal(oc, cols(kc)) and torch.equal(og, cols(kg))):
            raise Mismatch(f"cd_epoch: slot {si} differs from B4's result")
    errs["cd_epoch"] = check("cd_epoch[3 slots] vs cd_wave_epoch", worst, 0.0,
                             shape=[n, f * p], bitwise=True)
    return errs, prob


def small_fit_parity(torch, dev, covtype_like, LiquidSVM, SVMTrainerConfig,
                     make_fold_masks, argmin_winners):
    """The small fit on the CPU and on the card: the same plan and fold
    masks (bitwise); surfaces within FLIP_SHARE of each column's validation
    samples; every flip of a selected (gamma, lambda) within one validation
    sample's share of that column's loss.

    Why FLIP_SHARE: both runs stop FISTA at a KKT residual of 1e-3 of the
    box width and sum their products in other orders (MKL against cuBLAS),
    so a decision may differ by about 1e-3 of its scale; a zero-one loss
    changes only for a validation sample whose decision lies that close to
    0, which for decisions spread over their scale is about 1e-3 of the
    samples per unit of density: 1 % leaves a factor of ten for a denser
    neighbourhood of the boundary."""
    x, y = covtype_like(n=SMALL_N, d=54, n_classes=N_CLASSES, seed=SMALL_SEED)
    cfg = SVMTrainerConfig(**SMALL_CFG)
    t0 = time.perf_counter()
    m_cpu = LiquidSVM(cfg, device="cpu").fit(x, y)
    t1 = time.perf_counter()
    m_dev = LiquidSVM(cfg, device=dev).fit(x, y)
    t2 = time.perf_counter()
    a, b = m_cpu.train_result, m_dev.train_result
    for field in ("indices", "mask", "owner", "centers"):
        if not np.array_equal(getattr(a.plan, field), getattr(b.plan, field)):
            raise Mismatch(f"small fit: cell plans differ in {field}")
    if not np.array_equal(a.fold_keys, b.fold_keys):
        raise Mismatch("small fit: fold keys differ")
    mask = torch.as_tensor(a.mask_cells)
    vm_cpu = make_fold_masks(a.fold_keys, mask, cfg.n_folds)
    vm_dev = make_fold_masks(b.fold_keys, mask.to(dev), cfg.n_folds).cpu()
    if not torch.equal(vm_cpu, vm_dev):
        raise Mismatch("small fit: fold masks differ")
    # one validation sample's share of a column's loss (mean over folds of
    # each fold's mean), per slot; OvA columns share the slot's mask
    n_val = vm_cpu.sum(-1).clamp(min=1).double().numpy()       # (slots, F)
    share = (1.0 / (cfg.n_folds * n_val)).max(-1)              # (slots,)
    per_col = np.maximum(np.ceil(FLIP_SHARE * a.mask_cells.sum(-1)), 1.0)
    diff = np.abs(a.surf_loss.astype(np.float64) - b.surf_loss)
    flips_eq = diff / share[:, None, None, None, None]         # samples
    ok_surf = bool((flips_eq <= per_col[:, None, None, None, None]
                    + 1e-3).all())
    ga, la = argmin_winners(a.surf_loss)
    gb, lb = argmin_winners(b.surf_loss)
    moved = (ga != gb) | (la != lb)
    gaps = []
    for si, t, u in zip(*np.nonzero(moved)):
        wa = (si, ga[si, t, u], t, la[si, t, u], u)   # CPU's winner
        wb = (si, gb[si, t, u], t, lb[si, t, u], u)   # the card's winner
        # what each run loses, on its own surface, by taking the other's
        gaps.append(max(float(a.surf_loss[wb]) - float(a.surf_loss[wa]),
                        float(b.surf_loss[wa]) - float(b.surf_loss[wb]))
                    / share[si])
    emit({"phase": "small_fit", "n": SMALL_N, "cells": a.plan.n_cells,
          "k_max": a.plan.k_max, "cpu_s": t1 - t0, "card_s": t2 - t1,
          "plans_equal": True, "fold_masks_equal": True,
          "surface_max_abs_diff": float(diff.max()),
          "surface_mean_abs_diff": float(diff.mean()),
          "surface_max_flipped_samples": float(flips_eq.max()),
          "surface_flip_limit": per_col.tolist(),
          "selections": int(moved.size), "selection_flips": int(moved.sum()),
          "flip_gaps_in_samples": gaps,
          "iters_cpu_median": float(np.median(a.iters)),
          "iters_card_median": float(np.median(b.iters)),
          "ok": ok_surf and all(g <= 1.0 + 1e-3 for g in gaps)})
    if not ok_surf:
        raise Mismatch("small fit: surfaces differ by more than "
                       f"{FLIP_SHARE} of a column's validation samples")
    if any(g > 1.0 + 1e-3 for g in gaps):
        raise Mismatch(f"small fit: a selection flip costs {max(gaps)} "
                       f"validation samples (limit 1)")


def full_fit(torch, dev, data, LiquidSVM, SVMTrainerConfig, tables,
             cell_trainer, obs):
    """The training main path at full width: fit with the launch counts
    of every wave read at the wave's end, then the test phase."""
    x, y, xt, yt = data
    cfg = SVMTrainerConfig(**TRAIN_CFG)
    model = LiquidSVM(cfg, device=dev)
    per_wave = []
    solve_wave = cell_trainer.train_cells

    def counted_wave(*args, **kwargs):
        zero_counts(tables)
        out = solve_wave(*args, **kwargs)
        per_wave.append(read_counts(tables))
        return out

    obs.tracer.clear()
    obs.tracer.enabled = True
    cell_trainer.train_cells = counted_wave
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.fit(x, y)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
    finally:
        cell_trainer.train_cells = solve_wave
        obs.tracer.enabled = False
    # device time per wave and per stage, from the spans' CUDA events
    stage_ms = {row["attrs"]["wave"]: {k.removeprefix("train."): v
                                       for k, v in row.items()
                                       if k != "attrs"}
                for row in obs.tracer.breakdown_ms("train.wave")}
    obs.tracer.clear()
    tr = model.train_result
    n_gamma = tr.gammas_cells.shape[1]
    expect = {"sq_dists_sym": 1, "gram_from_d2": n_gamma,
              "cd_wave_epoch": cfg.cd_polish * n_gamma}
    for w, counts in enumerate(per_wave):
        require_launches(f"fit wave {w}", counts, expect)
    fit_counts = {k: sum(c[k] for c in per_wave) for k in per_wave[0]}
    n_waves = -(-tr.packed.n_slots // cfg.n_slots_per_wave)
    if len(per_wave) != n_waves:
        raise Mismatch(f"fit ran {len(per_wave)} waves, expected {n_waves}")
    live = tr.mask_cells.sum(-1) > 0
    it = tr.iters[live]
    # the batched loop runs until the wave's slowest (slot, fold) stops
    spw = cfg.n_slots_per_wave
    loop_iters = [int(tr.iters[w * spw:(w + 1) * spw].max(axis=(0, 2)).sum())
                  for w in range(n_waves)]
    emit({"phase": "train_fit", "n": x.shape[0], "d": x.shape[1],
          "cells": tr.plan.n_cells, "k_max": tr.plan.k_max,
          "slots": tr.packed.n_slots, "waves": len(per_wave),
          "slots_per_wave": cfg.n_slots_per_wave, "folds": cfg.n_folds,
          "columns": int(tr.lambdas.size * tr.tasks.n_tasks),
          "gammas": n_gamma, "seconds": fit_s,
          "wave_ms": {w: v.get("wave") for w, v in stage_ms.items()},
          "stage_ms": stage_ms, "launches_per_wave": per_wave,
          "fista_iters": {"min": int(it.min()), "median": float(np.median(it)),
                          "max": int(it.max()),
                          "solves": int(it.size),
                          "at_max_iters": int((it >= cfg.max_iters).sum()),
                          "loop_iters_per_wave": loop_iters,
                          "fista_ms_per_loop_iter": [
                              stage_ms[w]["fista"] / loop_iters[w]
                              for w in range(n_waves)]},
          "matmul_precision": torch.get_float32_matmul_precision(),
          "allow_tf32": torch.backends.cuda.matmul.allow_tf32})

    # test phase through decision_function (B1 + B2 + one product)
    zero_counts(tables)
    dec_df = model.decision_function(xt)
    err_df = model.error(xt, yt)
    test_counts = read_counts(tables)
    if not (test_counts["sq_dists"] and test_counts["gram_from_d2"]) or any(
            n for k, n in test_counts.items()
            if k not in ("sq_dists", "gram_from_d2")):
        raise Mismatch(f"decision_function launched {test_counts}; it "
                       f"launches B1 and B2 only")
    return model, fit_counts, test_counts, dec_df, err_df


def serve_trained(torch, dev, model, xt, yt, dec_df, err_df, SVMEngine,
                  tables, refs):
    """The fitted model compacted by ``to_bank`` and served by the port's
    engine: its decisions and those of ``decision_function`` each within
    ``predict_bound`` of the plain end-to-end reference, and within twice
    it of each other; both errors below the majority-class rate."""
    bank = model.to_bank()
    eng = SVMEngine(bank, device=dev, fused=True)
    zero_counts(tables)
    dec_eng, _ = serve(eng, xt)
    serve_counts = read_counts(tables)
    if serve_counts["svm_predict_cells"] == 0:
        raise Mismatch("trained bank: the engine launched no B3")
    want, bnd = plain_decisions(bank, xt, False, dev, **refs)
    if dec_df.shape != want.shape or not np.isfinite(dec_df).all():
        raise Mismatch(f"decision_function: shape {dec_df.shape} vs "
                       f"{want.shape} or non-finite decisions")
    check_bound("train[decision_function] vs plain", dec_df, want, bnd)
    check_bound("train[engine] vs plain", dec_eng, want, bnd)
    check_bound("train[engine] vs decision_function", dec_eng, dec_df,
                2 * bnd)
    classes = np.asarray(bank.classes)
    err_eng = float((classes[dec_eng[:, :, 0].argmax(1)] != yt).mean())
    majority = float(np.bincount(yt.astype(np.int64)).max() / yt.size)
    emit({"phase": "train_test", "heldout": int(yt.size),
          "error_decision_function": err_df, "error_engine": err_eng,
          "majority_share": majority, "majority_baseline_error": 1 - majority,
          "bank": bank.stats(), "launches": serve_counts})
    # below the majority class's share of the held-out rows, and so far
    # below the error of always predicting that class (1 - share)
    if not (err_df < majority and err_eng < majority):
        raise Mismatch(f"test error {err_df} / {err_eng} not below the "
                       f"majority-class rate {majority}")
    return serve_counts


def b5_entry(torch, dev, model, tables):
    """``cd_epochs`` (B5's entry point) polishing one fitted cell's model:
    all tasks at their selected (gamma, lambda), from the fold-averaged
    coefficients clipped into the box.  Launches counted on their own;
    the dual objective must not rise (monotone from a feasible start)."""
    from repro_torch.kernels.cd_solver import ops as cd_ops
    from repro_torch.kernels.kernel_matrix import ops as km_ops
    tr = model.train_result
    slot = int(np.argmax(tr.mask_cells.sum(-1)))
    # the tasks that selected the same gamma as task 0 share one Gram
    g = float(model.gamma[slot, 0, 0])
    tasks = np.nonzero(model.gamma[slot, :, 0] == g)[0]
    m = torch.as_tensor(tr.mask_cells[slot]).to(dev)
    x = torch.as_tensor(tr.x_cells[slot]).to(dev)
    kk = km_ops.gram_from_d2(km_ops.sq_dists(x, x, symmetric=True), g)
    y = torch.as_tensor(tr.y_cells[slot][tasks].T.copy()).to(dev)  # (k, P)
    lam = torch.as_tensor(model.lam[slot, tasks, 0]).to(dev)         # (P,)
    cost = 1.0 / (2.0 * lam * m.sum().clamp(min=1.0))
    edge = y * cost[None, :] * m[:, None]
    lo, hi = edge.clamp(max=0.0), edge.clamp(min=0.0)
    c0 = torch.clamp(
        torch.as_tensor(model.coefs[slot][:, tasks, 0].copy()).to(dev),
        min=lo, max=hi)

    def dual(c):
        return (0.5 * (c * (kk @ c)).sum(0) - (c * y).sum(0)).double()

    torch.cuda.synchronize()
    zero_counts(tables)
    c = cd_ops.cd_epochs(kk, y, lo, hi, c0, epochs=CD_EPOCHS)
    counts = read_counts(tables)
    require_launches("cd_epochs", counts, {"cd_epoch": CD_EPOCHS})
    before, after = dual(c0), dual(c)
    rise = float((after - before).max())
    tol = 1e-5 * float(before.abs().max())
    emit({"phase": "b5_entry", "slot": slot, "k": int(m.sum()),
          "columns": int(y.shape[1]), "epochs": CD_EPOCHS,
          "objective_before": before.tolist(),
          "objective_after": after.tolist(), "max_rise": rise,
          "launches": counts, "ok": bool(rise <= tol)})
    if rise > tol or not torch.isfinite(c).all():
        raise Mismatch(f"cd_epochs raised the dual objective by {rise}")
    return counts


def fista_profile(torch, prob):
    """Device busy share of the batched FISTA loop, which takes ~95 % of
    the fit: ``torch.profiler`` over FISTA_PROFILE_ITERS iterations at the
    training wave's shapes (the kernel-check problem), beside the time of
    its K·C product alone.  The profiler slows the host, so the share is
    a lower bound."""
    from repro_torch.core.solvers import base as qp
    from repro_torch.kernels.cd_solver import ops as cd_ops
    _, kk, c0, g0, lo, hi = prob
    y = cd_ops.slot_matmul(kk, c0) - g0
    l_est = qp.power_iteration_l(kk)

    def run():
        return qp.box_qp_batched(kk, y, lo, hi, c0=c0, tol=0.0,
                                 max_iters=FISTA_PROFILE_ITERS, l_est=l_est)

    run()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # the kernels' own rows: an operator's row repeats its kernels' time
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    dev_ms = sum(dev_us(e) for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -dev_us(e))[:6]
    emit({"phase": "fista_profile", "iters": FISTA_PROFILE_ITERS,
          "wall_ms": wall_ms, "device_ms": dev_ms,
          "device_busy_share": dev_ms / wall_ms if dev_ms else None,
          "top_kernels_ms": {e.key[:60]: dev_us(e) / 1e3 for e in top},
          "kc_product_ms": cuda_ms(torch, lambda: cd_ops.slot_matmul(kk, c0),
                                   iters=10)})


# ------------------------------------------------------------ LM slice
def attn_tol(want) -> float:
    """Kernel vs plain attention on one card: f32 sums of the same products
    in another order, 2e-5 on values ~1.  In bf16 the kernel also rounds P
    to bf16 before P V (at most 2^-8 of each p), and both sides round the
    output once, which may land one bf16 ulp (2^-7 relative) apart: one
    bound for the whole tensor, scaled by its largest value
    (``attn_err_bound`` holds each value to its own share)."""
    import torch
    if want.dtype == torch.bfloat16:
        return 2.0 ** -7 * max(1.0, float(want.float().abs().max()))
    return 2e-5 * max(1.0, float(want.abs().max()))


def attn_err_bound(fa_ref, q, k, v, kind: str, win: int, want):
    """Elementwise bound on |bf16 kernel - plain| for one output value o =
    sum_j p_j v_j / l: the two output roundings, 2^-8 |o| each, and P
    rounded to bf16, 2^-8 p_j each, which moves o by at most 2^-8 A with
    A = sum_j p_j |v_j| / l (the plain attention of |v|, in f32); 2^-14 A
    covers the f32 sums' order and ex2.approx."""
    a = fa_ref.flash_attention_ref(q.float(), k.float(), v.float().abs(),
                                   kind, win)
    return 2.0 ** -7 * want.float().abs() + (2.0 ** -8 + 2.0 ** -14) * a


def lm_kernel_checks(torch, dev, cfg):
    """B9 and B10 against their plain versions on the card: every mask
    kind, GQA groups 1 and 2, head_dim 64 and 256, T != S, ragged T, bf16
    and f32; B10 with bf16 and int8 caches, a partial cache, a wrapped
    ring (cache_pos >= S), a window, and split over the keys (B = 1 at
    S = 32768; a window over a wrapped ring at B = 1).  The first case of each is the LM
    path's own shape; its error goes into the kernel table."""
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.kernels.decode_attention import ref as dec_ref
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    gen = torch.Generator().manual_seed(SEED)
    bf16, f32 = torch.bfloat16, torch.float32
    errs = {}
    for i, (kind, win, b, t, s, h, hk, d, dt) in enumerate((
            ("causal", 0, LM_BATCH, LM_SEQ, LM_SEQ, cfg.n_heads,
             cfg.n_kv_heads, cfg.head_dim, bf16),
            ("causal", 0, 2, 100, 300, 8, 4, 64, f32),
            ("window", 128, 1, 333, 333, 8, 4, 256, bf16),
            ("window", 64, 2, 200, 450, 4, 4, 64, f32),
            ("bidir", 0, 2, 77, 77, 4, 2, 256, f32),
            ("bidir", 0, 2, 40, 90, 4, 4, 64, bf16))):
        q = torch.randn(b, t, h, d, generator=gen).to(dev, dt)
        k = torch.randn(b, s, hk, d, generator=gen).to(dev, dt)
        v = torch.randn(b, s, hk, d, generator=gen).to(dev, dt)
        got = fa_ops.flash_attention(q, k, v, kind, win)
        want = fa_ref.flash_attention_ref(q, k, v, kind, win)
        torch.cuda.synchronize()
        label = (f"flash_attention[{kind},w={win},B={b},T={t},S={s},H={h},"
                 f"Hk={hk},D={d},{str(dt)[6:]}]")
        e = check(label, float((got.float() - want.float()).abs().max()),
                  attn_tol(want))
        if dt == bf16:
            check_bound(label + "[elementwise]", got.float().cpu(),
                        want.float().cpu(),
                        attn_err_bound(fa_ref, q, k, v, kind, win, want).cpu())
        if i == 0:
            errs["flash_attention"] = e
    for i, (b, s, hk, g, d, quant, pos, win) in enumerate((
            (GEN_BATCH, GEN_PROMPT + GEN_NEW, cfg.n_kv_heads, 1,
             cfg.head_dim, False, GEN_PROMPT + GEN_NEW - 1, 0),
            (GEN_BATCH, GEN_PROMPT + GEN_NEW, cfg.n_kv_heads, 1,
             cfg.head_dim, True, GEN_PROMPT + GEN_NEW - 1, 0),
            (4, 300, 8, 2, 256, False, 120, 0),
            (4, 300, 8, 2, 256, True, 700, 0),
            (2, 400, 4, 2, 256, False, 900, 128),
            (2, 257, 4, 1, 64, True, 200, 64),
            # the split over the keys: B = 1 at long context, and gemma3-4b's
            # local layers (window 1024) over a wrapped ring
            (1, LONG_B10_ONE[1], cfg.n_kv_heads, 1, cfg.head_dim, False,
             LONG_B10_ONE[1] - 1, 0),
            (1, 5000, 2, 2, 256, True, 12000, 1024))):
        q = torch.randn(b, hk, g, d, generator=gen).to(dev, bf16)
        k = torch.randn(b, s, hk, d, generator=gen)
        v = torch.randn(b, s, hk, d, generator=gen)
        ks = vs = None
        if quant:
            ks = k.abs().amax(-1, keepdim=True).div(127.0).clamp(min=1e-10)
            vs = v.abs().amax(-1, keepdim=True).div(127.0).clamp(min=1e-10)
            k = torch.round(k / ks).clamp(-127, 127).to(torch.int8)
            v = torch.round(v / vs).clamp(-127, 127).to(torch.int8)
            ks, vs = ks.to(dev), vs.to(dev)
        k, v = k.to(dev, torch.int8 if quant else bf16), \
            v.to(dev, torch.int8 if quant else bf16)
        got = dec_ops.decode_attention_fused(q, k, v, pos, d ** -0.5, ks, vs,
                                             window=win)
        want = dec_ref.decode_attention_ref(q, k, v, pos, d ** -0.5, ks, vs,
                                            win)
        torch.cuda.synchronize()
        e = check(f"decode_attention[B={b},S={s},Hk={hk},G={g},D={d},"
                  f"{'int8' if quant else 'bf16'},pos={pos},w={win}]",
                  float((got.float() - want.float()).abs().max()),
                  attn_tol(want))
        if i == 0:
            errs["decode_attention"] = e
    return errs


def lm_corpus(vocab: int, seed: int = SEED):
    """Three token domains: every token of a class-c sequence is drawn,
    Zipf-weighted over LM_DOMAIN ids, from class c's own slice of the
    vocabulary, or with probability LM_SHARED from a slice all classes
    share.  Returns train tokens, labels, held-out tokens, labels
    (classes 0, 1, 2; rows shuffled)."""
    rng = np.random.default_rng(seed)
    w = 1.0 / np.arange(1, LM_DOMAIN + 1) ** LM_ZIPF
    w /= w.sum()
    perm = rng.permutation(vocab)
    shared = perm[:LM_DOMAIN]
    n = LM_TRAIN_PER_CLASS + LM_HELD_PER_CLASS
    tok, lab = [], []
    for c in range(LM_CLASSES):
        own = perm[(c + 1) * LM_DOMAIN:(c + 2) * LM_DOMAIN]
        pick_own = own[rng.choice(LM_DOMAIN, size=(n, LM_SEQ), p=w)]
        pick_shared = shared[rng.choice(LM_DOMAIN, size=(n, LM_SEQ), p=w)]
        tok.append(np.where(rng.random((n, LM_SEQ)) < LM_SHARED, pick_shared,
                            pick_own))
        lab.append(np.full(n, c, np.float32))
    tok, lab = np.stack(tok), np.stack(lab)
    cut = LM_TRAIN_PER_CLASS
    x_tr, y_tr = tok[:, :cut].reshape(-1, LM_SEQ), lab[:, :cut].reshape(-1)
    x_ho, y_ho = tok[:, cut:].reshape(-1, LM_SEQ), lab[:, cut:].reshape(-1)
    p_tr, p_ho = rng.permutation(len(y_tr)), rng.permutation(len(y_ho))
    return (x_tr[p_tr].astype(np.int32), y_tr[p_tr],
            x_ho[p_ho].astype(np.int32), y_ho[p_ho])


def lm_embed(torch, dev, cfg, corpus, tables, obs):
    """Embedding at full width: the seed-initialised backbone on the card,
    one block through B9 against the plain attention, the corpus through
    write-through caches (24 B9 launches a block, no B10), a second pass
    that replays the shards (no launches, the same bits), and rows
    bitwise the same under two chunk sizes and in a ragged tail block."""
    import dataclasses
    import shutil
    from repro_torch.embed import EmbeddingExtractor, EmbeddingSource
    x_tr, y_tr, x_ho, _ = corpus
    t0 = time.perf_counter()
    ex = EmbeddingExtractor(cfg, batch_size=LM_BATCH, seed=SEED, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    digest = ex.digest()
    digest_s = time.perf_counter() - t0

    blk = x_tr[:LM_BATCH]
    zero_counts(tables)
    e_kern = ex(blk)
    require_launches("embed block", read_counts(tables),
                     {"flash_attention": cfg.n_layers})
    plain = EmbeddingExtractor(dataclasses.replace(cfg, attn_impl="ref"),
                               ex.params, batch_size=LM_BATCH, device=dev)
    zero_counts(tables)
    e_plain = plain(blk)
    require_launches("embed block, plain attention", read_counts(tables), {})
    scale = float(np.abs(e_plain).max())
    diff = np.abs(e_kern.astype(np.float64) - e_plain)
    check("lm_embed[B9 vs plain attention, one block]", float(diff.max()),
          LM_EMBED_TOL * scale, max_abs_value=scale,
          mean_abs_err=float(diff.mean()))
    del plain

    root = ROOT / "build" / "chip_smoke_embed"
    shutil.rmtree(root, ignore_errors=True)
    obs.tracer.clear()
    obs.tracer.enabled = True
    zero_counts(tables)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    src_tr = EmbeddingSource(x_tr, ex, cache=str(root / "train"),
                             labels=y_tr)
    emb_tr = src_tr.materialize()
    src_ho = EmbeddingSource(x_ho, ex, cache=str(root / "held"))
    emb_ho = src_ho.materialize()
    cold_s = time.perf_counter() - t0
    obs.tracer.enabled = False
    cold = read_counts(tables)
    n_blocks = src_tr.n_blocks + src_ho.n_blocks
    require_launches("embed cold pass", cold,
                     {"flash_attention": cfg.n_layers * n_blocks})
    fwd = [sp.elapsed_ms for sp in obs.tracer.spans
           if sp.name == "embed.forward"]
    obs.tracer.clear()
    if not (src_tr.cache_complete() and src_ho.cache_complete()):
        raise Mismatch("embed: the caches did not seal after the cold pass")
    if not (np.isfinite(emb_tr).all() and np.isfinite(emb_ho).all()):
        raise Mismatch("embed: non-finite embeddings")

    zero_counts(tables)
    t0 = time.perf_counter()
    warm_tr = EmbeddingSource(x_tr, ex, cache=str(root / "train"),
                              labels=y_tr)
    warm_ho = EmbeddingSource(x_ho, ex, cache=str(root / "held"))
    replay = (warm_tr.materialize(), warm_ho.materialize())
    warm_s = time.perf_counter() - t0
    warm = read_counts(tables)
    require_launches("embed replay", warm, {})
    if not (warm_tr.cache_complete() and np.array_equal(replay[0], emb_tr)
            and np.array_equal(replay[1], emb_ho)):
        raise Mismatch("embed: the replayed shards differ from the cold pass")

    # 150 rows: 4 full blocks and a 22-row tail padded with zero sequences
    sub_a = EmbeddingSource(x_tr[:150], ex)
    rows_a = np.concatenate([c for _, c in sub_a.iter_chunks(48)])
    sub_b = EmbeddingSource(x_tr[:150], ex)
    rows_b = np.concatenate([c for _, c in sub_b.iter_chunks(100)])
    invariant = bool(np.array_equal(rows_a, rows_b)
                     and np.array_equal(rows_a, emb_tr[:150]))
    n_seq = len(x_tr) + len(x_ho)
    emit({"phase": "lm_embed", "arch": cfg.name, "layers": cfg.n_layers,
          "d_model": cfg.d_model, "params": cfg.param_count(),
          "dtype": str(cfg.dtype), "seq_len": LM_SEQ, "batch": LM_BATCH,
          "sequences": n_seq, "blocks": n_blocks, "init_s": init_s,
          "params_digest": digest, "digest_s": digest_s,
          "cold_s": cold_s, "sequences_per_s": n_seq / cold_s,
          "tokens_per_s": n_seq * LM_SEQ / cold_s,
          "forward_device_ms_per_block": float(np.mean(fwd)),
          "forward_device_share": float(np.sum(fwd)) / (cold_s * 1e3),
          "replay_s": warm_s, "launches_cold": cold,
          "launches_replay": warm, "rows_bitwise_invariant": invariant,
          "ok": invariant})
    if not invariant:
        raise Mismatch("embed: rows differ between chunk sizes or blocks")
    return ex, src_tr, src_ho, cold


def lm_svm_head(torch, dev, ex, src_tr, src_ho, corpus, tables, refs):
    """The SVM head on the cached embeddings: SVM(y=None) takes the labels
    from the source; held-out error against chance; the bank served
    through EmbedServe on the held-out tokens (the backbone runs again).
    Returns the fit's and the serving run's launch counts and B3's
    operands at the run's most frequent wave shape (the LM head's wave)."""
    from repro_torch.api.session import SVM
    from repro_torch.serve import EmbedServe, SVMEngine
    from repro_torch.train.svm_trainer import SVMTrainerConfig
    _, _, x_ho, y_ho = corpus
    cfg = SVMTrainerConfig(**LM_SVM_CFG)
    zero_counts(tables)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sess = SVM(src_tr, None, cfg, device=dev)
    sel = sess.train().select()
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fit_counts = read_counts(tables)
    if fit_counts["flash_attention"] or fit_counts["decode_attention"]:
        raise Mismatch(f"SVM fit ran the backbone: {fit_counts}")
    res = sel.test(src_ho, y_ho)
    emb_ho = src_ho.materialize()
    dec_df = sel.decision_function(emb_ho)
    bank = sel.to_bank()
    srv = EmbedServe(SVMEngine(bank, device=dev), ex)
    zero_counts(tables)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    served = srv.run_tokens(x_ho[i:i + LM_BATCH]
                            for i in range(0, len(x_ho), LM_BATCH))
    serve_s = time.perf_counter() - t0
    srv_counts = read_counts(tables)
    n_blocks = -(-len(x_ho) // LM_BATCH)
    if (srv_counts["flash_attention"] != ex.cfg.n_layers * n_blocks
            or srv_counts["decode_attention"]
            or not srv_counts["svm_predict_cells"]):
        raise Mismatch(f"EmbedServe launched {srv_counts}; it runs B9 "
                       f"{ex.cfg.n_layers} times a block and B3")
    if sorted(served) != list(range(len(x_ho))):
        raise Mismatch("EmbedServe: not every request was served")
    # B3's operands at the run's most frequent wave shape: held-out rows
    # packed into (n_slots, m_pad) slots of cells 0, 1, ...
    waves = collections.Counter((r["n_slots"], r["m_pad"])
                                for r in srv.engine.wave_stats)
    (n_s, m_p), _ = waves.most_common(1)[0]
    xt_h = emb_ho[np.arange(n_s * m_p) % len(emb_ho)].astype(np.float32)
    head_wave = {"args": srv.engine.launch_operands(
                     xt_h.reshape(n_s, m_p, -1),
                     np.arange(n_s, dtype=np.int64) % bank.n_cells),
                 "kind": bank.kernel,
                 "waves": {f"{s}x{m}": n for (s, m), n in waves.items()}}
    dec_srv = np.stack([served[i] for i in range(len(x_ho))])
    gap = 0.0
    for rid in range(len(x_ho)):
        b = srv.breakdown(rid)
        parts = (b["embed_ms"] + b["queue_ms"] + b["pack_ms"]
                 + b["dispatch_ms"] + b["device_ms"] + b["collect_ms"])
        gap = max(gap, abs(parts - b["total_ms"]))
    want, bnd = plain_decisions(bank, emb_ho, False, dev, **refs)
    check_bound("lm[decision_function] vs plain", dec_df, want, bnd)
    check_bound("lm[EmbedServe] vs plain", dec_srv, want, bnd)
    check_bound("lm[EmbedServe] vs decision_function", dec_srv, dec_df,
                2 * bnd)
    chance = 1.0 - 1.0 / LM_CLASSES
    st = srv.stats()
    emit({"phase": "lm_svm_head", "n_train": src_tr.n_rows,
          "n_heldout": len(y_ho), "d": src_tr.dim,
          "cells": sel.plan.n_cells, "k_max": sel.plan.k_max,
          "fit_s": fit_s, "heldout_error": res.error,
          "chance_error": chance, "serve_s": serve_s,
          "requests_per_s": len(x_ho) / serve_s,
          "per_stage_mean_ms": {k: v["mean_ms"]
                                for k, v in st["per_stage"].items()},
          "breakdown_max_gap_ms": gap, "launches_fit": fit_counts,
          "launches_serve": srv_counts,
          "b3_waves_slots_x_rows": head_wave["waves"],
          "ok": bool(res.error < chance and gap <= 1e-6)})
    if not res.error < chance:
        raise Mismatch(f"held-out error {res.error} not below chance "
                       f"{chance}")
    if gap > 1e-6:
        raise Mismatch(f"EmbedServe breakdowns miss total_ms by {gap} ms")
    return fit_counts, srv_counts, head_wave


def lm_generate(torch, dev, cfg, params, prompt, tables):
    """Generation at full width, bf16 then int8 cache: launches (B9 once a
    layer in the prefill, B10 once a layer per decode step, B9 never while
    decoding), first-step logits against the plain path, ms per decode
    step and tokens/s."""
    import dataclasses
    from repro_torch.serve import engine
    from repro_torch.serve.kv_cache import pad_cache
    runs = {}
    for kv in ("bf16", "int8"):
        c = dataclasses.replace(cfg, kv_cache_dtype=kv)
        plain = dataclasses.replace(c, attn_impl="ref")
        zero_counts(tables)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks = engine.generate(c, params, prompt, GEN_NEW)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        counts = read_counts(tables)
        require_launches(f"generate[{kv}]", counts, {
            "flash_attention": c.n_layers,
            "decode_attention": c.n_layers * (GEN_NEW - 1)})
        if (toks.shape != (GEN_BATCH, GEN_PROMPT + GEN_NEW)
                or not torch.equal(toks[:, :GEN_PROMPT], prompt.int())
                or int(toks.min()) < 0 or int(toks.max()) >= c.vocab):
            raise Mismatch(f"generate[{kv}]: bad tokens {tuple(toks.shape)}")
        t0 = time.perf_counter()
        logits, cache = engine.prefill_step(c, params, prompt)
        cache = pad_cache(c, cache, GEN_PROMPT + GEN_NEW)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        first = logits.argmax(-1)[:, None].to(torch.int32)
        step1, _ = engine.serve_step(c, params, first, cache, GEN_PROMPT)
        logits_p, cache_p = engine.prefill_step(plain, params, prompt)
        cache_p = pad_cache(plain, cache_p, GEN_PROMPT + GEN_NEW)
        step1_p, _ = engine.serve_step(plain, params, first, cache_p,
                                       GEN_PROMPT)
        toks_p = engine.generate(plain, params, prompt, GEN_NEW)
        torch.cuda.synchronize()
        scale = float(logits_p.abs().max())
        e_pre = float((logits - logits_p).abs().max())
        e_step = float((step1 - step1_p).abs().max())
        check(f"generate[{kv}] prefill logits vs plain", e_pre,
              LM_LOGIT_TOL * scale, max_abs_logit=scale)
        check(f"generate[{kv}] first decode-step logits vs plain", e_step,
              LM_LOGIT_TOL * float(step1_p.abs().max()))
        new = slice(GEN_PROMPT, None)
        runs[kv] = {
            "seconds": gen_s, "prefill_s": prefill_s,
            "decode_ms_per_step": (gen_s - prefill_s) * 1e3 / (GEN_NEW - 1),
            "tokens_per_s": GEN_BATCH * GEN_NEW / gen_s,
            "decode_tokens_per_s": GEN_BATCH * (GEN_NEW - 1)
            / (gen_s - prefill_s),
            "greedy_agreement_with_plain": float(
                (toks[:, new] == toks_p[:, new]).float().mean()),
            "first_token_agreement": float(
                (toks[:, GEN_PROMPT] == toks_p[:, GEN_PROMPT]).float().mean()),
            "logits_err_prefill": e_pre, "logits_err_step1": e_step,
            "launches": counts}
    emit({"phase": "lm_generate", "arch": cfg.name, "batch": GEN_BATCH,
          "prompt": GEN_PROMPT, "new_tokens": GEN_NEW,
          "bf16_reduced_precision_reduction":
              torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction,
          **runs})
    return {name: sum(r["launches"][name] for r in runs.values())
            for name in runs["bf16"]["launches"]}


def lm_decode_profile(torch, dev, cfg, params, prompt, steps: int = 4):
    """Where a decode step's time goes (bf16 cache): ``torch.profiler``
    over ``steps`` steps after two warm ones; the device's busy share of
    the window, its kernels by time, and the host's operators by their
    own time.  The profiler slows the host, so the share is a lower
    bound."""
    from repro_torch.serve import engine
    from repro_torch.serve.kv_cache import pad_cache
    logits, cache = engine.prefill_step(cfg, params, prompt)
    cache = pad_cache(cfg, cache, GEN_PROMPT + GEN_NEW)
    tok = logits.argmax(-1)[:, None].to(torch.int32)
    pos = GEN_PROMPT
    for _ in range(2):
        logits, cache = engine.serve_step(cfg, params, tok, cache, pos)
        pos += 1
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            logits, cache = engine.serve_step(cfg, params, tok, cache, pos)
            pos += 1
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    for _ in range(steps):
        logits, cache = engine.serve_step(cfg, params, tok, cache, pos)
        pos += 1
    torch.cuda.synchronize()
    plain_wall_ms = (time.perf_counter() - t0) * 1e3

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    ev = prof.key_averages()
    kernels = [e for e in ev
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(dev_us(e) for e in kernels) / 1e3
    host = sorted((e for e in ev
                   if e.device_type != torch.autograd.DeviceType.CUDA),
                  key=lambda e: -e.self_cpu_time_total)[:10]
    emit({"phase": "lm_decode_profile", "steps": steps,
          "wall_ms_per_step": wall_ms / steps,
          "unprofiled_wall_ms_per_step": plain_wall_ms / steps,
          "device_ms_per_step": dev_ms / steps,
          "device_busy_share": dev_ms / wall_ms,
          "top_kernels_ms_per_step": {
              e.key[:60]: dev_us(e) / 1e3 / steps
              for e in sorted(kernels, key=lambda e: -dev_us(e))[:8]},
          "top_host_ops_ms_per_step": {
              e.key[:60]: e.self_cpu_time_total / 1e3 / steps for e in host},
          "host_op_calls_per_step": sum(
              e.count for e in ev
              if e.device_type != torch.autograd.DeviceType.CUDA
              and e.key.startswith("aten::")) / steps})


def lm_smoke_tokens(torch, dev, tables):
    """At the smoke configs in f32: greedy tokens through B9/B10 equal the
    plain path's, with a bf16 (here: f32) and an int8 cache."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.models import model as model_mod
    from repro_torch.serve import engine
    out = {}
    for arch in ("stablelm-1.6b", "gemma3-4b"):
        for kv in ("bf16", "int8"):
            cfg = dataclasses.replace(get_arch(arch).smoke,
                                      dtype=torch.float32, kv_cache_dtype=kv)
            params = model_mod.init_params(
                cfg, torch.Generator(device=dev).manual_seed(SEED))
            prompt = torch.randint(
                0, cfg.vocab, (4, 24),
                generator=torch.Generator().manual_seed(SEED)).to(dev)
            zero_counts(tables)
            got = engine.generate(cfg, params, prompt, 16)
            require_launches(f"smoke generate[{arch},{kv}]",
                             read_counts(tables),
                             {"flash_attention": cfg.n_layers,
                              "decode_attention": cfg.n_layers * 15})
            want = engine.generate(dataclasses.replace(cfg, attn_impl="ref"),
                                   params, prompt, 16)
            same = bool(torch.equal(got, want))
            out[f"{arch},{kv}"] = same
            if not same:
                raise Mismatch(f"smoke generate[{arch},{kv}]: tokens through "
                               f"the kernels differ from the plain path's")
    emit({"phase": "lm_smoke_tokens", "identical": out, "ok": True})


def attn_bound(torch, b, t, s, h, hk, d, kind, window, esize):
    """B9's least time: q, k, v read and o written once, or 4 D operations
    per visible (row, column) pair and head at the bf16 tensor-core peak."""
    from repro_torch.kernels.flash_attention.ref import attention_mask
    pairs = int(attention_mask(t, s, kind, window).sum())
    return bound(esize * (2 * b * t * h * d + 2 * b * s * hk * d),
                 4 * d * pairs * b * h, BF16_FLOP_PER_S)


def lm_timing_cases(torch, dev, cfg):
    """B9 and B10 at the LM path's shapes and at long contexts (B10 at B =
    16 and B = 1, bf16 and int8):
    (label, kernel, plain, library call or None, (bound ms, by))."""
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.kernels.decode_attention import ref as dec_ref
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    gen = torch.Generator(device=dev).manual_seed(SEED)
    bf16 = torch.bfloat16
    cases = []
    h, d = cfg.n_heads, cfg.head_dim
    for label, (b, t) in (("flash_attention", (LM_BATCH, LM_SEQ)),
                          ("flash_attention[B=%d,T=S=%d]" % LONG_B9,
                           LONG_B9)):
        q, k, v = (torch.randn(b, t, h, d, generator=gen, device=dev,
                               dtype=bf16) for _ in range(3))
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        cases.append((
            label,
            lambda q=q, k=k, v=v: fa_ops.flash_attention(q, k, v, "causal"),
            lambda q=q, k=k, v=v: fa_ref.flash_attention_ref(q, k, v,
                                                             "causal"),
            lambda q=qt, k=kt, v=vt: F.scaled_dot_product_attention(
                q, k, v, is_causal=True),
            attn_bound(torch, b, t, t, h, h, d, "causal", 0, 2)))
    hk = cfg.n_kv_heads
    for label, (b, s, quant) in (
            ("decode_attention", (GEN_BATCH, GEN_PROMPT + GEN_NEW, False)),
            ("decode_attention[int8]", (GEN_BATCH, GEN_PROMPT + GEN_NEW,
                                        True)),
            ("decode_attention[B=%d,S=%d]" % LONG_B10, LONG_B10 + (False,)),
            ("decode_attention[B=%d,S=%d,int8]" % LONG_B10,
             LONG_B10 + (True,)),
            ("decode_attention[B=%d,S=%d]" % LONG_B10_ONE,
             LONG_B10_ONE + (False,)),
            ("decode_attention[B=%d,S=%d,int8]" % LONG_B10_ONE,
             LONG_B10_ONE + (True,))):
        g = h // hk
        q = torch.randn(b, hk, g, d, generator=gen, device=dev, dtype=bf16)
        k = torch.randn(b, s, hk, d, generator=gen, device=dev, dtype=bf16)
        v = torch.randn(b, s, hk, d, generator=gen, device=dev, dtype=bf16)
        ks = vs = None
        lib = None
        if quant:
            from repro_torch.models.attention import quantize_kv
            (k, ks), (v, vs) = quantize_kv(k), quantize_kv(v)
        else:
            kt, vt = (x.transpose(1, 2).contiguous() for x in (k, v))
            lib = (lambda q=q, k=kt, v=vt: F.scaled_dot_product_attention(
                q, k, v, enable_gqa=g > 1))
        pos = s - 1
        cache_bytes = 2 * b * s * hk * d * k.element_size() + (
            2 * b * s * hk * 4 if quant else 0)
        cases.append((
            label,
            lambda q=q, k=k, v=v, ks=ks, vs=vs, pos=pos, d=d:
                dec_ops.decode_attention_fused(q, k, v, pos, d ** -0.5, ks,
                                               vs),
            lambda q=q, k=k, v=v, ks=ks, vs=vs, pos=pos, d=d:
                dec_ref.decode_attention_ref(q, k, v, pos, d ** -0.5, ks, vs),
            lib,
            bound(cache_bytes + 2 * q.numel() * 2, 0)))
    return cases


def assign_flips(label: str, x: np.ndarray, c: np.ndarray, got, want
                 ) -> int:
    """Rows whose owner differs between two assignments must be near-ties:
    if each side computes D² within dd2 of the true value (B1's 64 ulps
    of the largest |x|^2 + |c|^2, the GEMM form's error over d terms),
    the one center is at most 2 dd2 farther than the other in exact (f64)
    distances.  Raises past that; returns (flip count, largest gap)."""
    eps = float(np.finfo(np.float32).eps)
    got, want = np.asarray(got), np.asarray(want)
    flips = np.nonzero(got != want)[0]
    dd2 = 64 * eps * float((x * x).sum(1).max() + (c * c).sum(1).max())
    gap = 0.0
    if flips.size:
        xf = x[flips].astype(np.float64)
        c64 = c.astype(np.float64)
        gap = float(np.abs(((xf - c64[got[flips]]) ** 2).sum(1)
                           - ((xf - c64[want[flips]]) ** 2).sum(1)).max())
    emit({"phase": "check", "name": label, "flips": int(flips.size),
          "rows": int(got.size), "max_flip_gap": gap, "bound": 2 * dd2,
          "ok": bool(gap <= 2 * dd2)})
    if not gap <= 2 * dd2:
        raise Mismatch(f"{label}: a flipped owner is {gap} farther than "
                       f"the other's center, bound {2 * dd2}")
    return int(flips.size), gap


def gram_bound(torch, x, z, gamma: float, kind: str, dd2: float):
    """Elementwise bound on |kernel_matrix - its plain version| when the
    two D² differ by at most ``dd2``: K (expm1(dd2 / gamma^2)) for the
    Gaussian, K expm1(min(sqrt(dd2), dd2 / 2r) / gamma) for the Laplacian
    (r = sqrt(D²)), as ``predict_bound`` reasons, plus 8 ulps of 1 for
    exp's rounding."""
    from repro_torch.kernels.kernel_matrix.ref import (gram_from_d2_ref,
                                                       sq_dists_ref)
    eps = float(np.finfo(np.float32).eps)
    d2 = sq_dists_ref(x, z)
    kk = gram_from_d2_ref(d2, gamma, kind)
    if kind == "gauss_rbf":
        rel = float(np.expm1(dd2 / max(gamma * gamma, 1e-12)))
    else:
        root = torch.sqrt(d2 + 1e-12)
        rel = torch.expm1(torch.clamp(dd2 / (2.0 * root), max=dd2 ** 0.5)
                          / max(gamma, 1e-12))
    return kk * rel + 8 * eps


def cell_kernel_checks(torch, dev, x: np.ndarray):
    """B6, B7 and B8 against their plain versions on the card at the cell
    slice's shapes; returns (errors, timing cases, extra timing cases)."""
    from repro_torch.kernels import runtime
    from repro_torch.kernels.assign import ops as as_ops
    from repro_torch.kernels.assign import ref as as_ref
    from repro_torch.kernels.kernel_matrix import ops as km_ops
    from repro_torch.kernels.kernel_matrix import ref as km_ref
    from repro_torch.kernels.svm_predict import ops as sp_ops
    from repro_torch.kernels.svm_predict import ref as sp_ref
    eps = float(np.finfo(np.float32).eps)
    f32 = 4
    n = x.shape[0]
    rng = np.random.default_rng(SEED)
    n_cells = -(-n // CELL_SIZE)
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def assign_case(label, xd, cd):
        got = as_ops.assign(xd, cd)
        want = as_ref.assign_ref(xd, cd)
        torch.cuda.synchronize()
        xh, ch = xd.cpu().numpy(), cd.cpu().numpy()
        _, gap = assign_flips(f"assign[{label}] vs plain", xh, ch,
                              got.cpu().numpy(), want.cpu().numpy())
        return gap, got

    def assign_bound(m, c, d):
        return bound(f32 * (m * d + c * d + m),
                     m * c * (2 * d + 3) + (m + c) * 2 * d)

    # B6 at Covertype's chunk shape: the first chunk, the builder's sample
    chunk = torch.as_tensor(x[:CHUNK]).to(dev)
    cen = torch.as_tensor(x[rng.choice(n, n_cells, replace=False)]).to(dev)
    # max_abs_err of B6: the largest D² gap of a flipped owner (0: none)
    errs = {"assign": assign_case(f"{CHUNK}x{n_cells}x{DIM}", chunk, cen)[0]}
    # B6 at HIGGS width: the table does not fit in shared memory
    xh = torch.randn(CHUNK, HIGGS_D, generator=gen, device=dev)
    ch = (xh[torch.randperm(CHUNK, generator=gen, device=dev)[:HIGGS_C]]
          + 0.1 * torch.randn(HIGGS_C, HIGGS_D, generator=gen, device=dev))
    assign_case(f"{CHUNK}x{HIGGS_C}x{HIGGS_D}", xh, ch)
    # duplicated centers (3 copies of 97): the lowest index must win,
    # also for the rows that ARE centers
    base = cen[:97]
    nb = base.shape[0]
    dup = torch.cat([base, base.flip(0), base]).contiguous()
    rows = torch.cat([base, chunk]).contiguous()
    _, got = assign_case("duplicated centers", rows, dup)
    ok = (int(got.max()) < nb and torch.equal(
        got[:nb].cpu(), torch.arange(nb, dtype=torch.int32)))
    emit({"phase": "check", "name": "assign[duplicates: lowest index]",
          "ok": bool(ok)})
    if not ok:
        raise Mismatch("assign: a duplicated center's later copy won")
    # C and d off every tile
    odd = torch.as_tensor(x[:1000, :19]).to(dev)
    assign_case("1000x67x19", odd, odd[torch.randperm(
        1000, generator=gen, device=dev)[:67]].contiguous())

    # B7: (2048, 54) x (2048, 54), Gaussian and Laplacian
    xa = torch.as_tensor(x[:ONE_CELL_N]).to(dev)
    xb = torch.as_tensor(x[ONE_CELL_N:2 * ONE_CELL_N]).to(dev)
    gamma = float(torch.sqrt(torch.median(km_ref.sq_dists_ref(xa, xb))))
    dd2 = 64 * eps * float((xa * xa).sum(1).max() + (xb * xb).sum(1).max())
    for kind in ("gauss_rbf", "laplacian"):
        got = km_ops.kernel_matrix(xa, xb, gamma, kind=kind)
        want = km_ref.kernel_matrix_ref(xa, xb, gamma, kind)
        e = check_bound(f"gram[{kind}]", got.cpu(), want.cpu(),
                        gram_bound(torch, xa, xb, gamma, kind, dd2).cpu(),
                        shape=list(got.shape), gamma=gamma)
        errs.setdefault("gram", e)
    # B8: x_test (8192, 54), sv (2048, 54), coefs (2048, 7) and 1-D
    xt = torch.as_tensor(x[2 * ONE_CELL_N:2 * ONE_CELL_N
                           + ONE_CELL_TEST]).to(dev)
    co = torch.randn(ONE_CELL_N, N_CLASSES, generator=gen, device=dev)
    ga = torch.full((1, N_CLASSES), gamma, device=dev)
    dd2p = 64 * eps * float((xt * xt).sum(1).max() + (xa * xa).sum(1).max())
    for label, cols in (("P=7", co), ("1-D", co[:, 0].contiguous())):
        got = sp_ops.svm_predict(xt, xa, cols, gamma)
        want = sp_ref.svm_predict_ref(xt, xa, cols, gamma)
        c2 = cols if cols.dim() == 2 else cols[:, None]
        bnd = predict_bound(torch, km_ref.sq_dists_ref, xt[None], xa[None],
                            c2[None], ga[:, :c2.shape[1]], "gauss_rbf",
                            dd2p)[0]
        e = check_bound(f"svm_predict[{label}]", got.reshape(want.shape)
                        .cpu(), want.cpu(), bnd.cpu(),
                        shape=list(got.shape))
        errs.setdefault("svm_predict", e)

    timing = {
        "assign": (lambda: as_ops.assign(chunk, cen),
                   lambda: as_ref.assign_ref(chunk, cen), None,
                   assign_bound(CHUNK, n_cells, DIM)),
        "gram": (lambda: km_ops.kernel_matrix(xa, xb, gamma),
                 lambda: km_ref.kernel_matrix_ref(xa, xb, gamma),
                 None,
                 bound(f32 * (2 * ONE_CELL_N * DIM + ONE_CELL_N ** 2),
                       ONE_CELL_N ** 2 * (2 * DIM + 3 + 4)
                       + 2 * ONE_CELL_N * 2 * DIM)),
        "svm_predict": (
            lambda: sp_ops.svm_predict(xt, xa, co, gamma),
            lambda: sp_ref.svm_predict_ref(xt, xa, co, gamma), None,
            bound(f32 * (ONE_CELL_TEST * DIM + ONE_CELL_N * DIM
                         + ONE_CELL_N * N_CLASSES
                         + ONE_CELL_TEST * N_CLASSES),
                  ONE_CELL_TEST * ONE_CELL_N * (2 * DIM + 3 + 4)
                  + 2 * ONE_CELL_TEST * ONE_CELL_N * N_CLASSES
                  + (ONE_CELL_TEST + ONE_CELL_N) * 2 * DIM)),
    }
    extra = [(f"assign[{CHUNK}x{HIGGS_C}x{HIGGS_D}]",
              lambda: as_ops.assign(xh, ch), lambda: as_ref.assign_ref(xh, ch),
              None, assign_bound(CHUNK, HIGGS_C, HIGGS_D))]
    return errs, timing, extra


def cell_construction(torch, dev, x: np.ndarray, tables):
    """Pass 0 of the spatial cell builder at Covertype's full size, from a
    memmap on disk, with the B6 backend and with numpy; then minibatch
    k-means on the card twice.  Returns the B6 run's launch counts."""
    from repro_torch.kernels.assign import ops as as_ops
    from repro_torch.pipeline import MemmapSource
    from repro_torch.pipeline import assign as pl_assign
    shutil.rmtree(CELLS_DIR, ignore_errors=True)
    CELLS_DIR.mkdir(parents=True)
    path = CELLS_DIR / "x.npy"
    t0 = time.perf_counter()
    mm = np.lib.format.open_memmap(path, mode="w+", dtype=np.float32,
                                   shape=x.shape)
    mm[:] = x
    mm.flush()
    del mm
    write_s = time.perf_counter() - t0
    src = MemmapSource(path)
    n = src.n_rows
    n_cells = -(-n // CELL_SIZE)
    n_chunks = -(-n // CHUNK)
    init = src.gather(np.random.default_rng(SEED).choice(n, n_cells,
                                                         replace=False))

    zero_counts(tables)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cen_k = pl_assign.lloyd_stream(src, init, LLOYD_ITERS, CHUNK,
                                   backend="kernel", device=dev)
    own_k = pl_assign.assign_stream(src, cen_k, CHUNK, backend="kernel",
                                    device=dev)
    torch.cuda.synchronize()
    kernel_s = time.perf_counter() - t0
    counts = read_counts(tables)
    require_launches("cells[kernel]", counts,
                     {"assign": n_chunks * (LLOYD_ITERS + 1)})

    t0 = time.perf_counter()
    cen_n = pl_assign.lloyd_stream(src, init, LLOYD_ITERS, CHUNK)
    own_n = pl_assign.assign_stream(src, cen_n, CHUNK)
    numpy_s = time.perf_counter() - t0

    # owners of B6 and numpy at the same (numpy's) centers
    own_kn = pl_assign.assign_stream(src, cen_n, CHUNK, backend="kernel",
                                     device=dev)
    flips, _ = assign_flips("cells[B6 vs numpy owners]", x, cen_n, own_kn,
                            own_n)
    centers_equal = bool(np.array_equal(cen_k, cen_n))
    sweep_flips = []
    if not centers_equal:     # explained only by a flip during the sweeps
        for i in range(LLOYD_ITERS):
            c_i = pl_assign.lloyd_stream(src, init, i, CHUNK)
            sweep_flips.append(assign_flips(
                f"cells[B6 vs numpy, sweep {i}]", x, c_i,
                pl_assign.assign_stream(src, c_i, CHUNK, backend="kernel",
                                        device=dev),
                pl_assign.assign_stream(src, c_i, CHUNK))[0])
        if not any(sweep_flips):
            raise Mismatch("cells: swept centers differ from numpy's with "
                           "no owner flipped during the sweeps")
    cnt_k = np.bincount(own_k, minlength=n_cells)
    cnt_n = np.bincount(own_n, minlength=n_cells)

    # where one B6 sweep's time goes (host clock, the card synchronised)
    chunk_d = pl_assign._upload(x[:CHUNK], dev)
    cen_d = pl_assign._upload(cen_k, dev)
    b6_ms = cuda_ms(torch, lambda: as_ops.assign(chunk_d, cen_d))
    parts = dict(read=0.0, upload=0.0, assign=0.0, add_at=0.0)
    csum = np.zeros_like(cen_k)
    t = time.perf_counter()
    for _, ch in src.iter_chunks(CHUNK):
        t1 = time.perf_counter()
        parts["read"] += t1 - t
        cd = pl_assign._upload(ch, dev)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        parts["upload"] += t2 - t1
        a = as_ops.assign(cd, cen_d).cpu().numpy()
        t3 = time.perf_counter()
        parts["assign"] += t3 - t2
        np.add.at(csum, a, ch)
        np.bincount(a, minlength=n_cells)
        t = time.perf_counter()
        parts["add_at"] += t - t3

    # minibatch k-means on the card, twice: bitwise equal, and a lower
    # inertia than its initial sample
    zero_counts(tables)
    t0 = time.perf_counter()
    mbk = [pl_assign.minibatch_kmeans(src, n_cells, iters=MBK_ITERS,
                                      batch_size=MBK_BATCH, seed=SEED,
                                      device=dev) for _ in range(2)]
    mbk_s = (time.perf_counter() - t0) / 2
    require_launches("minibatch_kmeans", read_counts(tables), {})
    if not np.array_equal(mbk[0], mbk[1]):
        raise Mismatch("minibatch_kmeans: two runs on the card differ")
    mbk_init = src.gather(np.random.default_rng(SEED).choice(
        n, n_cells, replace=False))

    def inertia(c):
        cd = pl_assign._upload(c, dev)
        total = 0.0
        for _, ch in src.iter_chunks(CHUNK):
            xd = pl_assign._upload(ch, dev)
            d2 = ((xd * xd).sum(1)[:, None] + (cd * cd).sum(1)[None, :]
                  - 2.0 * (xd @ cd.T))
            total += float(torch.clamp(d2, min=0.0).min(1).values.double()
                           .sum())
        return total / n
    inert = {"mbk": inertia(mbk[0]), "mbk_init": inertia(mbk_init),
             "lloyd": inertia(cen_k), "lloyd_init": inertia(init)}
    if not (np.isfinite(mbk[0]).all() and inert["mbk"] < inert["mbk_init"]):
        raise Mismatch(f"minibatch_kmeans: inertia {inert['mbk']} not below "
                       f"the initial sample's {inert['mbk_init']}")
    emit({"phase": "cells", "n": n, "d": x.shape[1], "cells": n_cells,
          "chunks": n_chunks, "lloyd_iters": LLOYD_ITERS,
          "launches": counts["assign"], "owner_flips_vs_numpy": flips,
          "centers_bitwise_equal_numpy": centers_equal,
          "sweep_flips": sweep_flips,
          "cell_counts_equal": bool(np.array_equal(cnt_k, cnt_n)),
          "cells_whose_count_differs": int((cnt_k != cnt_n).sum()),
          "cell_counts": cnt_k.tolist(),
          "cell_size_min_max": [int(cnt_k.min()), int(cnt_k.max())],
          "empty_cells": int((cnt_k == 0).sum()),
          "write_s": write_s, "kernel_s": kernel_s, "numpy_s": numpy_s,
          "b6_ms_per_chunk": b6_ms,
          "b6_device_ms": b6_ms * counts["assign"],
          "device_busy_share": b6_ms * counts["assign"] / (kernel_s * 1e3),
          "one_sweep_host_s": parts, "mbk_s": mbk_s,
          "inertia": inert, "mbk_bitwise_repeat": True})
    shutil.rmtree(CELLS_DIR, ignore_errors=True)
    return counts


def one_cell_model(torch, dev, x: np.ndarray, y: np.ndarray, tables):
    """One cell through the kernel layer's entry points, as a user calls
    them: the Gram of 2048 training rows (B7), kernel ridge over the 7
    one-vs-all columns (a dense solve), decisions on 8192 test rows (B8,
    and 1-D coefficients for one column).  Returns the launch counts."""
    from repro_torch.kernels.kernel_matrix import ops as km_ops
    from repro_torch.kernels.kernel_matrix import ref as km_ref
    from repro_torch.kernels.svm_predict import ops as sp_ops
    from repro_torch.kernels.svm_predict import ref as sp_ref
    eps = float(np.finfo(np.float32).eps)
    n = ONE_CELL_N
    xtr = torch.as_tensor(x[:n]).to(dev)
    ytr = y[:n]
    xte = torch.as_tensor(x[n:n + ONE_CELL_TEST]).to(dev)
    yte = y[n:n + ONE_CELL_TEST]
    targets = torch.as_tensor(np.where(ytr[:, None] == np.arange(N_CLASSES),
                                       1.0, -1.0).astype(np.float32)).to(dev)
    gamma = float(torch.sqrt(torch.median(km_ref.sq_dists_ref(xtr, xtr))))
    zero_counts(tables)
    k = km_ops.kernel_matrix(xtr, xtr, gamma)
    eye = torch.eye(n, device=dev)
    coefs = torch.linalg.solve(k + n * ONE_CELL_LAMBDA * eye, targets)
    f = sp_ops.svm_predict(xte, xtr, coefs, gamma)
    f0 = sp_ops.svm_predict(xte, xtr, coefs[:, 0].contiguous(), gamma)
    torch.cuda.synchronize()
    counts = read_counts(tables)
    require_launches("one_cell", counts, {"gram": 1, "svm_predict": 2})
    if not torch.equal(f0, f[:, 0]):
        raise Mismatch("svm_predict: 1-D coefs differ from the 2-D call's "
                       "first column")
    dd2 = 64 * eps * 2 * float((xtr * xtr).sum(1).max())
    check_bound("one_cell[gram] vs plain", k.cpu(),
                km_ref.kernel_matrix_ref(xtr, xtr, gamma).cpu(),
                gram_bound(torch, xtr, xtr, gamma, "gauss_rbf", dd2).cpu())
    want = sp_ref.svm_predict_ref(xte, xtr, coefs, gamma)
    dd2p = 64 * eps * float((xte * xte).sum(1).max()
                            + (xtr * xtr).sum(1).max())
    bnd = predict_bound(torch, km_ref.sq_dists_ref, xte[None], xtr[None],
                        coefs[None], torch.full((1, N_CLASSES), gamma,
                                                device=dev),
                        "gauss_rbf", dd2p)[0]
    check_bound("one_cell[svm_predict] vs plain", f.cpu(), want.cpu(),
                bnd.cpu())
    fh = f.cpu().numpy()
    if fh.shape != (ONE_CELL_TEST, N_CLASSES) or not np.isfinite(fh).all():
        raise Mismatch(f"one_cell: decisions {fh.shape} or non-finite")
    err = float((fh.argmax(1) != yte).mean())
    majority = float((yte != np.bincount(ytr).argmax()).mean())
    emit({"phase": "one_cell", "n_train": n, "n_test": ONE_CELL_TEST,
          "gamma": gamma, "lambda": ONE_CELL_LAMBDA, "test_error": err,
          "majority_error": majority, "launches": counts})
    if not err < majority:
        raise Mismatch(f"one_cell: test error {err} not below the majority "
                       f"baseline {majority}")
    return counts


def sass_check(logs: dict) -> int:
    """B9's bf16 kernel must run its products on the tensor cores: the
    built library's SASS (``cuobjdump`` from the CUDA toolkit) holds
    HGMMA instructions, the machine code of ``wgmma``."""
    from repro_torch.kernels import runtime
    exe = Path(runtime.nvcc()).parent / "cuobjdump"
    lib = runtime.BUILD_DIR / "libflash_attention.so"
    sass = subprocess.run([str(exe), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    n = sum(line.count("HGMMA") for line in sass.splitlines())
    emit({"phase": "sass_check", "library": lib.name, "hgmma": n,
          "build_s": {k: v["seconds"] for k, v in logs.items()},
          "ok": n > 0})
    if n == 0:
        raise Mismatch("flash_attention: no HGMMA in the SASS of the bf16 "
                       "kernel")
    return n


def cuda_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Device ms per call: the calls are enqueued while the card runs a
    ~10 ms sleep kernel, so the events time the card's work and not the
    host's launch overhead (a call whose host side takes longer than the
    sleep still shows part of it)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(n_bytes: float, n_ops: float, peak: float = None) -> tuple:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / (FP32_FLOP_PER_S if peak is None else peak) * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke test runs on "
              "the GPU only", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}; run it "
              f"from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import obs
    from repro_torch.kernels import runtime
    from repro_torch.kernels.cd_solver import ops as cd_ops
    from repro_torch.kernels.cd_solver import ref as cd_ref
    from repro_torch.kernels.kernel_matrix import ops as km_ops
    from repro_torch.kernels.kernel_matrix import ref as km_ref
    from repro_torch.kernels.svm_predict import ops as sp_ops
    from repro_torch.kernels.svm_predict import ref as sp_ref
    from repro_torch.distributed.planner import plan_wave
    from repro_torch.pipeline.assign import nearest_center, nearest_top2_dists
    from repro_torch.serve import ModelBank, SVMEngine, blend_weights
    from repro_torch.core.cv import make_fold_masks
    from repro_torch.core.select import argmin_winners
    from repro_torch.data.scaling import Scaler
    from repro_torch.data.synthetic import covtype_like, covtype_like_heldout
    from repro_torch.distributed import cell_trainer
    from repro_torch.pipeline.cell_stream import build_cells_stream
    from repro_torch.pipeline.dataset import ArraySource
    from repro_torch.train.svm_trainer import LiquidSVM, SVMTrainerConfig
    from repro_torch.configs import get_arch
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.assign import ops as as_ops
    tables = (km_ops.launches, sp_ops.launches, cd_ops.launches,
              fa_ops.launches, dec_ops.launches, as_ops.launches)

    # fp32 products in the plain versions run in full fp32, never TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    eps = float(np.finfo(np.float32).eps)

    # ---------------------------------------------------------- 1. card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    t0 = time.perf_counter()
    logs = runtime.build()
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for v in logs.values() for ln in v["log"].splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "device", "nvidia_smi": smi,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "matmul_precision": torch.get_float32_matmul_precision(),
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "matmul_bf16_reduced_precision_reduction":
              torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction,
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32})
    emit({"phase": "build", "seconds": build_s,
          "per_source_s": {k: v["seconds"] for k, v in logs.items()},
          "ptxas": ptxas})
    sass_check(logs)

    full, obank, queries, q_overlap = make_bank_and_traffic(ModelBank)
    emit({"phase": "bank", "full": full.stats(), "overlap": obank.stats(),
          "n_requests": N_REQ, "wave": WAVE})

    # ------------------------------------- 2. kernels vs plain, wave shapes
    probe = SVMEngine(full, device=dev)
    xs0 = (queries[:WAVE] - full.feat_mean) / full.feat_std
    cells0 = probe.route(xs0)
    plan = plan_wave(np.bincount(cells0, minlength=full.n_cells),
                     row_bucket=probe.row_bucket,
                     slot_bucket=probe.slot_bucket)
    xt = np.zeros((plan.n_slots, plan.m_pad, DIM), np.float32)
    for s in range(plan.n_slots):
        cid = int(plan.slot_cell[s])
        if cid >= 0:
            rows = np.where(cells0 == cid)[0]
            rows = rows[int(plan.slot_off[s]):][:int(plan.slot_take[s])]
            xt[s, :rows.size] = xs0[rows]
    idx = torch.as_tensor(np.maximum(plan.slot_cell, 0)).to(dev)
    xt_d = torch.as_tensor(xt).to(dev)
    sv_w = probe._sv.index_select(0, idx)
    co_w = probe._coefs.index_select(0, idx)
    ga_w = probe._gammas.index_select(0, idx)
    shapes = {"slots": plan.n_slots, "m_pad": plan.m_pad, "k": full.k_max,
              "d": DIM, "P": full.n_columns}
    emit({"phase": "wave_shape", **shapes})
    s_, m_, k_, p_ = plan.n_slots, plan.m_pad, full.k_max, full.n_columns

    # Tolerances: B1 64 ulps of the largest |x|^2 + |z|^2 (the GEMM form
    # cancels there; the plain version's cuBLAS cross term sums in another
    # order); B2 a few ulps of K <= 1, or one bf16 ulp on a bf16 write; B3
    # and the served decisions: each value within its own bound, what a D²
    # error within B1's tolerance does to that value (predict_bound), so a
    # column whose gamma makes its decisions tiny is held as tightly, in
    # proportion, as one whose decisions are large.
    errs = {}
    d2 = km_ops.sq_dists(xt_d, sv_w)
    d2_ref = km_ref.sq_dists_ref(xt_d, sv_w)
    scale = float(((xt_d * xt_d).sum(-1).max() + (sv_w * sv_w).sum(-1).max()))
    dd2 = 64 * eps * scale
    torch.cuda.synchronize()
    errs["sq_dists"] = check("sq_dists", float((d2 - d2_ref).abs().max()),
                             dd2, shape=[s_, m_, k_])
    for kind in ("gauss_rbf", "laplacian"):
        for din, dout in (("f32", "f32"), ("bf16", "bf16"), ("bf16", "f32")):
            src = d2_ref if din == "f32" else d2_ref.to(torch.bfloat16)
            got = km_ops.gram_from_d2(src, ga_w, kind=kind, out_dtype=dout)
            want = km_ref.gram_from_d2_ref(src[:, None],
                                           ga_w[:, :, None, None], kind, dout)
            err = float((got.float() - want.float()).abs().max())
            tol = 2.0 ** -8 if dout == "bf16" else 8 * eps
            e = check(f"gram_from_d2[{kind},{din}->{dout}]", err, tol)
            if (kind, din, dout) == ("gauss_rbf", "f32", "f32"):
                errs["gram_from_d2"] = e
    gen = torch.Generator().manual_seed(SEED)
    co_wide = torch.randn(WIDE_SLOTS, k_, WIDE_P, generator=gen).to(dev)
    ga_wide = (torch.rand(WIDE_SLOTS, WIDE_P, generator=gen) * 3.4
               + 0.6).to(dev)
    for kind, args in (
            ("gauss_rbf", (xt_d, sv_w, co_w, ga_w)),
            ("laplacian", (xt_d, sv_w, co_w, ga_w)),
            ("gauss_rbf,P=70", (xt_d[:WIDE_SLOTS], sv_w[:WIDE_SLOTS],
                                co_wide, ga_wide))):
        kern = kind.split(",")[0]
        got = sp_ops.svm_predict_cells(*args, kind=kern)
        want = sp_ref.svm_predict_cells_ref(*args, kind=kern)
        bnd = predict_bound(torch, km_ref.sq_dists_ref, *args, kern, dd2)
        e = check_bound(f"svm_predict_cells[{kind}]", got.cpu(), want.cpu(),
                        bnd.cpu(), shape=list(got.shape))
        if kind == "gauss_rbf":
            errs["svm_predict_cells"] = e
    del probe

    # -------------------------------------------------- 3. the main path
    xo = (q_overlap - obank.feat_mean) / obank.feat_std
    two_part = int((blend_weights(*nearest_top2_dists(xo, obank.centers)[2:])
                    [1] > 0).sum())
    if two_part == 0:
        raise Mismatch("overlap traffic has no two-cell requests")
    # each path's run alone: counts set to 0 just before it, read just after
    def counted(run):
        zero_counts(tables)
        out = run()
        return out, read_counts(tables)

    eng_near = SVMEngine(full, device=dev, fused=True)
    eng_over = SVMEngine(obank, device=dev, fused=True)
    eng_cache = SVMEngine(full, device=dev, fused=False)
    sweep_g = np.geomspace(0.5, 4.0, N_SWEEP).astype(np.float32)
    (dec_near, _), n_near = counted(lambda: serve(eng_near, queries))
    (dec_over, _), n_over = counted(lambda: serve(eng_over, q_overlap))
    (dec_cache, _), n_cache = counted(lambda: serve(eng_cache, queries))
    sweep, n_sweep = counted(lambda: eng_cache.sweep_gammas(sweep_g).cpu())
    per_path = {"nearest_fused": n_near, "overlap_fused": n_over,
                "unfused": n_cache, "sweep_gammas": n_sweep}
    launches = {name: sum(n[name] for n in per_path.values())
                for name in n_near}
    emit({"phase": "serve", "launches": launches,
          "launches_per_path": per_path,
          "overlap_two_part_requests": two_part,
          **{label: {k: e.stats().get(k, 0) for k in
                     ("waves", "served", "routing", "pad_fraction",
                      "d2_misses", "d2_hits")}
             for label, e in (("nearest", eng_near), ("overlap", eng_over),
                              ("unfused", eng_cache))}})
    expect = {  # path -> kernels it must launch; every other one stays at 0
        "nearest_fused": {"svm_predict_cells"},
        "overlap_fused": {"svm_predict_cells"},
        "unfused": {"sq_dists", "gram_from_d2"},
        "sweep_gammas": {"gram_from_d2"}}
    for path, counts in per_path.items():
        for name, n in counts.items():
            if (n > 0) != (name in expect[path]):
                raise Mismatch(f"{path}: kernel {name} launched {n} times; "
                               f"the path launches {sorted(expect[path])}")

    refs = dict(torch=torch, svm_ref=sp_ref.svm_predict_cells_ref,
                sq_dists_ref=km_ref.sq_dists_ref,
                nearest_center=nearest_center,
                nearest_top2_dists=nearest_top2_dists,
                blend_weights=blend_weights)
    bounds = {}
    for label, bank, x, dec, ovl in (
            ("nearest_fused", full, queries, dec_near, False),
            ("overlap_fused", obank, q_overlap, dec_over, True),
            ("nearest_unfused", full, queries, dec_cache, False)):
        want, bnd = plain_decisions(bank, x, ovl, dev, **refs)
        if dec.shape != want.shape or not np.isfinite(dec).all():
            raise Mismatch(f"{label}: shape {dec.shape} vs {want.shape} or "
                           f"non-finite decisions")
        check_bound(f"serve[{label}] vs plain", dec, want, bnd)
        bounds[label] = bnd
    # two results each within its bound of the plain one: within twice it
    check_bound("serve[unfused] vs fused", dec_cache, dec_near,
                2 * bounds["nearest_fused"])
    w = eng_cache._last_wave
    sv_l = eng_cache._sv.index_select(0, w["idx_d"])
    co_l = eng_cache._coefs.index_select(0, w["idx_d"])
    dd2_l = 64 * eps * float((w["xt_d"] * w["xt_d"]).sum(-1).max()
                             + (sv_l * sv_l).sum(-1).max())
    for g_i in range(N_SWEEP):
        gg = torch.full((sv_l.shape[0], full.n_columns), float(sweep_g[g_i]),
                        device=dev)
        fused_g = sp_ops.svm_predict_cells(w["xt_d"], sv_l, co_l, gg,
                                           kind=full.kernel).cpu()
        bnd = predict_bound(torch, km_ref.sq_dists_ref, w["xt_d"], sv_l, co_l,
                            gg, full.kernel, dd2_l).cpu()
        check_bound(f"sweep_gammas[{sweep_g[g_i]:.3f}] vs fused",
                    sweep[g_i], fused_g, 2 * bnd)
    labels = eng_near.predict_label(queries[:WAVE])
    if labels.shape != (WAVE,) or not np.isin(labels, full.classes).all():
        raise Mismatch("predict_label: bad OvA labels")

    # ---------------------------------------------------------- 4. times
    eng_t = SVMEngine(full, device=dev, fused=True)
    serve(eng_t, queries)                      # warm the shapes
    eng_t = SVMEngine(full, device=dev, fused=True,
                      metrics=obs.MetricsRegistry())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, submit_s = serve(eng_t, queries)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    st = eng_t.stats()
    cell_idx = np.maximum(plan.slot_cell, 0)
    wave_dev_ms = cuda_ms(torch, lambda: eng_t._evaluate(xt, cell_idx))
    gather_ms = cuda_ms(torch, lambda: eng_t._sv.index_select(0, idx))
    n_waves = st["waves"]
    emit({"phase": "serve_time", "requests": N_REQ, "waves": n_waves,
          "seconds": secs, "ms_per_wave": secs * 1e3 / n_waves,
          "requests_per_s": N_REQ / secs,
          "submit_ms_per_wave": submit_s * 1e3 / n_waves,
          "per_stage_mean_ms": {k: v["mean_ms"]
                                for k, v in st["per_stage"].items()},
          "wave_device_ms": wave_dev_ms, "sv_gather_ms": gather_ms,
          "device_busy_share": wave_dev_ms * n_waves / (secs * 1e3),
          "request_ms_q": st.get("request_ms_q")})
    # the unfused engine (B1, then B2 once per column) and one sweep of the
    # last wave over N_SWEEP gammas (B2 once per gamma), timed the same way
    eng_u = SVMEngine(full, device=dev, fused=False)
    serve(eng_u, queries)                      # warm the shapes
    eng_u.sweep_gammas(sweep_g)
    eng_u = SVMEngine(full, device=dev, fused=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    serve(eng_u, queries)
    torch.cuda.synchronize()
    secs_u = time.perf_counter() - t0
    t0 = time.perf_counter()
    eng_u.sweep_gammas(sweep_g)
    torch.cuda.synchronize()
    emit({"phase": "serve_time_unfused", "requests": N_REQ,
          "seconds": secs_u, "requests_per_s": N_REQ / secs_u,
          "sweep_gammas": N_SWEEP,
          "sweep_ms": (time.perf_counter() - t0) * 1e3})

    # ------------------------------------------------------- 5. training
    x_tr, y_tr = covtype_like(n=TRAIN_N, d=DIM, n_classes=N_CLASSES,
                              seed=SEED)
    x_te, y_te = covtype_like_heldout(HELDOUT_N, n=TRAIN_N, d=DIM,
                                      n_classes=N_CLASSES, seed=SEED,
                                      new_seed=HELDOUT_SEED)
    # the first wave's cells as the fit stages them: scaled rows of the
    # plan's first cells, padding rows zero
    n_sw, n_f = TRAIN_CFG["n_slots_per_wave"], TRAIN_CFG["n_folds"]
    n_cols = N_CLASSES * 10                       # tasks x the 10 lambdas
    xs_tr = Scaler.fit_stream(ArraySource(x_tr), 65536).transform(x_tr)
    tplan = build_cells_stream(ArraySource(xs_tr),
                               cell_size=TRAIN_CFG["cell_size"],
                               method=TRAIN_CFG["cell_method"], seed=SEED)
    mask_w = tplan.mask[:n_sw]
    x_w = xs_tr[tplan.indices[:n_sw]] * mask_w[:, :, None]
    x_wd = torch.as_tensor(x_w).to(dev)
    emit({"phase": "train_wave_shape", "cells": tplan.n_cells,
          "slots": n_sw, "folds": n_f, "k": tplan.k_max, "d": DIM,
          "P": n_cols})
    errs_t, prob = train_kernel_checks(torch, x_wd,
                                       torch.as_tensor(mask_w).to(dev),
                                       n_f, n_cols)
    errs.update(errs_t)
    small_fit_parity(torch, dev, covtype_like, LiquidSVM, SVMTrainerConfig,
                     make_fold_masks, argmin_winners)
    model, fit_counts, test_counts, dec_df, err_df = full_fit(
        torch, dev, (x_tr, y_tr, x_te, y_te), LiquidSVM, SVMTrainerConfig,
        tables, cell_trainer, obs)
    bank_counts = serve_trained(torch, dev, model, x_te, y_te, dec_df,
                                err_df, SVMEngine, tables, refs)
    b5_counts = b5_entry(torch, dev, model, tables)
    fista_profile(torch, prob)
    train_paths = {"fit": fit_counts, "test": test_counts,
                   "trained_bank": bank_counts, "cd_epochs": b5_counts}
    emit({"phase": "train_launches", "per_path": train_paths})
    launches = {name: launches.get(name, 0)
                + sum(n[name] for n in train_paths.values())
                for name in fit_counts}

    # ------------------------------------------------------ 6. LM slice
    lm_cfg = get_arch(LM_ARCH).config
    errs.update(lm_kernel_checks(torch, dev, lm_cfg))
    corpus = lm_corpus(lm_cfg.vocab)
    ex, src_tr, src_ho, embed_counts = lm_embed(torch, dev, lm_cfg, corpus,
                                                tables, obs)
    fit_counts_lm, serve_counts_lm, head_wave = lm_svm_head(
        torch, dev, ex, src_tr, src_ho, corpus, tables, refs)
    prompt = torch.as_tensor(corpus[2][:GEN_BATCH, :GEN_PROMPT]).to(dev)
    gen_counts = lm_generate(torch, dev, lm_cfg, ex.params, prompt, tables)
    lm_decode_profile(torch, dev, lm_cfg, ex.params, prompt)
    lm_smoke_tokens(torch, dev, tables)
    lm_paths = {"embed": embed_counts, "svm_fit": fit_counts_lm,
                "embed_serve": serve_counts_lm, "generate": gen_counts}
    emit({"phase": "lm_launches", "per_path": lm_paths})
    launches = {name: launches.get(name, 0)
                + sum(n[name] for n in lm_paths.values())
                for name in embed_counts}
    del ex, src_tr, src_ho
    torch.cuda.empty_cache()

    # ------------------------------------------- 7. cell construction
    t0 = time.perf_counter()
    x_cells, y_cells = covtype_like(n=CELLS_N, d=DIM, n_classes=N_CLASSES,
                                    seed=SEED)
    emit({"phase": "cells_data", "rows": x_cells.shape[0],
          "d": x_cells.shape[1], "seconds": time.perf_counter() - t0})
    errs_c, cell_timing, cell_extra = cell_kernel_checks(torch, dev, x_cells)
    errs.update(errs_c)
    cell_paths = {"cells": cell_construction(torch, dev, x_cells, tables),
                  "one_cell": one_cell_model(torch, dev, x_cells, y_cells,
                                             tables)}
    emit({"phase": "cell_launches", "per_path": cell_paths})
    launches = {name: launches.get(name, 0)
                + sum(n[name] for n in cell_paths.values())
                for name in cell_paths["cells"]}
    del x_cells, y_cells

    # ------------------------------------------------- 8. kernel times
    f32 = 4
    neg = (-(d2_ref[:, None] / torch.clamp(ga_w * ga_w, min=1e-12)
             [:, :, None, None])).contiguous()
    rows = []
    timing = {
        "sq_dists": (
            lambda: km_ops.sq_dists(xt_d, sv_w),
            lambda: km_ref.sq_dists_ref(xt_d, sv_w),
            None,
            bound(f32 * (s_ * m_ * DIM + s_ * k_ * DIM + s_ * m_ * k_),
                  s_ * m_ * k_ * (2 * DIM + 3) + s_ * (m_ + k_) * 2 * DIM)),
        "gram_from_d2": (
            lambda: km_ops.gram_from_d2(d2, ga_w),
            lambda: km_ref.gram_from_d2_ref(d2[:, None],
                                            ga_w[:, :, None, None]),
            lambda: torch.exp(neg),
            bound(f32 * (s_ * m_ * k_ + s_ * p_ + s_ * p_ * m_ * k_),
                  4 * s_ * p_ * m_ * k_)),
        "svm_predict_cells": (
            lambda: sp_ops.svm_predict_cells(xt_d, sv_w, co_w, ga_w),
            lambda: sp_ref.svm_predict_cells_ref(xt_d, sv_w, co_w, ga_w),
            None,
            bound(f32 * (s_ * m_ * DIM + s_ * k_ * DIM + s_ * k_ * p_
                         + s_ * p_ + s_ * m_ * p_),
                  s_ * m_ * k_ * (2 * DIM + 3) + s_ * (m_ + k_) * 2 * DIM
                  + 4 * s_ * m_ * k_ * p_)),
    }
    d2_t, kk, c0, g0, lo, hi = prob
    s_t, f_t, n_t, p_t = c0.shape
    one = [t[0].permute(1, 0, 2).reshape(n_t, f_t * p_t).contiguous()
           for t in (c0, g0, lo, hi)]
    cd_ops_count = s_t * f_t * p_t * n_t * (2 * n_t + 5)
    timing.update({
        "sq_dists_sym": (
            lambda: km_ops.sq_dists(x_wd, x_wd, symmetric=True),
            lambda: km_ref.sq_dists_ref(x_wd, x_wd, symmetric=True),
            None,
            bound(f32 * (s_t * n_t * DIM + s_t * n_t * n_t),
                  s_t * (n_t * (n_t + 1) // 2 * (2 * DIM + 3)
                         + n_t * 2 * DIM))),
        # one epoch: per coordinate and column a divide, a subtract, a
        # clip and a subtract, then n multiply-adds of the gradient
        "cd_wave_epoch": (
            lambda: cd_ops.cd_wave_epoch(kk, c0, g0, lo, hi),
            lambda: cd_ref.cd_wave_epoch_ref(kk, c0, g0, lo, hi),
            None,
            bound(f32 * (s_t * n_t * n_t + 6 * s_t * f_t * n_t * p_t),
                  cd_ops_count)),
        "cd_epoch": (
            lambda: cd_ops.cd_epoch(kk[0], *one),
            lambda: cd_ref.cd_epoch_ref(kk[0], *one),
            None,
            bound(f32 * (n_t * n_t + 6 * f_t * n_t * p_t),
                  cd_ops_count // s_t)),
    })
    lm_rows = []
    for label, kern, plain, lib, b in lm_timing_cases(torch, dev, lm_cfg):
        long_ctx = "B=" in label
        reps = dict(iters=3, warmup=1) if long_ctx else {}
        if label in KERNELS:           # the LM path's shape: the table row
            timing[label] = (kern, plain, lib, b)
            continue
        lm_rows.append({"name": label, "ms": cuda_ms(torch, kern),
                        "plain_ms": cuda_ms(torch, plain, **reps),
                        "bound_ms": b[0], "bound_by": b[1],
                        "library_ms": (None if lib is None
                                       else cuda_ms(torch, lib))})
    # B3 at the LM head's wave: EmbedServe's most frequent launch shape
    xh, svh, coh, gah = head_wave["args"]
    c_h, m_h, d_h = xh.shape
    k_h, p_h = svh.shape[1], coh.shape[2]
    kind_h = head_wave["kind"]
    dd2_h = 64 * eps * float((xh * xh).sum(-1).max()
                             + (svh * svh).sum(-1).max())
    label = f"svm_predict_cells[LM head: {c_h}x{m_h}x{k_h}x{d_h}, P {p_h}]"
    e_h = check_bound(label, sp_ops.svm_predict_cells(
        xh, svh, coh, gah, kind=kind_h).cpu(), sp_ref.svm_predict_cells_ref(
        xh, svh, coh, gah, kind=kind_h).cpu(), predict_bound(
        torch, km_ref.sq_dists_ref, xh, svh, coh, gah, kind_h, dd2_h).cpu())
    b_h = bound(f32 * (c_h * m_h * d_h + c_h * k_h * d_h + c_h * k_h * p_h
                       + c_h * p_h + c_h * m_h * p_h),
                c_h * m_h * k_h * (2 * d_h + 3) + c_h * (m_h + k_h) * 2 * d_h
                + 4 * c_h * m_h * k_h * p_h)
    lm_rows.append({
        "name": label, "launches": serve_counts_lm["svm_predict_cells"],
        "max_abs_err": e_h,
        "ms": cuda_ms(torch, lambda: sp_ops.svm_predict_cells(
            xh, svh, coh, gah, kind=kind_h)),
        "plain_ms": cuda_ms(torch, lambda: sp_ref.svm_predict_cells_ref(
            xh, svh, coh, gah, kind=kind_h)),
        "bound_ms": b_h[0], "bound_by": b_h[1], "library_ms": None,
        "waves_slots_x_rows": head_wave["waves"]})
    del head_wave, xh, svh, coh, gah
    timing.update(cell_timing)
    cell_rows = [{"name": label, "ms": cuda_ms(torch, kern),
                  "plain_ms": cuda_ms(torch, plain), "bound_ms": b[0],
                  "bound_by": b[1], "library_ms": None}
                 for label, kern, plain, _, b in cell_extra]
    slow = {"cd_wave_epoch", "cd_epoch"}   # the plain sweeps take ~0.1-1 s
    for name, (kern, plain, lib, (b_ms, b_by)) in timing.items():
        reps = dict(iters=3, warmup=1) if name in slow else {}
        rows.append({
            "name": name, "route": "cuda", "source": KERNELS[name][0],
            "replaces": KERNELS[name][1], "launches": launches[name],
            "max_abs_err": errs[name], "ms": cuda_ms(torch, kern),
            "plain_ms": cuda_ms(torch, plain, **reps), "bound_ms": b_ms,
            "bound_by": b_by,
            "library_ms": None if lib is None else cuda_ms(torch, lib)})
    # B2 at the training gamma step: one gamma per slot over the wave's D²
    gam_t = torch.sqrt(d2_t.mean((1, 2)))[:, None].contiguous()
    neg_t = (-(d2_t[:, None] / torch.clamp(gam_t * gam_t, min=1e-12)
               [:, :, None, None])).contiguous()
    b2_train = bound(f32 * (2 * d2_t.numel() + s_t), 4 * d2_t.numel())
    got = km_ops.gram_from_d2(d2_t, gam_t)
    want = km_ref.gram_from_d2_ref(d2_t[:, None], gam_t[:, :, None, None])
    torch.cuda.synchronize()
    same = torch.equal(got, want)
    emit({"phase": "check", "name": "gram_from_d2[train: %d x %d^2, G 1]"
          % (s_t, n_t), "max_abs_err": float((got - want).abs().max()),
          "tol": 0.0, "equal": same, "ok": same})
    if not same:
        raise Mismatch("gram_from_d2 at the training gamma step: not "
                       "bitwise equal to its plain version")
    del got, want
    train_rows = [{
        "name": "gram_from_d2[train: %d x %d^2, G 1]" % (s_t, n_t),
        "ms": cuda_ms(torch, lambda: km_ops.gram_from_d2(d2_t, gam_t)),
        "plain_ms": cuda_ms(torch, lambda: km_ref.gram_from_d2_ref(
            d2_t[:, None], gam_t[:, :, None, None])),
        "bound_ms": b2_train[0], "bound_by": b2_train[1],
        "library_ms": cuda_ms(torch, lambda: torch.exp(neg_t))}]
    del neg_t
    emit({"phase": "lm_kernel_times", "rows": lm_rows,
          "library": "torch.nn.functional.scaled_dot_product_attention",
          "card": smi.splitlines()[0]})
    emit({"phase": "cell_kernel_times", "rows": cell_rows,
          "card": smi.splitlines()[0]})
    emit({"phase": "kernel_times", "shapes": shapes, "rows": train_rows,
          "train_shapes": {"slots": s_t, "folds": f_t, "k": n_t, "d": DIM,
                           "P": p_t},
          "lm_shapes": {"flash_attention": [LM_BATCH, LM_SEQ, lm_cfg.n_heads,
                                            lm_cfg.head_dim],
                        "decode_attention": [GEN_BATCH, GEN_PROMPT + GEN_NEW,
                                             lm_cfg.n_kv_heads, 1,
                                             lm_cfg.head_dim]},
          "cell_shapes": {"assign": [CHUNK, -(-CELLS_N // CELL_SIZE), DIM],
                          "gram": [ONE_CELL_N, ONE_CELL_N, DIM],
                          "svm_predict": [ONE_CELL_TEST, ONE_CELL_N, DIM,
                                          N_CLASSES]},
          "card": smi.splitlines()[0]})
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
