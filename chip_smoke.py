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
     training and 8000 held out): holds the symmetric D² (B1-sym; also
     bitwise against B1(x, x)) and the Gauss-Seidel epoch (B4, and B5 at
     one slot) against their plain versions at the training wave's shapes
     (16 slots x 5 folds x k_max rows x 70 columns), fits a small set on
     the CPU and on the card and compares plans, fold masks, surfaces and
     selections, then fits the full set on the card with the launches of
     every wave counted, its stage times, FISTA iterations and test error
     through ``decision_function`` and through the bank served by
     ``SVMEngine``; drives ``cd_epochs`` (B5's entry point) on one fitted
     cell; then the staged session (``staged_small``: an ``nplSVM``
     session at n 1008 on the CPU and on the card, with the same plans,
     argmin and npl winners, moved sets and ``stats``, and re-solved
     decisions within 5e-3; ``staged``: Covertype's binary form at the
     training cell's widths and settings, ``nplSVM`` with 5 weights, then
     ``select`` under npl at alphas 0.05 and 0.01 (one B1 a gamma group),
     roc (no re-solve) and argmin (the cache bitwise), the held-out test,
     save and load of both results and the bank under
     ``build/chip_smoke_staged/`` (removed at the start and end; the
     loaded bank serves the same bits), ``engine()`` serving 8192 requests
     with ``monitor()`` attached, a drifted batch on 3 cells that
     ``drifted_cells()`` must name, ``refresh_drifted`` on a labelled
     feedback pool touching exactly those slots, ``swap_bank`` and serving
     again within ``predict_bound`` of the plain reference; every step's
     launches exact); then kill-anywhere resume (``wave_resume``: the
     staged cell's binary form cut to 9000 rows in 3 waves of 3 slots,
     fitted with a checkpoint directory, killed under ``faults.armed`` at
     the start of wave 2, after wave 1's solve and mid-write of wave 2's
     checkpoint and run again, and run once over a copy with a flipped
     shard byte: the fit's arrays, the held-out decisions and an npl
     select bitwise the uninterrupted run's, the restored / solved /
     corrupt wave counters and the launches exact);
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
     the plain path's; gemma3-4b at full width in bf16 over 2 sequences of
     2048 tokens (past its 1024 window): pooled rows and the prefill's and
     first decode step's logits against the plain attention path within
     3e-2; the dense-attention families: B9 and B10 at head dims 8, 80
     and 160 against their plain versions, stablelm-12b at full width
     (2 x 2048 tokens embedded, prefill and first-step logits against the
     plain attention path, 8 tokens generated with bf16 and int8 caches),
     hubert-xlarge at full width (``encode`` and pooled rows over 4 x 1024
     frames against the plain path), internvl2's and command-r's smoke
     configs on the card against the CPU; rwkv6-1.6b (attention-free) at
     full width: a prefill of 2 x 2048 tokens at chunk 128 and 32 greedy
     tokens (no kernel launched), the decode state's bytes at every
     budget, in f32 the state after a prefill against stepping the tokens
     one by one, the bf16 logits against the f32 path, extractor rows
     under two chunk sizes; the MoE and mamba mixers at full width with
     the depth cut to whole periods: jamba-v0.1-52b (8 layers),
     qwen3-moe-235b-a22b and llama4-maverick-400b-a17b (2 layers each),
     a prefill of 2 x 2048 tokens, the prefill's and first step's logits
     against the plain attention path with the routing replayed (every
     routing flip a near-tie), generation with bf16 and int8 caches
     through B10 at G 16 and G 5, jamba's state bytes, mamba stepped vs
     prefilled in f32 and extractor rows bitwise; their smoke configs
     card vs CPU; LM training: one train step of every ported
     architecture's smoke config on the card against the CPU, then
     stablelm-1.6b at full width under ``Trainer`` (fp32 policy, 4 steps
     of 8 x 1024 tokens in 2 micro-batches) timed, and at full width with
     the depth cut to 4 layers killed before step 3 and resumed from its
     step-2 checkpoint under ``build/chip_smoke_lm_train/`` (removed at
     the start and the end) to the uninterrupted run's state bitwise,
     with no B9 or B10 launch; each run's launches are counted on their
     own; then several devices (``mesh``): one NCCL rank in this process
     on a (1, 1) ("data", "model") mesh: the training cell's widths and
     settings on rows cut to one wave of 16 slots fitted with the mesh
     and without (arrays, B1-sym / B2 / B4 launches and held-out
     decisions bitwise equal), ``ef_psum_tree`` over stablelm-1.6b's full
     gradient tree on the card against the CPU, one sharded ``Trainer``
     step of stablelm-1.6b at full width (FSDP specs, sharded
     activations) against the unsharded step, its parameters
     checkpointed from the mesh and restored unsharded; then two ranks
     on the one card (gloo, spawned): the fit split over a (2,) mesh,
     each rank's block bitwise its one-process solve, the two ranks'
     results equal and held against the one-rank fit cell by cell,
     ``ef_psum`` over the two ranks; then the head-parallel prefill
     (``mesh_prefill``): stablelm-1.6b at full width over a (1, 2)
     ("data", "model") mesh of two ranks on the one card, in f32 and
     bf16, B9 once a layer at each rank's 16 heads (its first launch
     replayed against the plain version), the embedding vocab-parallel,
     the logits against the unsharded prefill, 4 decode steps with the
     cache split over the sequence (flash-decoding: B10's partials mode
     once a layer a step on each rank's half of the ring, its first
     launch replayed against the plain partials, the logits against the
     unsharded decode), and B9 at every config's local heads at the
     production mesh's 16 'model' ranks; then attention by head group
     (``mesh_uneven``): gemma3-4b at its published widths, depth cut to
     one period (5 sliding-window layers and 1 global), over a (1, 16)
     mesh of 16 ranks on the one card, whose 16 'model' ranks do not
     divide its 8 heads (8 groups of 2 ranks, a head and one of its
     group's 2 rows each), a prefill of 2 x 2048 tokens and 4 decode
     steps on the cache it lays out, split over the sequence, in f32 and
     bf16, against rank 0's unsharded prefill and decode, each rank's
     first B9 and B10-partials launch replayed against its plain
     version; then the launch tooling
     (``launch``): ``python -m repro_torch.launch.serve`` for
     stablelm-1.6b and gemma3-4b (window attention) in processes of
     their own, each launching B9 once an attention layer and B10 once a
     layer a decode step, their first launches replayed here against the
     plain versions; ``launch.train --full --steps 3`` (stablelm-1.6b at
     full width on the card, finite losses); and the dry run of
     stablelm-1.6b's ``train_4k`` cell on the (16, 16) production mesh
     (``launch.dryrun``: a fake process group, fake tensors, on the CPU,
     started beside the build), its per-device FLOPs, bytes and
     collective bytes printed; then the examples (``examples``):
     ``examples/torch_quickstart.py`` and ``examples/torch_serve_svm.py``
     at their defaults on the card, in this process, their launches
     counted alone and their reports held;
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
     held against its plain version within ``predict_bound``; B1 also
     at the fit's test phase and B1-sym at the LM head's fit wave, each
     path's own launch operands, held against their plain versions);
     prints one JSON line per phase, the kernel table, and last
     ``{"ok": true, "device": {...}}``.

Any mismatch or exception ends the run with a non-zero exit code.  Without
a card, or without the rest of the repository beside it, it exits non-zero
before printing any result.
"""
from __future__ import annotations

import atexit
import collections
import concurrent.futures
import contextlib
import hashlib
import json
import multiprocessing
import os
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

# staged session: Covertype's binary form (LIBSVM's covtype.binary, two
# classes) at Covertype's widths, Neyman-Pearson selection
# (nplSVM: false alarms on class -1 at most STAGED_ALPHA, the default
# weight grid of 5: P = 10 lambdas x 5 weights = 50) with the training
# cell's settings; rows from covtype_like with 2 classes, 32004 trained and
# 8000 held out as in the training phase; artifacts under STAGED_DIR
STAGED_KEYS = dict(VORONOI="recursive", CELL_SIZE=2000, FOLDS=5,
                   GRID_CHOICE=0, TOLERANCE=1e-3, MAX_ITERATIONS=1000,
                   SOLVER_POLISH=2, WAVE_SLOTS=16)
STAGED_ALPHA, STAGED_ALPHA_2 = 0.05, 0.01
# re-solve calls (one per winning gamma group; each launches B1 and B2
# once and B4 SOLVER_POLISH times) at this cell: the selections and the
# refresh are deterministic on the card (measured on an H100)
STAGED_RESOLVE_CALLS = {"select_npl": 5, "select_npl_2": 7,
                        "select_npl_again": 5, "refresh": 4}
STAGED_DIR = ROOT / "build" / "chip_smoke_staged"
# the CPU-vs-card session (n ~ 1000, cells of 500, 3 folds)
STAGED_SMALL_KEYS = dict(VORONOI="recursive", CELL_SIZE=500, FOLDS=3,
                         TOLERANCE=1e-3, MAX_ITERATIONS=1000, SOLVER_POLISH=2)
# re-solved decisions of two runs: both stop FISTA at a KKT residual of
# 1e-3 of the box, products summed in another order (test_torch_session)
RESOLVE_TOL = 5e-3
# the drifted batch: the DRIFT_CELLS cells with the most held-out traffic,
# their queries moved DRIFT_SIGMA standard deviations (scaled units) away
# from the cell's center on DRIFT_FEATURES features, served DRIFT_REPEAT
# times in a monitor pane of their own (panes of DRIFT_WINDOW_S seconds)
DRIFT_CELLS, DRIFT_FEATURES, DRIFT_SIGMA, DRIFT_REPEAT = 3, 12, 3.0, 2
DRIFT_WINDOW_S = 1.0
# kill-anywhere resume (A3): the staged cell's binary form at the training
# cell's widths and settings (d 54, recursive cells of 2000, 5 folds, the
# 10 x 10 grid, SOLVER_POLISH 2, nplSVM with 5 weights), cut to RESUME_N
# rows (7 cells) in waves of RESUME_WAVE slots: 3 waves; killed at
# RESUME_KILLS (site, hit) and rerun, and once rerun over a complete
# directory with one shard's byte flipped (RESUME_CORRUPT_WAVE).  FISTA
# is capped at RESUME_ITERS iterations, not the session's 1000: the phase
# solves 15 waves, each its FISTA iterations (most solves run to the cap,
# C4), and holds bits, counts and launches, which the cap leaves alone
RESUME_N, RESUME_HELDOUT, RESUME_WAVE = 9000, 2000, 3
RESUME_ITERS = 250
RESUME_KILLS = (("trainer.wave.start", 2), ("trainer.wave.solved", 1),
                ("checkpoint.save.pre_rename", 2))
RESUME_CORRUPT_WAVE = 1
RESUME_DIR = ROOT / "build" / "chip_smoke_resume"
# C7: gemma3-4b at its published widths (hf:google/gemma-3-4b-pt: 34
# layers, d_model 2560, head_dim 256, a 1024-token window on 28 layers) in
# bf16, seed-initialised; 2 sequences of 2048 tokens (past the window)
GEMMA_ARCH, GEMMA_B, GEMMA_T = "gemma3-4b", 2, 2048

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
# B9's CUDA-core (f32) kernel at jamba's prefill shape: (B, T = S, H, Hk, D)
JAMBA_F32_B9 = (2, 2048, 32, 8, 128)
# kernels vs the plain path through the bf16 backbone, relative to the
# largest |value|: B9 and the plain attention agree to f32 rounding before
# each layer rounds its output to bf16, so a value next to a rounding
# boundary may land one bf16 ulp (2^-8 relative) away, and the 24 layers
# that follow carry such flips (PERF.md, LM slice)
LM_EMBED_TOL = 3e-2
LM_LOGIT_TOL = 3e-2
# the dense-attention families: stablelm-12b at its published widths
# (hf:stabilityai/stablelm-2-12b: 40 layers, d_model 5120, 32 heads of 160,
# 8 kv heads, d_ff 13824, vocab 100352, bf16; ~24 GB), 2 sequences of 2048
# tokens embedded and then FAM_NEW tokens generated with bf16 and int8
# caches; hubert-xlarge at its published widths (arXiv:2106.07447: 48
# layers, d_model 1280, 16 heads of 80, bidirectional, frames of 512
# features), 4 sequences of 1024 frames through encode and the extractor;
# internvl2-76b and command-r-plus-104b (76 B and 104 B: beyond one card)
# at their smoke configs, the card against the CPU
FAM_12B, FAM_B, FAM_T, FAM_NEW = "stablelm-12b", 2, 2048, 8
FAM_HUBERT, FAM_HB, FAM_HT = "hubert-xlarge", 4, 1024
FAM_SMOKE = ("internvl2-76b", "command-r-plus-104b")
# f32 smoke configs, card against CPU: the same products summed in another
# order through a dozen ops (test_torch_lm measured 7.7e-7 relative on the
# CPU against the reference); 1e-4 of the largest |value|
FAM_SMOKE_TOL = 1e-4
# hubert-xlarge's bf16 logits at every position (4 x 1024 x 504): the
# plain path moves them by 110-112 % of LM_LOGIT_TOL when only its own f32
# sums run in another order (keys permuted), and the kernel path lies at
# 1.01-1.05 x that floor (measured on one H100 by lm_families, which
# measures the floor under FAM_PERMUTATIONS in every run); so the 48-layer
# bf16 encode is held within the larger of LM_LOGIT_TOL and
# FAM_NOISE_FACTOR x the larger floor, and its first FAM_DEPTHS[0] layers
# (54 % of LM_LOGIT_TOL) within LM_LOGIT_TOL; the other depths are
# reported; in f32 the same model is held within FAM_SMOKE_TOL
FAM_PERMUTATIONS = (SEED, SEED + 1)
FAM_NOISE_FACTOR = 1.25
FAM_DEPTHS = (12, 24, 36)
# rwkv6-1.6b (attention-free) at its published widths (arXiv:2404.05892:
# 24 layers, d_model 2048, 32 heads of 64, d_ff 7168, vocab 65536, bf16;
# ~3.0 GB), seed-initialised: a prefill of 2 x 2048 tokens at the config's
# chunk of 128, then RWKV_NEW greedy tokens; the state after a prefill of
# the first RWKV_STATE_T tokens against stepping them one by one, in f32
# (the same weights widened exactly), within RWKV_STATE_TOL of the largest
# |value| (f32 sums in another order through 24 layers, as FAM_SMOKE_TOL),
# and the f32 logits at the RWKV_ALT_CHUNKS (the same function, its sums
# regrouped) against chunk 128's within the same tolerance.  bf16 against
# the f32 path: every projection and the residual stream round to bf16,
# and the deviation grows with depth (measured on one H100: 2.6e-2 of the
# largest |logit| at 6 layers, 6.2e-2 at 24; the JAX package's own bf16
# path sits as far from its f32 path on the CPU, 2.1e-2 at 8 smoke
# layers), so the first RWKV_GATE_DEPTH layers are held within
# LM_LOGIT_TOL, and the 24 layers within the larger of LM_LOGIT_TOL and
# FAM_NOISE_FACTOR x the bf16 path's deviation from the f32 path at the
# other chunks (chunk 128, the config's, where the reference overflows,
# must not stand out: C10); extractor rows over RWKV_EX_N sequences of
# RWKV_EX_T in blocks of RWKV_B
RWKV_ARCH, RWKV_B, RWKV_T, RWKV_NEW = "rwkv6-1.6b", 2, 2048, 32
RWKV_STATE_T, RWKV_STATE_TOL = 64, 1e-4
RWKV_ALT_CHUNKS, RWKV_GATE_DEPTH = (32, 64, 256), 6
RWKV_EX_N, RWKV_EX_T = 5, 512
# LM training on one card: every ported architecture's smoke config in f32,
# one train step on the card against the CPU (loss within 1e-5 relative,
# every gradient leaf within FAM_SMOKE_TOL of its largest |value|); then
# stablelm-1.6b at full width under ``Trainer`` with the fp32 policy
# (~26 GB of parameters and AdamW state): TRAIN_STEPS steps of
# TRAIN_BATCH x TRAIN_SEQ tokens in TRAIN_ACCUM micro-batches, once
# uninterrupted and once killed before step TRAIN_FAIL_AT and resumed from
# its step-TRAIN_EVERY checkpoint under TRAIN_DIR (removed at the start and
# the end): the final state bitwise equal, under
# torch.use_deterministic_algorithms(True)
# the MoE and mamba mixers at their published widths, seed-initialised in
# bf16, with the depth cut to whole periods so that one card holds them
# (the published depths are 52-400 B parameters): jamba-v0.1-52b
# (hf:ai21labs/Jamba-v0.1: d_model 4096, 32 heads of 128, 8 kv heads, one
# attention and seven mamba layers a period of 8, 16 experts of 14336
# top-2 on every second layer) at one period, 13.3 B parameters;
# qwen3-moe-235b-a22b (hf:Qwen/Qwen3-235B-A22B: d_model 4096, 64 heads of
# 128, 4 kv heads: G 16, qk-norm, 128 experts of 1536 top-8) at 2 of its
# 94 layers, 6.2 B; llama4-maverick-400b-a17b
# (hf:meta-llama/Llama-4-Maverick-17B-128E: d_model 5120, 40 heads of
# 128, 8 kv heads: G 5, a dense layer and a MoE layer of 128 experts of
# 8192 top-1 with a shared expert) at one period of 2, 18.5 B.  Each: a
# prefill of MOE_B x MOE_T tokens, then (arch, layers, new tokens)
# generated with bf16 and int8 caches.  Routing flips between the kernel
# and the plain attention path must be near-ties within MOE_FLIP_SLACK of
# the logits' f32 rounding (``routing_flips``); jamba's mamba layer in
# f32 stepped against its prefill within MAMBA_STATE_TOL (RWKV_STATE_TOL's
# reasoning), also at chunk MAMBA_ALT_CHUNK; extractor rows over
# MOE_EX_N x MOE_EX_T tokens in blocks of MOE_EX_B (a ragged tail) read
# in chunks of MOE_EX_CHUNKS
MOE_JAMBA = "jamba-v0.1-52b"
MOE_MODELS = ((MOE_JAMBA, 8, 32), ("qwen3-moe-235b-a22b", 2, 16),
              ("llama4-maverick-400b-a17b", 2, 16))
MOE_B, MOE_T, MOE_NEW_JAMBA = 2, 2048, 32
MOE_FLIP_SLACK = 1e-5
MAMBA_STATE_T, MAMBA_STATE_TOL, MAMBA_ALT_CHUNK = 64, 1e-4, 16
MOE_EX_N, MOE_EX_T, MOE_EX_B, MOE_EX_CHUNKS = 4, 512, 3, (2, 3)
TRAIN_ARCH, TRAIN_SEQ, TRAIN_BATCH, TRAIN_ACCUM = "stablelm-1.6b", 1024, 8, 2
TRAIN_STEPS, TRAIN_EVERY, TRAIN_FAIL_AT = 4, 2, 3
# the kill and resume run at full width with the depth cut to 4 layers:
# its checkpoints hold 8.6 GB, not the full depth's 23 GB (whose two saves
# and one restore took ~135 s on an H100 machine)
TRAIN_RESUME_LAYERS = 4
TRAIN_DIR = ROOT / "build" / "chip_smoke_lm_train"
# several devices (A4): the training cell's widths and settings on
# covtype_like rows cut to one wave of MESH_SLOTS slots (MESH_N rows give
# 16 recursive cells of <= 2000, k_max 1896), MESH_HELDOUT held out; the
# LM step is stablelm-1.6b's (TRAIN_*) with FSDP specs and sharded
# activations; files under MESH_DIR (removed at the start and the end)
MESH_N, MESH_HELDOUT, MESH_SLOTS = 19600, 2000, 16
MESH_DIR = ROOT / "build" / "chip_smoke_mesh"
MESH_LOSS_TOL, MESH_PARAM_TOL = 2e-4, 5e-3   # test_torch_lm_mesh.py's
MESH_EF_SAMPLE = 1 << 16   # positions a leaf held against the CPU's ef_psum
# two ranks on one card: NCCL refuses two ranks on one device, so both
# CPU and CUDA tensors go through gloo (staged through the host)
MESH_TWO_BACKEND = "cpu:gloo,cuda:gloo"
# every fit of the phase packs its cells for the two ranks, so the fit
# without a mesh solves, in one process, the very wave the ranks split
MESH_PACK = 2
# head-parallel prefill (A4b): stablelm-1.6b (LM_ARCH) at full width over
# a (1, 2) ("data", "model") mesh of two ranks on the one card, each rank
# its 16 of the 32 heads, on MESH_PREFILL_B x MESH_PREFILL_T tokens; B9 at
# every config's local heads at the production mesh on LOCAL_HEADS_T
# tokens of one row
MESH_PREFILL_B, MESH_PREFILL_T = 4, 512
LOCAL_HEADS_T = 4096
# then MESH_DECODE_NEW tokens decoded with the prompt's cache split over
# the sequence on the two ranks (flash-decoding with B10's partials), a
# ring of MESH_PREFILL_T + MESH_DECODE_NEW slots, 258 a rank
MESH_DECODE_NEW = 4
# earlier figures of this script on the same card, printed beside this
# run's: the phase before the split decode was added, and the (1, 1)
# meshed LM step and the unsharded one before the dense parts ran as
# regions
MESH_PREFILL_BEFORE_S = 25.1
MESH_STEP_BEFORE_S = {"mesh": 5.62, "unsharded": 1.84}
# attention by head group (A4): gemma3-4b at its published widths, depth
# cut to one period (UNEVEN_LAYERS: 5 sliding-window layers and 1 global),
# over a (1, 16) ("data", "model") mesh of 16 ranks on the one card
# (MESH_TWO_BACKEND): 16 is the least 'model' size that leaves its 8 heads
# uneven (8 groups of 2 ranks, a head each, each rank one of its group's
# UNEVEN_B rows); a prefill of UNEVEN_B x UNEVEN_T tokens, longer than
# the 1024 window, then MESH_DECODE_NEW decode steps on its cache split
# over the sequence (a ring of UNEVEN_T + MESH_DECODE_NEW, 129 a rank);
# the weights drawn on the card in row chunks of UNEVEN_CHUNK, each chunk
# from its own seed, so that a rank keeps its block and never holds the
# whole model (rank 0 alone runs the unsharded model)
UNEVEN_ARCH, UNEVEN_LAYERS, UNEVEN_MESH = "gemma3-4b", 6, (1, 16)
UNEVEN_B, UNEVEN_T = 2, 2048
UNEVEN_CHUNK = 16384
# the examples run on the card at their defaults (examples/<name>.py)
EXAMPLES = ("torch_quickstart", "torch_serve_svm")

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
    # B10's partials mode: flash-decoding over a cache split over the
    # sequence (the reference's split-sequence decode executor)
    "decode_attention_partials": (
        "src/repro_torch/csrc/decode_attention.cu",
        "src/repro/kernels/decode_attention/decode_attention.py:78"),
    "assign": ("src/repro_torch/csrc/assign.cu",
               "src/repro/pipeline/assign.py:237"),
    "gram": ("src/repro_torch/csrc/kernel_matrix.cu",
             "src/repro/kernels/kernel_matrix/kernel_matrix.py:62"),
    "svm_predict": ("src/repro_torch/csrc/svm_predict.cu",
                    "src/repro/kernels/svm_predict/svm_predict.py:63"),
}


_T0 = time.perf_counter()
PHASE_END_S = {}    # phase -> seconds since the start when it was emitted


def emit(obj: dict) -> None:
    if obj.get("phase") not in (None, "check"):
        PHASE_END_S[obj["phase"]] = time.perf_counter() - _T0
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


def _snap(v):
    """A copy of ``v`` that later in-place writes cannot reach."""
    if hasattr(v, "detach"):
        return v.detach().clone()
    if isinstance(v, (tuple, list)):
        return type(v)(_snap(a) for a in v)
    if isinstance(v, dict):
        return {k: _snap(a) for k, a in v.items()}
    return v


@contextlib.contextmanager
def recorded(mod, name: str, calls: list, keep: int = None, device=None,
             snap: bool = True, key=None):
    """Inside, every call of ``mod.name`` also appends ``(args, kwargs,
    out)`` to ``calls``: copies taken before and after the call (``snap``),
    else the arguments themselves and no output.  Only the first ``keep``
    calls (of each ``key(args, kwargs)`` where ``key`` is given), and with
    ``device`` only calls whose first argument lies there.  So a path's
    own launches can be replayed against their plain versions or timed at
    their shapes; the counts stay the wrapper's."""
    inner = getattr(mod, name)
    taken = collections.Counter()

    def rec(*args, **kwargs):
        k = None if key is None else key(args, kwargs)
        take = ((keep is None or taken[k] < keep)
                and (device is None or args[0].device == device))
        if not take:
            return inner(*args, **kwargs)
        taken[k] += 1
        if not snap:
            calls.append((args, kwargs, None))
            return inner(*args, **kwargs)
        before = _snap((args, kwargs))
        out = inner(*args, **kwargs)
        calls.append((*before, _snap(out)))
        return out
    setattr(mod, name, rec)
    try:
        yield calls
    finally:
        setattr(mod, name, inner)


def _sym(args, kw) -> bool:
    """Whether a recorded ``sq_dists`` call is B1's symmetric body."""
    return bool(kw.get("symmetric", args[2] if len(args) > 2 else False))


def replay_kernels(torch, label: str, rec: dict, expect: dict) -> dict:
    """A path's recorded launches (``rec``: lists of ``recorded`` calls of
    "sq_dists", "gram_from_d2" and the B4 driver "cd", ``cd_ops._epochs``)
    against their plain versions on the same operands on the card: B1
    within 64 ulps of the largest |x|^2 + |z|^2 (B1-sym also bitwise
    symmetric), B2 within 8 ulps of K <= 1 (one bf16 ulp on a bf16 write),
    B4 bitwise equal to the plain exact sweep.  ``expect``: kernel -> the
    count of launches that must have been replayed.  Returns each
    kernel's worst error and that count."""
    from repro_torch.kernels.cd_solver.ref import cd_wave_epoch_ref
    from repro_torch.kernels.kernel_matrix.ref import (gram_from_d2_ref,
                                                       sq_dists_ref)
    eps = float(np.finfo(np.float32).eps)
    errs, n = collections.defaultdict(float), collections.Counter()

    def note(name, err, tol, **extra):
        errs[name] = max(errs[name], check(f"{label}: {name}", err, tol,
                                           **extra))
        n[name] += 1

    for args, kw, out in rec.get("sq_dists", []):
        x, z = args[:2]
        sym = _sym(args, kw)
        want = sq_dists_ref(x, z, symmetric=sym)
        tol = 64 * eps * float((x * x).sum(-1).max() + (z * z).sum(-1).max())
        if sym and not torch.equal(out, out.transpose(-1, -2)):
            raise Mismatch(f"{label}: sq_dists_sym not bitwise symmetric")
        note("sq_dists_sym" if sym else "sq_dists",
             float((out - want).abs().max()), tol, shape=list(out.shape))
    for args, kw, out in rec.get("gram_from_d2", []):
        d2, gamma = args[:2]
        kind = kw.get("kind", args[2] if len(args) > 2 else "gauss_rbf")
        dout = kw.get("out_dtype", args[3] if len(args) > 3 else "f32")
        if d2.dim() == 3:
            want = gram_from_d2_ref(d2[:, None], gamma[:, :, None, None],
                                    kind, dout)
        else:
            want = gram_from_d2_ref(d2, gamma, kind, dout)
        note("gram_from_d2", float((out.float() - want.float()).abs().max()),
             2.0 ** -8 if dout == "bf16" else 8 * eps, shape=list(out.shape))
    for (k, c, g, lo, hi, epochs, _), _, (oc, og) in rec.get("cd", []):
        for _ in range(epochs):
            c, g = cd_wave_epoch_ref(k, c, g, lo, hi)
        same = bool(torch.equal(oc, c) and torch.equal(og, g))
        note("cd_wave_epoch", float(max((oc - c).abs().max(),
                                        (og - g).abs().max())), 0.0,
             shape=list(oc.shape), epochs=epochs, bitwise=same)
        if not same:
            raise Mismatch(f"{label}: cd_wave_epoch not bitwise the plain "
                           f"sweep")
    if dict(n) != expect:
        raise Mismatch(f"{label}: replayed {dict(n)}, expected {expect}")
    return {"max_abs_err": dict(errs), "replayed": dict(n)}


@contextlib.contextmanager
def recorded_kernels(dev, keep: int = None, by_body: bool = False):
    """``recorded`` over B1 (and B1-sym), B2 and B4's driver at once, on
    the card's operands: yields the dict ``replay_kernels`` takes.
    ``by_body``: ``keep`` counts B1 and B1-sym apart."""
    from repro_torch.kernels.cd_solver import ops as cd_ops
    from repro_torch.kernels.kernel_matrix import ops as km_ops
    rec = {"sq_dists": [], "gram_from_d2": [], "cd": []}
    with contextlib.ExitStack() as st:
        for mod, name, slot in ((km_ops, "sq_dists", "sq_dists"),
                                (km_ops, "gram_from_d2", "gram_from_d2"),
                                (cd_ops, "_epochs", "cd")):
            st.enter_context(recorded(
                mod, name, rec[slot], keep=keep, device=dev,
                key=_sym if by_body and slot == "sq_dists" else None))
        yield rec


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
    wave's shapes.  B1-sym: bitwise equal to its transpose and to B1(x,
    x), and within B1's 64 ulps of the largest |x|^2 + |z|^2 of the plain
    0.5 (D + D^T).
    B4: CD_EPOCHS epochs bitwise equal to the plain exact sweep on the
    card (every operation rounded on its own on both sides).  B5: each of
    three slots alone (its folds' columns side by side, K shared) bitwise
    equal to B4's result for that slot."""
    from repro_torch.kernels.cd_solver import ops as cd_ops
    from repro_torch.kernels.cd_solver import ref as cd_ref
    from repro_torch.kernels.kernel_matrix import ops as km_ops
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
    cross = km_ops.sq_dists(x_w, x_w)
    torch.cuda.synchronize()
    same = bool(torch.equal(d2, cross))
    check("sq_dists_sym vs sq_dists(x, x)", float((d2 - cross).abs().max()),
          0.0, shape=list(d2.shape), bitwise=same)
    if not same:
        raise Mismatch("sq_dists_sym: not bitwise B1(x, x)")
    del cross

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


def small_fit_run(device) -> dict:
    """The small fit on ``device``: what ``small_fit_parity`` compares
    (numpy), and its seconds."""
    import torch  # noqa: F401  (the CPU process's first import)
    from repro_torch.data.synthetic import covtype_like
    from repro_torch.train.svm_trainer import LiquidSVM, SVMTrainerConfig
    x, y = covtype_like(n=SMALL_N, d=54, n_classes=N_CLASSES, seed=SMALL_SEED)
    t0 = time.perf_counter()
    tr = LiquidSVM(SVMTrainerConfig(**SMALL_CFG), device=device).fit(
        x, y).train_result
    secs = time.perf_counter() - t0
    return {"plan": {f: np.asarray(getattr(tr.plan, f)) for f in
                     ("indices", "mask", "owner", "centers")},
            "n_cells": tr.plan.n_cells, "k_max": tr.plan.k_max,
            "fold_keys": np.asarray(tr.fold_keys),
            "mask_cells": np.asarray(tr.mask_cells),
            "surf_loss": np.asarray(tr.surf_loss),
            "iters": np.asarray(tr.iters), "seconds": secs}


def small_fit_parity(torch, dev, cpu: dict, make_fold_masks,
                     argmin_winners):
    """The small fit on the CPU (``cpu``: ``small_fit_run("cpu")``, run
    beside the build) and on the card: the same plan and fold
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
    a, b = cpu, small_fit_run(dev)
    for field in ("indices", "mask", "owner", "centers"):
        if not np.array_equal(a["plan"][field], b["plan"][field]):
            raise Mismatch(f"small fit: cell plans differ in {field}")
    if not np.array_equal(a["fold_keys"], b["fold_keys"]):
        raise Mismatch("small fit: fold keys differ")
    mask = torch.as_tensor(a["mask_cells"])
    vm_cpu = make_fold_masks(a["fold_keys"], mask, SMALL_CFG["n_folds"])
    vm_dev = make_fold_masks(b["fold_keys"], mask.to(dev),
                             SMALL_CFG["n_folds"]).cpu()
    if not torch.equal(vm_cpu, vm_dev):
        raise Mismatch("small fit: fold masks differ")
    par = surface_parity(vm_cpu, a["mask_cells"], a["surf_loss"],
                         b["surf_loss"], argmin_winners)
    emit({"phase": "small_fit", "n": SMALL_N, "cells": a["n_cells"],
          "k_max": a["k_max"], "cpu_s": a["seconds"],
          "card_s": b["seconds"], "plans_equal": True,
          "fold_masks_equal": True, **par,
          "iters_cpu_median": float(np.median(a["iters"])),
          "iters_card_median": float(np.median(b["iters"]))})
    if not par["ok"]:
        raise Mismatch(f"small fit: surfaces or selections apart {par}")


def surface_parity(vmask, mask_cells, surf_a, surf_b, argmin_winners
                   ) -> dict:
    """Two runs' validation surfaces of the same slots and folds (``vmask``
    the (slots, F, k) validation masks): within FLIP_SHARE of each
    column's validation samples (see ``small_fit_parity``), and every flip
    of a selected (gamma, lambda) within one validation sample's share of
    that column's loss.  Returns the measured values and ``ok``."""
    # one validation sample's share of a column's loss (mean over folds of
    # each fold's mean), per slot; OvA columns share the slot's mask
    n_folds = vmask.shape[1]
    n_val = vmask.sum(-1).clamp(min=1).double().numpy()        # (slots, F)
    share = (1.0 / (n_folds * n_val)).max(-1)                  # (slots,)
    per_col = np.maximum(np.ceil(FLIP_SHARE * mask_cells.sum(-1)), 1.0)
    diff = np.abs(surf_a.astype(np.float64) - surf_b)
    flips_eq = diff / share[:, None, None, None, None]         # samples
    ok_surf = bool((flips_eq <= per_col[:, None, None, None, None]
                    + 1e-3).all())
    ga, la = argmin_winners(surf_a)
    gb, lb = argmin_winners(surf_b)
    moved = (ga != gb) | (la != lb)
    gaps = []
    for si, t, u in zip(*np.nonzero(moved)):
        wa = (si, ga[si, t, u], t, la[si, t, u], u)   # the first's winner
        wb = (si, gb[si, t, u], t, lb[si, t, u], u)   # the second's
        # what each run loses, on its own surface, by taking the other's
        gaps.append(max(float(surf_a[wb]) - float(surf_a[wa]),
                        float(surf_b[wa]) - float(surf_b[wb]))
                    / share[si])
    return {"surface_max_abs_diff": float(diff.max()),
            "surface_mean_abs_diff": float(diff.mean()),
            "surface_max_flipped_samples": float(flips_eq.max()),
            "surface_flip_limit": per_col.tolist(),
            "selections": int(moved.size),
            "selection_flips": int(moved.sum()),
            "flip_gaps_in_samples": gaps,
            "ok": ok_surf and all(g <= 1.0 + 1e-3 for g in gaps)}


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

    # test phase through decision_function (B1 + B2 + one product); B1's
    # operands kept for the kernel table
    from repro_torch.kernels.kernel_matrix import ops as km_ops
    zero_counts(tables)
    with recorded(km_ops, "sq_dists", [], snap=False) as calls:
        dec_df = model.decision_function(xt)
        err_df = model.error(xt, yt)
    test_counts = read_counts(tables)
    if not (test_counts["sq_dists"] and test_counts["gram_from_d2"]) or any(
            n for k, n in test_counts.items()
            if k not in ("sq_dists", "gram_from_d2")):
        raise Mismatch(f"decision_function launched {test_counts}; it "
                       f"launches B1 and B2 only")
    return (model, fit_counts, test_counts, dec_df, err_df,
            calls[0][0][:2])


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
    emit({"phase": "fista_profile", "iters": FISTA_PROFILE_ITERS,
          **_profile(torch, run, top=6),
          "kc_product_ms": cuda_ms(torch, lambda: cd_ops.slot_matmul(kk, c0),
                                   iters=10)})


# ------------------------------------------------------------ LM slice
def _np_rule(select_mod, tr, rule: str, alpha: float):
    """A rule's winners over a TrainResult's surface (the select stage's
    own call), for comparing two runs' winners."""
    ctx = select_mod.SelectContext(
        scenario=tr.config.scenario,
        weights=np.asarray(tr.config.weights, np.float32),
        taus=np.asarray(tr.config.taus, np.float32), alpha=alpha)
    return select_mod.get_rule(rule)(tr.surface(), ctx)


def _moved(sel, tr) -> np.ndarray:
    return (sel.gamma != tr.gamma) | (sel.lam != tr.lam)


def _binary(y: np.ndarray) -> np.ndarray:
    return np.where(y == 0, -1.0, 1.0).astype(np.float32)


def staged_small_run(device) -> dict:
    """An nplSVM session at n ~ 1000 on ``device``: train, select, decide
    the held-out rows; what ``staged_small`` compares (numpy, plain
    values) and the seconds."""
    from repro_torch.api import nplSVM
    from repro_torch.core import select as select_mod
    from repro_torch.data.synthetic import covtype_like, covtype_like_heldout
    x, y = covtype_like(n=SMALL_N, d=DIM, n_classes=2, seed=SMALL_SEED)
    xt, _ = covtype_like_heldout(2000, n=SMALL_N, d=DIM, n_classes=2,
                                 seed=SMALL_SEED, new_seed=HELDOUT_SEED)
    sess = nplSVM(x, _binary(y), constraint=STAGED_ALPHA, device=device,
                  **STAGED_SMALL_KEYS)
    t0 = time.perf_counter()
    tr = sess.train()
    t1 = time.perf_counter()
    sel = sess.select()
    t2 = time.perf_counter()
    npl = _np_rule(select_mod, tr, "npl", STAGED_ALPHA)
    return {"plan": {f: np.asarray(getattr(tr.plan, f)) for f in
                     ("indices", "mask", "owner", "centers")},
            "n_cells": tr.plan.n_cells, "k_max": tr.plan.k_max,
            "weights": list(tr.config.weights),
            "argmin": [np.asarray(w) for w in
                       select_mod.argmin_winners(tr.surf_loss)],
            "npl": [np.asarray(npl.g_idx), np.asarray(npl.l_idx),
                    np.asarray(npl.extras["np_weight_idx"])],
            "moved": np.asarray(_moved(sel, tr)), "stats": dict(sel.stats),
            "decisions": np.asarray(sel.decision_function(xt)),
            "train_s": t1 - t0, "select_s": t2 - t1}


def staged_small(dev, cpu: dict):
    """An nplSVM session at n ~ 1000 on the CPU (``cpu``:
    ``staged_small_run("cpu")``, run beside the build) and on the card:
    the same plans, the same argmin and npl winners, the same moved set
    and ``stats`` counts (iterations aside), re-solved decisions within
    RESOLVE_TOL of the largest."""
    a, b = cpu, staged_small_run(dev)
    for field in ("indices", "mask", "owner", "centers"):
        if not np.array_equal(a["plan"][field], b["plan"][field]):
            raise Mismatch(f"staged_small: cell plans differ in {field}")
    same_argmin = all(np.array_equal(u, v)
                      for u, v in zip(a["argmin"], b["argmin"]))
    same_npl = all(np.array_equal(u, v) for u, v in zip(a["npl"], b["npl"]))
    same_moved = bool(np.array_equal(a["moved"], b["moved"]))
    sa, sb = a["stats"], b["stats"]
    da, db = a["decisions"], b["decisions"]
    counts = ("winners_moved", "columns_resolved", "resolve_calls",
              "grid_columns")
    same_stats = all(sa[k] == sb[k] for k in counts)
    scale = max(1.0, float(np.abs(da).max()))
    err = float(np.abs(da - db).max())
    ok = (same_argmin and same_npl and same_moved and same_stats
          and err <= RESOLVE_TOL * scale)
    emit({"phase": "staged_small", "n": SMALL_N, "cells": a["n_cells"],
          "k_max": a["k_max"], "weights": a["weights"],
          "cpu_train_s": a["train_s"], "card_train_s": b["train_s"],
          "cpu_select_s": a["select_s"], "card_select_s": b["select_s"],
          "plans_equal": True, "argmin_winners_equal": same_argmin,
          "npl_winners_equal": same_npl, "moved_equal": same_moved,
          "stats_cpu": sa, "stats_card": sb,
          "decisions_max_abs_err": err, "tol": RESOLVE_TOL * scale,
          "ok": ok})
    if not ok:
        raise Mismatch("staged_small: the CPU and the card disagree "
                       "(see the phase line)")


def _dir_bytes(path: Path) -> int:
    return sum(f.stat().st_size for f in path.rglob("*") if f.is_file())


def _drifted_batch(bank, eng, xq, targets):
    """Queries of ``targets`` moved DRIFT_SIGMA (scaled units) away from
    their cell's center on DRIFT_FEATURES features; only rows that still
    route to their cell are kept.  Returns raw rows and their row ids."""
    xs = (xq - bank.feat_mean) / bank.feat_std
    owner = eng.route(xs)
    feats = np.arange(DRIFT_FEATURES)
    rows, ids = [], []
    for c in targets:
        sel = np.flatnonzero(owner == c)
        moved = xs[sel].copy()
        side = np.sign(moved[:, feats] - bank.centers[c, feats])
        moved[:, feats] += DRIFT_SIGMA * np.where(side == 0, 1.0, side)
        keep = eng.route(moved.astype(np.float32)) == c
        if keep.sum() < 8:
            raise Mismatch(f"drifted batch: only {int(keep.sum())} moved "
                           f"rows of cell {c} still route to it")
        rows.append(moved[keep] * bank.feat_std + bank.feat_mean)
        ids.append(sel[keep])
    return np.concatenate(rows).astype(np.float32), np.concatenate(ids)


def staged(torch, dev, nplSVM, covtype_like, covtype_like_heldout, tables,
           refs, session_mod, ModelBank, refresh_drifted):
    """The whole staged session at full width: train, select under npl
    (two alphas), roc and argmin, test, save and load of both results and
    the bank, serving with a health monitor, a drifted batch, the refresh
    of exactly the drifted slots and a hot swap.  Each step's launches are
    counted on their own and held to the counts the code fixes."""
    x, y = covtype_like(n=TRAIN_N, d=DIM, n_classes=2, seed=SEED)
    xt, yt = covtype_like_heldout(HELDOUT_N, n=TRAIN_N, d=DIM, n_classes=2,
                                  seed=SEED, new_seed=HELDOUT_SEED)
    y, yt = _binary(y), _binary(yt)
    sess = nplSVM(x, y, constraint=STAGED_ALPHA, device=dev, **STAGED_KEYS)
    cfg = sess.config
    out = {"n": int(x.shape[0]), "heldout": int(xt.shape[0]),
           "weights": list(cfg.weights)}
    paths = {}

    def timed(label, fn):
        zero_counts(tables)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        out[f"{label}_s"] = time.perf_counter() - t0
        paths[label] = read_counts(tables)
        return res

    def resolves(label, st):
        """A select (or refresh) launches B1 and B2 once and B4
        ``cd_polish`` times per re-solve call, and nothing else."""
        n = st["resolve_calls"]
        if n != STAGED_RESOLVE_CALLS[label]:
            raise Mismatch(f"{label}: {n} re-solve calls, expected "
                           f"{STAGED_RESOLVE_CALLS[label]}")
        require_launches(label, paths[label], {
            "sq_dists": n, "gram_from_d2": n,
            "cd_wave_epoch": cfg.cd_polish * n})

    # the fit's first B1-sym, B2 and B4 launches are kept for their replay
    with recorded_kernels(dev, keep=1) as fit_rec:
        tr = timed("fit", sess.train)
    n_waves = -(-tr.packed.n_slots // cfg.n_slots_per_wave)
    n_gamma = tr.gammas_cells.shape[1]
    require_launches("staged fit", paths["fit"], {
        "sq_dists_sym": n_waves, "gram_from_d2": n_gamma * n_waves,
        "cd_wave_epoch": cfg.cd_polish * n_gamma * n_waves})
    out["fit_replay"] = replay_kernels(torch, "staged fit", fit_rec, {
        "sq_dists_sym": 1, "gram_from_d2": 1, "cd_wave_epoch": 1})
    out.update(cells=tr.plan.n_cells, k_max=tr.plan.k_max,
               slots=tr.packed.n_slots, waves=n_waves,
               columns=int(tr.lambdas.size * len(cfg.weights)))

    sel = timed("select_npl", sess.select)
    resolves("select_npl", sel.stats)
    if sel.rule != "npl" or sel.stats["winners_moved"] == 0:
        raise Mismatch(f"staged: npl moved no winner ({sel.stats})")
    sel_2 = timed("select_npl_2",
                  lambda: sess.select("npl", alpha=STAGED_ALPHA_2))
    resolves("select_npl_2", sel_2.stats)
    sel_roc = timed("select_roc", lambda: sess.select("roc"))
    require_launches("select_roc", paths["select_roc"], {})
    if sel_roc.stats["resolve_calls"] != 0:
        raise Mismatch(f"staged: roc re-solved ({sel_roc.stats})")
    sel_arg = timed("select_argmin", lambda: sess.select("argmin"))
    require_launches("select_argmin", paths["select_argmin"], {})
    if not (np.array_equal(sel_arg.coefs, tr.coefs)
            and sel_arg.stats["resolve_calls"] == 0):
        raise Mismatch("staged: argmin does not return to the cache bitwise")
    # the moved columns only: every other column keeps the cached model
    keep = ~_moved(sel, tr)
    if not np.array_equal(np.moveaxis(sel.coefs, 1, -1)[keep],
                          np.moveaxis(tr.coefs, 1, -1)[keep]):
        raise Mismatch("staged: npl changed a column it did not move")
    # back to the session's own rule (npl at STAGED_ALPHA) for the test,
    # the bank and serving: the same work as the first select
    sel_again = timed("select_npl_again", sess.select)
    resolves("select_npl_again", sel_again.stats)
    out["reselect_bitwise"] = bool(np.array_equal(sel_again.coefs,
                                                  sel.coefs))
    sel = sel_again
    out["select_replay"] = resolve_replay(torch, dev, sess, sel)
    out["select_profile"] = _profile(torch, sess.select)
    for label, st in (("npl", sel.stats), ("npl_2", sel_2.stats),
                      ("roc", sel_roc.stats), ("argmin", sel_arg.stats)):
        out[f"stats_{label}"] = st

    with recorded_kernels(dev) as test_rec:
        res = timed("test", lambda: sess.test(xt, yt))
    require_launches("staged test", paths["test"],
                     {"sq_dists": 1, "gram_from_d2": 1})
    out["test_replay"] = replay_kernels(torch, "staged test", test_rec,
                                        {"sq_dists": 1, "gram_from_d2": 1})
    out.update(heldout_error=res.error,
               heldout_false_alarm=res.details["false_alarm"],
               heldout_detection=res.details["detection"],
               validation_false_alarm=float(
                   sel.extras["np_fa"][0, sel.default_sub]),
               validation_detection=float(
                   sel.extras["np_det"][0, sel.default_sub]),
               np_weight=float(cfg.weights[sel.default_sub]))
    if not 0.0 < res.details["detection"] <= 1.0:
        raise Mismatch(f"staged test: detection {res.details}")

    # save and load: the CLI's layout (select/ refers to train/)
    shutil.rmtree(STAGED_DIR, ignore_errors=True)
    bank0 = sel.to_bank()
    t0 = time.perf_counter()
    tr.save(str(STAGED_DIR / "train"))
    sel.save(str(STAGED_DIR / "select"), train_ref="../train")
    bank0.save(str(STAGED_DIR / "bank"))
    t1 = time.perf_counter()
    tr_l = session_mod.TrainResult.load(str(STAGED_DIR / "train"),
                                        device=dev)
    sel_l = session_mod.SelectResult.load(str(STAGED_DIR / "select"),
                                          device=dev)
    bank_l = ModelBank.load(str(STAGED_DIR / "bank"))
    t2 = time.perf_counter()
    out.update(save_s=t1 - t0, load_s=t2 - t1, bytes={
        k: _dir_bytes(STAGED_DIR / k) for k in ("train", "select", "bank")})
    for k in session_mod.TrainResult._ARRAYS:
        if not np.array_equal(getattr(tr_l, k), getattr(tr, k)):
            raise Mismatch(f"staged: loaded TrainResult.{k} differs")
    if not (np.array_equal(sel_l.coefs, sel.coefs)
            and sel_l.default_sub == sel.default_sub):
        raise Mismatch("staged: loaded SelectResult differs")
    q = np.resize(xt, (N_REQ, DIM))
    dec_saved = serve(_engine_on(sess, bank0, dev), q)[0]
    if not np.array_equal(dec_saved, serve(_engine_on(sess, bank_l, dev),
                                           q)[0]):
        raise Mismatch("staged: the loaded bank's decisions differ")

    # serving with the health monitor, then the drifted batch
    eng = sess.engine()
    serve(eng, q)                                      # warm the shapes
    eng = sess.engine()
    bank0 = eng.bank
    mon = sess.monitor(eng, drift_window_s=DRIFT_WINDOW_S)
    timed("serve", lambda: serve(eng, q))
    out["rps_before_swap"] = N_REQ / out["serve_s"]
    require_launches("staged serve", paths["serve"],
                     {"svm_predict_cells": N_REQ // WAVE})
    before = mon.drifted_cells()
    xs = (xt - bank0.feat_mean) / bank0.feat_std
    traffic = np.bincount(eng.route(xs), minlength=bank0.n_cells)
    targets = sorted(int(c) for c in np.argsort(-traffic,
                                                kind="stable")[:DRIFT_CELLS])
    drifted_x, drifted_ids = _drifted_batch(bank0, eng, xt, targets)
    # the in-distribution traffic moves to the previous pane; a cell with
    # rows in the current pane is scored on those
    time.sleep(DRIFT_WINDOW_S * 1.2)
    for _ in range(DRIFT_REPEAT):
        serve(eng, drifted_x)
    health = mon.health()
    drifted = mon.drifted_cells()
    out.update(drift_targets=targets, drifted_cells=drifted,
               drifted_rows=int(drifted_x.shape[0]),
               drift_scores={str(c): health["drift"]["scores"].get(c)
                             for c in targets},
               max_other_score=max([v for c, v in
                                    health["drift"]["scores"].items()
                                    if c not in targets] or [0.0]),
               health_status=health["status"])
    if before or drifted != targets:
        raise Mismatch(f"staged: drifted_cells {drifted} (before the "
                       f"batch: {before}); the batch moved {targets}")

    # refresh exactly the drifted slots from a labelled feedback pool (the
    # drifted rows with their labels, and the held-out rows)
    x_feed = np.concatenate([drifted_x, xt])
    y_feed = np.concatenate([yt[drifted_ids], yt])
    bank1, info = timed("refresh", lambda: refresh_drifted(
        tr, sel, x_feed, y_feed, drifted, base_version=eng.bank.version))
    resolves("refresh", info)
    out["refresh"] = info
    if bank1 is None or bank1.version != bank0.version + 1:
        raise Mismatch(f"staged: refresh gave no newer bank ({info})")
    def same_slot(c: int) -> bool:
        """Slot c's live table rows, coefficients and gammas bitwise (the
        padded row count follows the largest slot)."""
        k = int(bank0.sv_count[c])
        return (int(bank1.sv_count[c]) == k
                and np.array_equal(bank0.sv[c, :k], bank1.sv[c, :k])
                and np.array_equal(bank0.coefs[c, :k], bank1.coefs[c, :k])
                and np.array_equal(bank0.gammas[c], bank1.gammas[c]))
    touched = [c for c in range(bank0.n_cells) if not same_slot(c)]
    out["refreshed_slots"] = touched
    if touched != drifted:
        raise Mismatch(f"staged: the refresh changed slots {touched}; "
                       f"drifted: {drifted}")

    eng.swap_bank(bank1)
    mon.reset_cells(drifted)
    dec1 = timed("serve_swapped", lambda: serve(eng, q)[0])
    out["rps_after_swap"] = N_REQ / out["serve_swapped_s"]
    require_launches("staged serve after the swap", paths["serve_swapped"],
                     {"svm_predict_cells": N_REQ // WAVE})
    want, bnd = plain_decisions(bank1, q, False, dev, **refs)
    check_bound("staged[refreshed engine] vs plain", dec1, want, bnd)
    unchanged = ~np.isin(eng.route((q - bank0.feat_mean) / bank0.feat_std),
                         drifted)
    out["queries_on_untouched_cells"] = int(unchanged.sum())
    out["launches"] = paths
    emit({"phase": "staged", **out})
    shutil.rmtree(STAGED_DIR, ignore_errors=True)
    return paths


def resolve_replay(torch, dev, sess, sel, label: str = "staged") -> dict:
    """One more select under the session's rule with every re-solve call
    recorded: the same coefficients bitwise as ``sel``; every call's B1,
    B2 and B4 launches against their plain versions (``replay_kernels``);
    and the call with the fewest cells solved again on the CPU through
    ``solve_columns_batched`` on the same operands, whose fold-mean
    columns must lie within RESOLVE_TOL of each column's box width of the
    card's (the box at the smallest fold training set, as
    test_torch_session holds the two packages), and their decisions on
    the cells' rows within RESOLVE_TOL of the largest."""
    from repro_torch.core import cv as cv_mod
    from repro_torch.core import kernel_fns
    from repro_torch.kernels import runtime
    solves = []
    with recorded_kernels(dev) as rec, \
            recorded(cv_mod, "solve_columns_batched", solves):
        again = sess.select()
    n = sel.stats["resolve_calls"]
    if not (np.array_equal(again.coefs, sel.coefs) and len(solves) == n):
        raise Mismatch(f"{label}: a repeated select re-solved other "
                       f"columns or made other calls")
    res = replay_kernels(torch, f"{label} select", rec, {
        "sq_dists": n, "gram_from_d2": n, "cd_wave_epoch": n})
    args, _, (mean, _, _) = min(solves, key=lambda r: r[0][0].shape[0])
    cpu = [a.cpu() if hasattr(a, "cpu") else a for a in args]
    t0 = time.perf_counter()
    with runtime.full_fp32():
        want = cv_mod.solve_columns_batched(*cpu)[0]
    cpu_s = time.perf_counter() - t0
    mask, lam, sub, cfg = cpu[3], cpu[5], cpu[6], cpu[10]
    f = cfg.n_folds
    n_eff = torch.clamp(torch.floor(mask.sum(-1) * (f - 1) / f) - 1,
                        min=1.0)
    box = torch.clamp(sub, min=1.0) / (2.0 * lam * n_eff[:, None])
    check_bound(f"{label} select: a re-solve on the CPU vs the card",
                mean.cpu(), want, RESOLVE_TOL * box[:, None].expand_as(want),
                shape=list(want.shape))
    # and the columns' decisions on the cells' rows, as staged_small
    # holds them: within RESOLVE_TOL of the largest
    kk = kernel_fns.get_spec(cfg.kernel).fn(cpu[0], cpu[0], cpu[4])
    dec_card, dec_cpu = kk @ mean.cpu(), kk @ want
    scale = max(1.0, float(dec_cpu.abs().max()))
    err = check(f"{label} select: re-solved decisions, CPU vs card",
                float((dec_card - dec_cpu).abs().max()), RESOLVE_TOL * scale,
                shape=list(dec_cpu.shape))
    res.update(cpu_resolve_cells=int(want.shape[0]),
               cpu_resolve_columns=int(want.shape[-1]),
               cpu_resolve_s=cpu_s, cpu_vs_card_decisions_max_abs_err=err,
               cpu_vs_card_coefs_max_abs_err=float(
                   (mean.cpu() - want).abs().max()))
    return res


def _resume_bits(sess, tr, xt):
    """Everything a resumed fit promises bitwise: the fit's arrays, the
    held-out decisions of its argmin selection, and an npl selection
    (re-solving moved winners from the back-filled slots) with its
    held-out decisions and stats.  Returns them and that selection."""
    out = {k: getattr(tr, k) for k in (
        "coefs", "gamma", "lam", "tau", "val_loss", "surf_loss", "surf_fa",
        "surf_det", "iters", "x_cells", "mask_cells", "gammas_cells")}
    sel = sess.select("npl")
    out.update(npl_coefs=sel.coefs, npl_heldout=sel.decision_function(xt),
               npl_stats=sel.stats)
    arg = sess.select("argmin")
    out["heldout"] = arg.decision_function(xt)
    return out, sel


def _same_bits(a, b) -> bool:
    if isinstance(a, dict):
        return a == b
    return a.dtype == b.dtype and a.shape == b.shape and bool(
        np.array_equal(a.view(np.uint8), b.view(np.uint8)))


def wave_resume(torch, dev, nplSVM, covtype_like, covtype_like_heldout,
                tables):
    """Kill-anywhere resume on the card (A3): one uninterrupted fit with a
    checkpoint directory, then for each of RESUME_KILLS a fit killed under
    ``faults.armed`` at that site and hit and run again over its own
    directory, and one run over a copy of the complete directory with a
    byte of one wave's shard flipped.  Every rerun must equal the
    uninterrupted run bitwise (``_resume_bits``), count exactly the waves
    it restored, solved and found corrupt, and launch the training
    kernels for its solved waves only.  Every run's first solved wave
    (B1-sym, B2, B4) and the uninterrupted run's npl re-solves
    (``resolve_replay``) are replayed against their plain versions: a
    bitwise rerun alone cannot catch a wrong kernel, both sides run it.
    Reports the checkpoint write s a wave, the restore s a wave and the
    bytes of a wave."""
    from repro_torch import obs
    from repro_torch.distributed import cell_trainer
    from repro_torch.testing import faults
    from repro_torch.train import checkpoint as ckpt_mod
    x, y = covtype_like(n=RESUME_N, d=DIM, n_classes=2, seed=SEED)
    xt, _ = covtype_like_heldout(RESUME_HELDOUT, n=RESUME_N, d=DIM,
                                 n_classes=2, seed=SEED,
                                 new_seed=HELDOUT_SEED)
    y = _binary(y)
    keys = dict(STAGED_KEYS, WAVE_SLOTS=RESUME_WAVE,
                MAX_ITERATIONS=RESUME_ITERS)
    names = ("train.waves_solved", "train.waves_restored",
             "train.corrupt_waves")
    shutil.rmtree(RESUME_DIR, ignore_errors=True)
    times = {"save": [], "restore": []}
    save0, restore0 = ckpt_mod.save_checkpoint, cell_trainer._restore_wave

    def timed_save(*a, **kw):
        t0 = time.perf_counter()
        out = save0(*a, **kw)
        times["save"].append(time.perf_counter() - t0)
        return out

    def timed_restore(*a, **kw):
        t0 = time.perf_counter()
        out = restore0(*a, **kw)
        times["restore"].append(time.perf_counter() - t0)
        return out

    def fit(ck):
        sess = nplSVM(x, y, constraint=STAGED_ALPHA, device=dev, **keys)
        c0 = [obs.metrics.counter(n).value for n in names]
        zero_counts(tables)
        with recorded_kernels(dev, keep=1) as rec:
            tr = sess.train(ckpt_dir=str(ck))
            torch.cuda.synchronize()
        counts = read_counts(tables)
        last["rec"] = rec
        return sess, tr, [obs.metrics.counter(n).value - c
                          for n, c in zip(names, c0)], counts

    def replay_first_wave(label):
        """The first solved wave of the last fit: one of each launch."""
        return replay_kernels(torch, f"resume[{label}] first solved wave",
                              last.pop("rec"), {"sq_dists_sym": 1, "gram_from_d2": 1,
                                    "cd_wave_epoch": 1})

    def expect_launches(label, tr, counts, solved):
        g = tr.gammas_cells.shape[1]
        require_launches(label, counts, {
            "sq_dists_sym": solved, "gram_from_d2": g * solved,
            "cd_wave_epoch": tr.config.cd_polish * g * solved})

    ckpt_mod.save_checkpoint, cell_trainer._restore_wave = (timed_save,
                                                            timed_restore)
    paths, runs, last = {}, {}, {}
    try:
        ref_dir = RESUME_DIR / "uninterrupted"
        t0 = time.perf_counter()
        sess, tr, waves, counts = fit(ref_dir)
        fit_s = time.perf_counter() - t0
        n_waves = -(-tr.packed.n_slots // RESUME_WAVE)
        if n_waves < 3 or waves != [n_waves, 0, 0]:
            raise Mismatch(f"wave_resume: {n_waves} waves, counters {waves}")
        expect_launches("resume uninterrupted", tr, counts, n_waves)
        paths["uninterrupted"] = counts
        replayed = {"uninterrupted": replay_first_wave("uninterrupted")}
        want, sel = _resume_bits(sess, tr, xt)
        replayed["npl select"] = resolve_replay(torch, dev, sess, sel,
                                                "wave_resume")
        wave_bytes = [_dir_bytes(ref_dir / f"step_{w:08d}")
                      for w in range(n_waves)]
        cases = [(f"{site}@{hit}", site, hit) for site, hit in RESUME_KILLS]
        cases.append((f"corrupt wave {RESUME_CORRUPT_WAVE}", None, None))
        for label, site, hit in cases:
            ck = RESUME_DIR / label.replace(" ", "_").replace("@", "_")
            if site is None:
                shutil.copytree(ref_dir, ck)
                shard = ck / f"step_{RESUME_CORRUPT_WAVE:08d}" / "shard_0.npz"
                with np.load(shard) as z:
                    arrays = {k: z[k].copy() for k in z.files}
                arrays["leaf_0"][0] ^= 0xFF        # the zip stays valid
                np.savez(shard, **arrays)
                expect = [1, n_waves - 1, 1]
            else:
                killed = False
                try:
                    with faults.armed(site, at_hit=hit):
                        fit(ck)
                except faults.InjectedFault:
                    killed = True
                if not killed:
                    raise Mismatch(f"wave_resume: {label} never fired")
                restored = hit - 1     # waves saved before the kill
                expect = [n_waves - restored, restored, 0]
            n_restore = len(times["restore"])
            t0 = time.perf_counter()
            sess, tr, waves, counts = fit(ck)
            rerun_s = time.perf_counter() - t0
            if waves != expect:
                raise Mismatch(f"wave_resume[{label}]: counters "
                               f"(solved, restored, corrupt) {waves}, "
                               f"expected {expect}")
            expect_launches(f"resume[{label}]", tr, counts, expect[0])
            replayed[label] = replay_first_wave(label)
            got, _ = _resume_bits(sess, tr, xt)
            differ = [k for k in want if not _same_bits(got[k], want[k])]
            if differ:
                raise Mismatch(f"wave_resume[{label}]: {differ} differ from "
                               f"the uninterrupted run's bits")
            if ckpt_mod.list_steps(str(ck)) != list(range(n_waves)):
                raise Mismatch(f"wave_resume[{label}]: steps "
                               f"{ckpt_mod.list_steps(str(ck))} left")
            paths[label] = counts
            runs[label] = {"solved_restored_corrupt": waves,
                           "rerun_s": rerun_s, "bitwise": True,
                           "restore_s": times["restore"][n_restore:]}
    finally:
        ckpt_mod.save_checkpoint, cell_trainer._restore_wave = (save0,
                                                                restore0)
    shutil.rmtree(RESUME_DIR, ignore_errors=True)
    emit({"phase": "wave_resume", "n": int(x.shape[0]),
          "cells": tr.plan.n_cells, "k_max": tr.plan.k_max,
          "slots": tr.packed.n_slots, "wave_slots": RESUME_WAVE,
          "waves": n_waves, "uninterrupted_fit_s": fit_s,
          "npl_columns_resolved": want["npl_stats"]["columns_resolved"],
          "checkpoint_write_s_per_wave": float(np.mean(times["save"])),
          "checkpoint_writes": len(times["save"]),
          "restore_s_per_wave": float(np.mean(times["restore"])),
          "wave_bytes": wave_bytes, "runs": runs, "replays": replayed,
          "ok": True})
    return paths


_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver")


def _profile(torch, fn, per: int = 1, top: int = 8,
             host_top: int = 0) -> dict:
    """One call of ``fn`` under ``torch.profiler``, every time and count
    divided by ``per`` (the steps ``fn`` takes): wall ms, the device's
    busy ms and share (a lower bound: the profiler slows the host), the
    kernel launches, the host operator calls, the ``top`` kernels by
    device time and, with ``host_top``, that many host operators by
    their own time (less their nested operators' and runtime calls').
    Read from the profiler's trace, written by its C++ side and parsed
    as JSON: ``key_averages`` built its Python events for a staged
    select's ~10^6 events in 56 s on the host of an H100 machine."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    path = ROOT / "build" / "chip_smoke_profile.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    try:
        with open(path) as f:
            events = [e for e in json.load(f)["traceEvents"]
                      if e.get("ph") == "X"]
    finally:
        path.unlink(missing_ok=True)
    dev_us, n_dev = collections.Counter(), 0
    host = collections.defaultdict(list)          # (pid, tid) -> events
    for e in events:
        if e.get("cat") in _DEVICE_CATS:
            dev_us[e["name"]] += e["dur"]
            n_dev += 1
        elif e.get("cat") in _HOST_CATS:
            host[(e["pid"], e["tid"])].append(e)
    dev_ms = sum(dev_us.values()) / 1e3
    res = {"wall_ms": wall_ms / per, "device_ms": dev_ms / per,
           "device_busy_share": dev_ms / wall_ms,
           "kernel_launches": n_dev / per,
           "host_op_calls": sum(e["cat"] == "cpu_op"
                                and e["name"].startswith("aten::")
                                for evs in host.values() for e in evs) / per,
           "top_kernels_ms": {k[:60]: v / 1e3 / per
                              for k, v in dev_us.most_common(top)}}
    if host_top:
        own = collections.Counter()
        for evs in host.values():
            evs.sort(key=lambda e: (e["ts"], -e["dur"]))
            stack = []                       # [end, event, own us]
            for e in evs + [None]:
                while stack and (e is None or stack[-1][0] <= e["ts"]):
                    _, done, us = stack.pop()
                    if done["cat"] == "cpu_op":
                        own[done["name"]] += us
                if e is not None:
                    if stack:
                        stack[-1][2] -= e["dur"]
                    stack.append([e["ts"] + e["dur"], e, e["dur"]])
        res["top_host_ops_ms"] = {k[:60]: v / 1e3 / per
                                  for k, v in own.most_common(host_top)}
    return res


def _engine_on(sess, bank, dev):
    """An engine on ``bank`` with the session's serve keys."""
    from repro_torch.serve import SVMEngine
    return SVMEngine(bank, **{"device": dev, **sess.serve_kwargs})


def lm_gemma_long(torch, dev, tables):
    """C7: gemma3-4b at full width in bf16 over sequences past its local
    window: pooled rows and the prefill's and first decode step's logits
    through B9/B10 against the plain attention path on the card, at the
    stablelm tolerances; reports the share of each tolerance used."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.embed import EmbeddingExtractor
    from repro_torch.serve import engine
    from repro_torch.serve.kv_cache import pad_cache
    cfg = get_arch(GEMMA_ARCH).config
    toks = np.random.default_rng(SEED).integers(
        0, cfg.vocab, (GEMMA_B, GEMMA_T)).astype(np.int32)
    t0 = time.perf_counter()
    ex = EmbeddingExtractor(cfg, batch_size=GEMMA_B, seed=SEED, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    plain_cfg = dataclasses.replace(cfg, attn_impl="ref")
    plain = EmbeddingExtractor(plain_cfg, ex.params, batch_size=GEMMA_B,
                               device=dev)
    zero_counts(tables)
    e_kern = ex(toks)
    counts = read_counts(tables)
    require_launches("gemma embed", counts,
                     {"flash_attention": cfg.n_layers})
    e_plain = plain(toks)
    shares = {}
    scale = float(np.abs(e_plain).max())
    err = float(np.abs(e_kern.astype(np.float64) - e_plain).max())
    check("gemma3-4b pooled rows vs plain attention", err,
          LM_EMBED_TOL * scale, max_abs_value=scale)
    shares["pooled"] = err / (LM_EMBED_TOL * scale)
    del plain
    prompt = torch.as_tensor(toks).to(dev)
    zero_counts(tables)
    logits, cache = engine.prefill_step(cfg, ex.params, prompt)
    cache = pad_cache(cfg, cache, GEMMA_T + 1)
    first = logits.argmax(-1)[:, None].to(torch.int32)
    step1, _ = engine.serve_step(cfg, ex.params, first, cache, GEMMA_T)
    torch.cuda.synchronize()
    gen_counts = read_counts(tables)
    require_launches("gemma prefill + one step", gen_counts,
                     {"flash_attention": cfg.n_layers,
                      "decode_attention": cfg.n_layers})
    del cache
    logits_p, cache_p = engine.prefill_step(plain_cfg, ex.params, prompt)
    cache_p = pad_cache(plain_cfg, cache_p, GEMMA_T + 1)
    step1_p, _ = engine.serve_step(plain_cfg, ex.params, first, cache_p,
                                   GEMMA_T)
    del cache_p
    for label, got, want in (("prefill", logits, logits_p),
                             ("first decode step", step1, step1_p)):
        scale = float(want.abs().max())
        err = float((got.float() - want.float()).abs().max())
        check(f"gemma3-4b {label} logits vs plain", err,
              LM_LOGIT_TOL * scale, max_abs_logit=scale)
        shares[label] = err / (LM_LOGIT_TOL * scale)
    emit({"phase": "lm_gemma_long", "arch": cfg.name,
          "layers": cfg.n_layers, "d_model": cfg.d_model,
          "head_dim": cfg.head_dim, "window": cfg.window,
          "params": cfg.param_count(), "dtype": str(cfg.dtype),
          "batch": GEMMA_B, "seq_len": GEMMA_T, "init_s": init_s,
          "tolerance_share_used": shares, "ok": True})
    del ex, logits, logits_p, step1, step1_p, e_kern, e_plain
    torch.cuda.empty_cache()
    return {name: counts[name] + gen_counts[name] for name in counts}


def lm_families_kernels(torch, dev):
    """B9 and B10 at the head dims of the dense-attention families (8:
    command-r's smoke config, bf16 on the CUDA-core kernel; 80: hubert; 160:
    stablelm-12b) against their plain versions on the card: every mask
    kind, ragged T and S, GQA groups 1, 2 and 4, bf16 and f32; B10 with
    bf16 and int8 caches over partial and wrapped rings, and at groups 5,
    16 (the MoE configs') and 12 (command-r-plus) at full-width decode
    shapes.  (The families'
    own launches are replayed at their shapes by ``lm_families``.)"""
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.kernels.decode_attention import ref as dec_ref
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    gen = torch.Generator().manual_seed(SEED + 1)
    bf16, f32 = torch.bfloat16, torch.float32
    errs = {}
    for kind, win, b, t, s, h, hk, d, dt in (
            ("causal", 0, 1, 300, 300, 32, 8, 160, bf16),
            ("causal", 0, 2, 100, 260, 4, 2, 160, f32),
            ("window", 70, 1, 200, 333, 8, 2, 160, bf16),
            ("bidir", 0, 2, 130, 130, 16, 16, 80, bf16),
            ("causal", 0, 1, 257, 257, 8, 2, 80, bf16),
            ("window", 40, 2, 90, 150, 4, 1, 80, f32),
            ("causal", 0, 2, 77, 77, 8, 2, 8, bf16),
            ("bidir", 0, 1, 65, 33, 8, 8, 8, bf16),
            ("window", 16, 1, 150, 150, 4, 2, 8, f32)):
        q = torch.randn(b, t, h, d, generator=gen).to(dev, dt)
        k = torch.randn(b, s, hk, d, generator=gen).to(dev, dt)
        v = torch.randn(b, s, hk, d, generator=gen).to(dev, dt)
        got = fa_ops.flash_attention(q, k, v, kind, win)
        want = fa_ref.flash_attention_ref(q, k, v, kind, win)
        torch.cuda.synchronize()
        label = (f"flash_attention[{kind},w={win},B={b},T={t},S={s},H={h},"
                 f"Hk={hk},D={d},{str(dt)[6:]}]")
        e = check(label, float((got.float() - want.float()).abs().max()),
                  attn_tol(want), kernel=fa_ops.kernel_name(dt, d))
        if dt == bf16:
            check_bound(label + "[elementwise]", got.float().cpu(),
                        want.float().cpu(),
                        attn_err_bound(fa_ref, q, k, v, kind, win, want).cpu())
        errs[f"flash_attention,D={d}"] = max(
            errs.get(f"flash_attention,D={d}", 0.0), e)
    for b, s, hk, g, d, quant, pos, win in (
            (2, 2048, 8, 4, 160, False, 2047, 0),
            (2, 2048, 8, 4, 160, True, 2047, 0),
            (3, 333, 2, 1, 160, True, 666, 0),
            (1, 9000, 8, 2, 160, False, 9100, 1024),
            (3, 300, 4, 2, 80, False, 120, 0),
            (2, 1024, 16, 1, 80, True, 1500, 0),
            (3, 100, 2, 4, 8, False, 99, 0),
            (3, 100, 2, 4, 8, True, 250, 0),
            (1, 5000, 2, 2, 8, True, 4999, 0),
            # llama4-maverick's (G 5) and qwen3-moe's (G 16: two slices
            # of 8) full-width decode steps
            (2, 2064, 8, 5, 128, False, 2047, 0),
            (2, 2064, 8, 5, 128, True, 2062, 0),
            (2, 2064, 4, 16, 128, False, 2047, 0),
            (2, 2064, 4, 16, 128, True, 2062, 0),
            # command-r-plus's group at full width (G 12: three slices of
            # 4), run only at its smoke config on the card
            (2, 2064, 8, 12, 128, False, 2047, 0)):
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
        k, v = (a.to(dev, torch.int8 if quant else bf16) for a in (k, v))
        got = dec_ops.decode_attention_fused(q, k, v, pos, d ** -0.5, ks, vs,
                                             window=win)
        again = dec_ops.decode_attention_fused(q, k, v, pos, d ** -0.5, ks,
                                               vs, window=win)
        want = dec_ref.decode_attention_ref(q, k, v, pos, d ** -0.5, ks, vs,
                                            win)
        torch.cuda.synchronize()
        label = (f"decode_attention[B={b},S={s},Hk={hk},G={g},D={d},"
                 f"{'int8' if quant else 'bf16'},pos={pos},w={win}]")
        e = check(label, float((got.float() - want.float()).abs().max()),
                  attn_tol(want), run_to_run_equal=bool(torch.equal(got,
                                                                    again)))
        if not torch.equal(got, again):
            raise Mismatch(f"{label}: two launches differ")
        key = f"decode_attention,D={d}" + (f",G={g}" if g in (5, 12, 16)
                                            else "")
        errs[key] = max(errs.get(key, 0.0), e)

    emit({"phase": "lm_families_kernels", "max_abs_err": errs, "ok": True})
    return errs


def _tol_share(label: str, got, want, tol: float, floor: float = 0.0
               ) -> float:
    """``got`` against ``want`` within ``tol`` of the largest |want|, or
    within ``floor`` where that is larger; returns the share of the
    tolerance used."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.shape != want.shape or not np.isfinite(got).all():
        raise Mismatch(f"{label}: shape {got.shape} vs {want.shape} or "
                       f"non-finite values")
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    bound = max(tol * scale, floor)
    check(label, err, bound, max_abs_value=scale, relative_tol=tol,
          floor=floor)
    return err / bound


@contextlib.contextmanager
def _keys_permuted(torch, seed: int):
    """The plain attention with its keys and values permuted along S: the
    same function, its f32 sums in another order (bidirectional only)."""
    from repro_torch.kernels.flash_attention import ref as fa_ref
    inner = fa_ref.flash_attention_ref

    def permuted(q, k, v, mask_kind="causal", window=0, scale=None):
        if mask_kind != "bidir":
            raise Mismatch("_keys_permuted: only bidirectional attention is "
                           "invariant under a key permutation")
        perm = torch.randperm(k.shape[1], generator=torch.Generator(
            ).manual_seed(seed)).to(k.device)
        return inner(q, k[:, perm], v[:, perm], mask_kind, window, scale)
    fa_ref.flash_attention_ref = permuted
    try:
        yield
    finally:
        fa_ref.flash_attention_ref = inner

# B9 / B10 wrappers by the name their launches are counted under
ATTN_WRAPPERS = {"flash_attention": "flash_attention",
                 "decode_attention": "decode_attention_fused"}


def attn_replay(torch, family: str, what: str, name: str, call):
    """One recorded B9 or B10 launch of a path (``recorded``: args, kwargs,
    output) against its plain version on the same operands on the card,
    within ``attn_tol`` (a bf16 B9 launch also value by value,
    ``attn_err_bound``).  Returns the check's error and the launch's
    timing case: (label, family, name, kernel, plain, SDPA or None,
    bound)."""
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.kernels.decode_attention import ref as dec_ref
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    args, kw, got = call
    if name == "flash_attention":
        q, k, v = args
        kind, win = kw.get("mask_kind", "causal"), kw.get("window", 0)
        (b, t, h, d), s, hk = q.shape, k.shape[1], k.shape[2]
        label = (f"flash_attention[{family} {what}: B={b},T={t},S={s},H={h},"
                 f"Hk={hk},D={d},{kind},{str(q.dtype)[6:]}]")
        want = fa_ref.flash_attention_ref(q, k, v, kind, win)
        torch.cuda.synchronize()
        err = check(label, float((got.float() - want.float()).abs().max()),
                    attn_tol(want), kernel=fa_ops.kernel_name(q.dtype, d))
        if q.dtype == torch.bfloat16:
            check_bound(label + "[elementwise]", got.float().cpu(),
                        want.float().cpu(),
                        attn_err_bound(fa_ref, q, k, v, kind, win,
                                       want).cpu())
        # SDPA on the (B, H, T, D) layout; the window as an explicit
        # boolean mask
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        mask = (fa_ref.attention_mask(t, s, kind, win, q.device)
                if kind == "window" else None)
        lib = (lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, is_causal=kind == "causal",
            enable_gqa=h > hk))
        tensor_cores = q.dtype == torch.bfloat16 and d >= 16
        case = (lambda: fa_ops.flash_attention(q, k, v, mask_kind=kind,
                                               window=win),
                lambda: fa_ref.flash_attention_ref(q, k, v, kind, win), lib,
                attn_bound(torch, b, t, s, h, hk, d, kind, win,
                           q.element_size(), BF16_FLOP_PER_S if tensor_cores
                           else FP32_FLOP_PER_S))
        return err, (label, family, name, *case)
    if name == "decode_attention_partials":
        return _partials_replay(torch, family, what, call)
    q, k, v, pos, scale = args
    ks, vs = kw.get("k_scale"), kw.get("v_scale")
    win = kw.get("window", 0)
    (b, hk, g, d), s = q.shape, k.shape[1]
    quant = k.dtype == torch.int8
    nvis = min(pos + 1, s, win if win > 0 else s)
    label = (f"decode_attention[{family} {what}: B={b},S={s},Hk={hk},G={g},"
             f"D={d},{'int8' if quant else str(k.dtype)[6:]},pos={pos}]")
    want = dec_ref.decode_attention_ref(q, k, v, pos, scale, ks, vs, win)
    torch.cuda.synchronize()
    err = check(label, float((got.float() - want.float()).abs().max()),
                attn_tol(want))
    lib = None
    if not quant and pos < s:          # no wrap: keys 0..pos in order
        kt, vt = (x[:, :pos + 1].transpose(1, 2).contiguous()
                  for x in (k, v))
        lib = (lambda: F.scaled_dot_product_attention(
            q, kt, vt, scale=scale))
    n_bytes = (2 * b * nvis * hk * d * k.element_size()
               + (2 * b * nvis * hk * 4 if quant else 0)
               + 2 * q.numel() * q.element_size())
    case = (lambda: dec_ops.decode_attention_fused(q, k, v, pos, scale, ks,
                                                   vs, window=win),
            lambda: dec_ref.decode_attention_ref(q, k, v, pos, scale, ks, vs,
                                                 win), lib,
            bound(n_bytes, 4 * b * hk * g * nvis * d))
    return err, (label, family, name, *case)


def _partials_replay(torch, family: str, what: str, call):
    """One recorded launch of B10's partials mode (one rank's block of a
    ring split over the sequence) against the plain partials on the same
    operands: the f32 output within ``attn_tol``, the log-sum-exp within
    1e-5 of its magnitude.  Its timing case: SDPA over the same visible
    keys of the block as the library call, the bound the visible keys'
    bytes read once (q read, the f32 output and log-sum-exp written)."""
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.kernels.decode_attention import ref as dec_ref
    args, kw, (o, lse) = call
    q, k, v, pos, scale = args[:5]
    ks, vs = (args[5], args[6]) if len(args) > 5 else (None, None)
    win, (lo, ring) = kw.get("window", 0), kw["block"]
    (b, hk, g, d), n = q.shape, k.shape[1]
    quant = k.dtype == torch.int8
    s0, nvis = dec_ops.block_visible_range(ring, pos, win, lo, n)
    label = (f"decode_attention_partials[{family} {what}: B={b},"
             f"S={n} of {ring} from {lo},Hk={hk},G={g},D={d},"
             f"{'int8' if quant else str(k.dtype)[6:]},pos={pos},"
             f"visible={nvis}]")
    want_o, want_lse = dec_ref.decode_attention_partials_ref(
        q, k, v, s0, nvis, scale, ks, vs)
    torch.cuda.synchronize()
    err = check(label, float((o - want_o).abs().max()), attn_tol(want_o))
    check(label + "[lse]", float((lse - want_lse).abs().max()),
          1e-5 * max(1.0, float(want_lse.abs().max())))
    lib = None
    if not quant and s0 + nvis <= n:      # the visible run in order
        kt, vt = (x[:, s0:s0 + nvis].transpose(1, 2).contiguous()
                  for x in (k, v))
        lib = (lambda: F.scaled_dot_product_attention(q, kt, vt,
                                                      scale=scale))
    n_bytes = (2 * b * nvis * hk * d * k.element_size()
               + (2 * b * nvis * hk * 4 if quant else 0)
               + q.numel() * q.element_size() + o.numel() * 4
               + lse.numel() * 4)
    case = (lambda: dec_ops.decode_attention_partials(
                q, k, v, pos, scale, ks, vs, window=win, block=(lo, ring)),
            lambda: dec_ref.decode_attention_partials_ref(
                q, k, v, s0, nvis, scale, ks, vs), lib,
            bound(n_bytes, 4 * b * hk * g * nvis * d))
    return err, (label, family, "decode_attention_partials", *case)


def lm_families(torch, dev, tables):
    """The dense-attention families on the card.  stablelm-12b at full
    width: 2 x 2048 tokens through ``EmbeddingExtractor``, pooled rows, the
    prefill's and the first decode step's logits against the plain
    attention path (``attn_impl="ref"``) on the same weights, then greedy
    generation of FAM_NEW tokens with bf16 and int8 caches.  hubert-xlarge
    at full width: ``encode`` logits and the extractor's pooled rows over
    4 x 1024 frames against the plain path.  internvl2 and command-r at
    their smoke configs in f32: the card's prefill, three decode steps and
    (command-r) greedy tokens against the CPU's on the same weights.
    Every run's launches are exact, and the first B9 or B10 launch of the
    runs named in ``record`` is replayed against its plain version at its
    own shape (``attn_replay``).  Returns the launch counts of each run,
    the replays' errors and their timing cases."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.embed import EmbeddingExtractor
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models import model as model_mod
    from repro_torch.models.layers import tree_map
    from repro_torch.serve import engine
    from repro_torch.serve.kv_cache import pad_cache
    paths, out, errs, cases = {}, {}, {}, []
    mods = {"flash_attention": fa_ops, "decode_attention": dec_ops}

    def counted(label, fn, expect, record=()):
        """``fn`` run once with its launches counted; ``record``: (kernel,
        what) pairs whose first launch in the run is replayed."""
        zero_counts(tables)
        rec = {name: [] for name, _ in record}
        with contextlib.ExitStack() as st:
            for name in rec:
                st.enter_context(recorded(mods[name], ATTN_WRAPPERS[name],
                                          rec[name], keep=1, device=dev))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn()
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        paths[label] = read_counts(tables)
        require_launches(label, paths[label], expect)
        family = label.split(" ")[0]
        for name, what in record:
            e, case = attn_replay(torch, family, what, name, rec[name][0])
            errs[case[0]] = e
            cases.append(case)
        return res, secs

    # stablelm-12b, full width
    cfg = get_arch(FAM_12B).config
    plain_cfg = dataclasses.replace(cfg, attn_impl="ref")
    toks = np.random.default_rng(SEED).integers(
        0, cfg.vocab, (FAM_B, FAM_T)).astype(np.int32)
    t0 = time.perf_counter()
    ex = EmbeddingExtractor(cfg, batch_size=FAM_B, seed=SEED, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    ex(toks)                                      # warm the shapes
    e_kern, embed_s = counted("stablelm-12b embed", lambda: ex(toks),
                              {"flash_attention": cfg.n_layers})
    e_plain = EmbeddingExtractor(plain_cfg, ex.params, batch_size=FAM_B,
                                 device=dev)(toks)
    shares = {"pooled": _tol_share("stablelm-12b pooled rows vs plain "
                                   "attention", e_kern, e_plain,
                                   LM_EMBED_TOL)}
    prompt = torch.as_tensor(toks).to(dev)

    def prefill_step1(c):
        logits, cache = engine.prefill_step(c, ex.params, prompt)
        cache = pad_cache(c, cache, FAM_T + 1)
        first = logits.argmax(-1)[:, None].to(torch.int32)
        step1, _ = engine.serve_step(c, ex.params, first, cache, FAM_T)
        return logits, step1

    (logits, step1), _ = counted(
        "stablelm-12b prefill + one step", lambda: prefill_step1(cfg),
        {"flash_attention": cfg.n_layers, "decode_attention": cfg.n_layers},
        [("flash_attention", "prefill"), ("decode_attention", "step")])
    logits_p, step1_p = prefill_step1(plain_cfg)
    shares["prefill"] = _tol_share("stablelm-12b prefill logits vs plain",
                                   logits.cpu(), logits_p.cpu(),
                                   LM_LOGIT_TOL)
    shares["first decode step"] = _tol_share(
        "stablelm-12b first decode-step logits vs plain", step1.cpu(),
        step1_p.cpu(), LM_LOGIT_TOL)
    del logits, step1, logits_p, step1_p
    gen_runs = {}
    for kv in ("bf16", "int8"):
        c = dataclasses.replace(cfg, kv_cache_dtype=kv)
        (_, _), pre_s = counted(f"stablelm-12b prefill[{kv}]",
                                lambda c=c: engine.prefill_step(
                                    c, ex.params, prompt),
                                {"flash_attention": c.n_layers})
        toks_out, gen_s = counted(
            f"stablelm-12b generate[{kv}]",
            lambda c=c: engine.generate(c, ex.params, prompt, FAM_NEW),
            {"flash_attention": c.n_layers,
             "decode_attention": c.n_layers * (FAM_NEW - 1)},
            [("decode_attention", "generate")] if kv == "int8" else ())
        if (toks_out.shape != (FAM_B, FAM_T + FAM_NEW)
                or int(toks_out.min()) < 0
                or int(toks_out.max()) >= c.vocab):
            raise Mismatch(f"stablelm-12b generate[{kv}]: bad tokens")
        gen_runs[kv] = {"seconds": gen_s, "prefill_s": pre_s,
                        "decode_ms_per_step":
                            (gen_s - pre_s) * 1e3 / (FAM_NEW - 1)}
    out[FAM_12B] = {
        "layers": cfg.n_layers, "d_model": cfg.d_model,
        "head_dim": cfg.head_dim, "params": cfg.param_count(),
        "dtype": str(cfg.dtype), "batch": FAM_B, "seq_len": FAM_T,
        "init_s": init_s, "embed_s": embed_s,
        "embed_tokens_per_s": FAM_B * FAM_T / embed_s,
        "generate": gen_runs, "tolerance_share_used": shares,
        "peak_memory_gb": torch.cuda.max_memory_allocated(dev) / 1e9}
    del ex, e_kern, e_plain, prompt
    torch.cuda.empty_cache()

    # hubert-xlarge, full width: frames through encode and the extractor
    cfg = get_arch(FAM_HUBERT).config
    plain_cfg = dataclasses.replace(cfg, attn_impl="ref")
    frames = np.random.default_rng(SEED).standard_normal(
        (FAM_HB, FAM_HT, cfg.d_frontend)).astype(np.float32)
    ex = EmbeddingExtractor(cfg, batch_size=FAM_HB, seed=SEED, device=dev)
    x = torch.as_tensor(frames).to(dev)
    model_mod.encode(cfg, ex.params, x)           # warm the shapes
    lg, enc_s = counted("hubert-xlarge encode",
                        lambda: model_mod.encode(cfg, ex.params, x),
                        {"flash_attention": cfg.n_layers},
                        [("flash_attention", "encode")])
    lg_p = model_mod.encode(plain_cfg, ex.params, x)
    floors = []
    for seed in FAM_PERMUTATIONS:
        with _keys_permuted(torch, seed):
            floors.append(float((model_mod.encode(plain_cfg, ex.params, x)
                                 - lg_p).abs().max()))
    scale = float(lg_p.abs().max())
    shares = {"encode logits": _tol_share(
        "hubert-xlarge encode logits vs plain", lg.cpu(), lg_p.cpu(),
        LM_LOGIT_TOL, FAM_NOISE_FACTOR * max(floors))}
    # the same comparison at the first layers of the 48, where the floor
    # has not yet reached the tolerance: the first FAM_DEPTHS[0] held
    # within LM_LOGIT_TOL
    depth = {48: {"share_of_3e-2": float((lg - lg_p).abs().max())
                  / (LM_LOGIT_TOL * scale),
                  "mean_abs": float((lg - lg_p).abs().mean()),
                  "plain_permuted_max_abs": floors}}
    for n in FAM_DEPTHS:
        c = dataclasses.replace(cfg, n_layers=n)
        p_n = {**ex.params, "stack": tree_map(lambda a: a[:n],
                                              ex.params["stack"])}
        a = model_mod.encode(c, p_n, x)
        b = model_mod.encode(dataclasses.replace(c, attn_impl="ref"), p_n, x)
        depth[n] = {"share_of_3e-2": float((a - b).abs().max())
                    / (LM_LOGIT_TOL * float(b.abs().max())),
                    "mean_abs": float((a - b).abs().mean())}
        if n == FAM_DEPTHS[0]:
            shares[f"encode logits, first {n} layers"] = _tol_share(
                f"hubert-xlarge encode logits, first {n} layers, vs plain",
                a.cpu(), b.cpu(), LM_LOGIT_TOL)
        del a, b
    rows, rows_s = counted("hubert-xlarge embed", lambda: ex(frames),
                           {"flash_attention": cfg.n_layers})
    rows_p = EmbeddingExtractor(plain_cfg, ex.params, batch_size=FAM_HB,
                                device=dev)(frames)
    shares["pooled"] = _tol_share("hubert-xlarge pooled rows vs plain",
                                  rows, rows_p, LM_EMBED_TOL)
    # the same weights in f32 (exact): the kernel path (f32 B9 at D 80)
    # against the plain path within f32 noise
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    p32 = tree_map(lambda a: a.float(), ex.params)
    lg32, _ = counted("hubert-xlarge encode f32",
                      lambda: model_mod.encode(cfg32, p32, x),
                      {"flash_attention": cfg.n_layers},
                      [("flash_attention", "encode")])
    shares["encode logits f32"] = _tol_share(
        "hubert-xlarge encode logits f32 vs plain", lg32.cpu(),
        model_mod.encode(dataclasses.replace(cfg32, attn_impl="ref"), p32,
                         x).cpu(), FAM_SMOKE_TOL)
    del p32, lg32
    out[FAM_HUBERT] = {
        "layers": cfg.n_layers, "d_model": cfg.d_model,
        "head_dim": cfg.head_dim, "params": cfg.param_count(),
        "batch": FAM_HB, "frames": FAM_HT, "d_frontend": cfg.d_frontend,
        "encode_s": enc_s, "encode_frames_per_s": FAM_HB * FAM_HT / enc_s,
        "embed_s": rows_s, "logits_shape": list(lg.shape),
        "plain_reordered_max_abs_dev": floors, "by_depth": depth,
        "tolerance_share_used": shares}
    del ex, x, lg, lg_p
    torch.cuda.empty_cache()

    # the smoke configs of the configurations beyond one card, card vs CPU
    cpu = torch.device("cpu")
    for arch in FAM_SMOKE:
        cfg = dataclasses.replace(get_arch(arch).smoke, dtype=torch.float32)
        p_cpu = model_mod.init_params(cfg,
                                      torch.Generator().manual_seed(SEED))
        p_dev = tree_map(lambda a: a.to(dev), p_cpu)
        rng = np.random.default_rng(SEED)
        if cfg.input_kind == "tokens":
            xs = rng.integers(0, cfg.vocab, (4, 24 + 3)).astype(np.int64)
        else:
            xs = rng.standard_normal((4, 24 + 3, cfg.d_frontend)
                                     ).astype(np.float32)
        shares = {}
        results = {}
        for where, p in (("card", p_dev), ("cpu", p_cpu)):
            d_ = dev if where == "card" else cpu

            def run(p=p, d_=d_):
                x = torch.as_tensor(xs).to(d_)
                logits, cache = engine.prefill_step(cfg, p, x[:, :24])
                cache = pad_cache(cfg, cache, 27)
                steps = [logits]
                for j in range(3):
                    lj, cache = engine.serve_step(cfg, p, x[:, 24 + j:25 + j],
                                                  cache, 24 + j)
                    steps.append(lj)
                return [s_.cpu() for s_ in steps]
            if where == "card":
                results[where], _ = counted(
                    f"{arch} smoke prefill + 3 steps", run,
                    {"flash_attention": cfg.n_layers,
                     "decode_attention": 3 * cfg.n_layers},
                    [("flash_attention", "smoke prefill"),
                     ("decode_attention", "smoke step")]
                    if cfg.head_dim == 8 else ())
            else:
                results[where] = run()
        for j, (a, b) in enumerate(zip(results["card"], results["cpu"])):
            shares[f"step {j}"] = _tol_share(
                f"{arch} smoke logits[{j}] card vs CPU", a.numpy(),
                b.numpy(), FAM_SMOKE_TOL)
        same = None
        if cfg.input_kind == "tokens":
            prompt = torch.as_tensor(xs[:, :24])
            got, _ = counted(f"{arch} smoke generate",
                             lambda: engine.generate(cfg, p_dev,
                                                     prompt.to(dev), 12),
                             {"flash_attention": cfg.n_layers,
                              "decode_attention": 11 * cfg.n_layers})
            want = engine.generate(cfg, p_cpu, prompt, 12)
            same = bool(torch.equal(got.cpu(), want))
            if not same:
                raise Mismatch(f"{arch} smoke: greedy tokens on the card "
                               f"differ from the CPU's")
        out[arch] = {"config": cfg.name, "head_dim": cfg.head_dim,
                     "input_kind": cfg.input_kind,
                     "tolerance_share_used": shares,
                     "greedy_tokens_identical": same}
    emit({"phase": "lm_families", **out, "replayed_max_abs_err": errs,
          "ok": True})
    return paths, errs, cases


def lm_rwkv6(torch, dev, tables):
    """rwkv6-1.6b at full width on the card (attention-free: no kernel
    launches at all).  Prefill of RWKV_B x RWKV_T tokens and greedy
    generation of RWKV_NEW tokens, timed; the decode state's bytes, the
    same at every budget; in f32 the state after one prefill of the first
    RWKV_STATE_T tokens against stepping them one by one; the bf16 prefill
    logits against the f32 path's; extractor rows bitwise the same under
    two chunk sizes and in a ragged tail block.  Returns the runs'
    launch counts."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.embed import EmbeddingExtractor, EmbeddingSource
    from repro_torch.models import model as model_mod
    from repro_torch.models.layers import tree_items, tree_map
    from repro_torch.serve import engine
    from repro_torch.serve.kv_cache import cache_bytes
    cfg = get_arch(RWKV_ARCH).config
    paths = {}

    def counted(label, fn):
        zero_counts(tables)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        paths[label] = read_counts(tables)
        require_launches(label, paths[label], {})
        return res, secs

    toks = np.random.default_rng(SEED).integers(
        0, cfg.vocab, (RWKV_B, RWKV_T)).astype(np.int32)
    prompt = torch.as_tensor(toks).to(dev)
    t0 = time.perf_counter()
    params = model_mod.init_params(
        cfg, torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats(dev)
    engine.prefill_step(cfg, params, prompt)       # warm the shapes
    (logits, cache), prefill_s = counted(
        "rwkv6 prefill", lambda: engine.prefill_step(cfg, params, prompt))
    prefill_peak = torch.cuda.max_memory_allocated(dev)
    got_bytes = sum(leaf.numel() * leaf.element_size()
                    for _, leaf in tree_items(cache))
    budgets = (1, RWKV_T, RWKV_T + RWKV_NEW, 524_288)
    state_bytes = {b: cache_bytes(cfg, RWKV_B, b) for b in budgets}
    if len(set(state_bytes.values())) != 1 or got_bytes != state_bytes[1]:
        raise Mismatch(f"rwkv6: decode state bytes {state_bytes} vary with "
                       f"the budget or differ from the prefill's cache "
                       f"({got_bytes})")
    del cache
    out, gen_s = counted("rwkv6 generate", lambda: engine.generate(
        cfg, params, prompt, RWKV_NEW))
    if (out.shape != (RWKV_B, RWKV_T + RWKV_NEW)
            or not torch.equal(out[:, :RWKV_T].cpu(), prompt.cpu())
            or int(out.min()) < 0 or int(out.max()) >= cfg.vocab):
        raise Mismatch("rwkv6 generate: bad tokens")

    # the same weights in f32, exactly: the state after a prefill against
    # the recurrence stepped token by token, then the bf16 logits
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    p32 = tree_map(lambda a: a.float(), params)
    x64 = prompt[:, :RWKV_STATE_T]
    (_, c_pre), _ = counted("rwkv6 f32 prefill",
                            lambda: model_mod.prefill(cfg32, p32, x64))

    def stepped():
        c = model_mod.init_cache(cfg32, RWKV_B, 1, device=dev)
        for i in range(RWKV_STATE_T):
            _, c = model_mod.decode_step(cfg32, p32, x64[:, i:i + 1], c, i)
        return c
    c_step, _ = counted("rwkv6 f32 stepped", stepped)
    shares = {}
    for name in ("wkv", "shift", "shift_ffn"):
        shares[f"state {name}"] = _tol_share(
            f"rwkv6 f32 state[{name}] prefill vs stepped",
            c_pre["stack"]["pos0"][name].cpu(),
            c_step["stack"]["pos0"][name].cpu(), RWKV_STATE_TOL)
    del c_pre, c_step

    def last_logits(c, p, layers=None):
        if layers is not None:
            c = dataclasses.replace(c, n_layers=layers)
            p = {**p, "stack": tree_map(lambda a: a[:layers], p["stack"])}
        out, _ = counted(f"rwkv6 prefill [{c.dtype}, chunk {c.rwkv_chunk}, "
                         f"{c.n_layers} layers]",
                         lambda: model_mod.prefill(c, p, prompt)[0])
        return out.cpu()
    logits32 = last_logits(cfg32, p32)
    for ch in RWKV_ALT_CHUNKS:
        shares[f"f32 logits, chunk {ch}"] = _tol_share(
            f"rwkv6 f32 logits at chunk {ch} vs {cfg.rwkv_chunk}",
            last_logits(dataclasses.replace(cfg32, rwkv_chunk=ch), p32),
            logits32, RWKV_STATE_TOL)
    gate32 = last_logits(cfg32, p32, RWKV_GATE_DEPTH)
    del p32
    torch.cuda.empty_cache()
    shares[f"bf16 logits vs f32, first {RWKV_GATE_DEPTH} layers"] = \
        _tol_share(f"rwkv6 bf16 logits vs f32, first {RWKV_GATE_DEPTH} "
                   f"layers", last_logits(cfg, params, RWKV_GATE_DEPTH),
                   gate32, LM_LOGIT_TOL)
    logits = logits.cpu()
    alt_dev, alt_self = {}, {}
    for ch in RWKV_ALT_CHUNKS:
        alt = last_logits(dataclasses.replace(cfg, rwkv_chunk=ch), params)
        alt_dev[ch] = float((alt - logits32).abs().max())
        alt_self[ch] = float((alt - logits).abs().max())
    shares["bf16 logits vs f32"] = _tol_share(
        "rwkv6 bf16 logits vs f32", logits, logits32, LM_LOGIT_TOL,
        FAM_NOISE_FACTOR * max(alt_dev.values()))
    dev_rel = float((logits - logits32).abs().max()
                    / logits32.abs().max())
    same_token = float((logits.argmax(-1) == logits32.argmax(-1)).float()
                       .mean())
    del alt, logits, logits32, gate32

    ex = EmbeddingExtractor(cfg, params, batch_size=RWKV_B, device=dev)
    seqs = np.random.default_rng(SEED + 1).integers(
        0, cfg.vocab, (RWKV_EX_N, RWKV_EX_T)).astype(np.int32)
    rows, ex_s = counted("rwkv6 embed", lambda: np.concatenate(
        [c for _, c in EmbeddingSource(seqs, ex).iter_chunks(RWKV_B)]))
    rows_b = np.concatenate([c for _, c in
                             EmbeddingSource(seqs, ex).iter_chunks(3)])
    invariant = bool(np.isfinite(rows).all() and np.array_equal(rows, rows_b)
                     and np.array_equal(ex(seqs[:1]), rows[:1]))
    emit({"phase": "lm_rwkv6", "arch": cfg.name, "layers": cfg.n_layers,
          "d_model": cfg.d_model, "heads": cfg.rwkv_heads,
          "head_dim": cfg.rwkv_head_dim, "d_ff": cfg.d_ff,
          "vocab": cfg.vocab, "params": cfg.param_count(),
          "dtype": str(cfg.dtype), "chunk": cfg.rwkv_chunk,
          "batch": RWKV_B, "prompt": RWKV_T, "new_tokens": RWKV_NEW,
          "init_s": init_s, "prefill_s": prefill_s,
          "prefill_tokens_per_s": RWKV_B * RWKV_T / prefill_s,
          "prefill_peak_memory_gb": prefill_peak / 1e9,
          "generate_s": gen_s,
          "decode_ms_per_step": (gen_s - prefill_s) * 1e3 / (RWKV_NEW - 1),
          "state_bytes": state_bytes[1], "state_bytes_by_budget":
              {str(b): v for b, v in state_bytes.items()},
          "bf16_vs_f32_max_rel": dev_rel,
          "bf16_other_chunk_vs_f32_abs": alt_dev,
          "bf16_other_chunk_vs_chunk_128_abs": alt_self,
          "bf16_vs_f32_argmax_agreement": same_token,
          "tolerance_share_used": shares, "embed_s": ex_s,
          "embed_tokens_per_s": RWKV_EX_N * RWKV_EX_T / ex_s,
          "rows_bitwise_invariant": invariant, "launches": paths,
          "ok": invariant})
    if not invariant:
        raise Mismatch("rwkv6 embed: rows differ between chunk sizes or "
                       "blocks")
    del ex, params, prompt, out
    torch.cuda.empty_cache()
    return paths


@contextlib.contextmanager
def moe_routing(log: list, forced: list = None):
    """Inside, every MoE chunk (``moe._chunk_moe``) appends its router
    input, its router and the experts its own logits choose
    (``moe._route``) to ``log``.  With ``forced`` (an earlier run's log on
    the same chunks in the same order) each chunk routes to the experts
    of that run instead, the gates from its own logits: the same routing,
    so what remains between the two runs is the path that made the
    router inputs."""
    from repro_torch.models import moe as moe_mod
    inner_chunk, inner_route = moe_mod._chunk_moe, moe_mod._route

    def chunk(p, xc, **kw):
        log.append({"x": xc.detach().clone(), "router": p["router"]})
        return inner_chunk(p, xc, **kw)

    def route(logits, top_k):
        gate, idx = inner_route(logits, top_k)
        log[-1]["idx"] = idx
        if forced is None:
            return gate, idx
        idx = forced[len(log) - 1]["idx"]
        import torch
        return torch.softmax(torch.gather(logits, 1, idx), dim=-1), idx
    moe_mod._chunk_moe, moe_mod._route = chunk, route
    try:
        yield log
    finally:
        moe_mod._chunk_moe, moe_mod._route = inner_chunk, inner_route


def routing_flips(torch, label: str, kern: list, plain: list, top_k: int,
                  groups: list) -> dict:
    """The experts the plain path's own logits chose against the kernel
    path's, chunk by chunk (``moe_routing`` logs of the two runs).  A
    token whose set differs is a flip; each flip must be a near-tie: the
    plain logits' margin between the k-th and (k+1)-th expert within
    2 |x_kernel - x_plain| max_e |router_e| (how far the router input's
    difference can move two logits apart) plus the f32 rounding of the
    logits, MOE_FLIP_SLACK |x| max_e |router_e|.  ``groups``: (name,
    chunks) of the runs' MoE layers in call order.  Returns the flips of
    each group and the largest margin / bound ratio among them."""
    if len(kern) != len(plain) or len(kern) != sum(n for _, n in groups):
        raise Mismatch(f"{label}: {len(kern)} and {len(plain)} MoE chunks "
                       f"logged, expected {sum(n for _, n in groups)}")
    out, worst, i = {}, 0.0, 0
    for name, n in groups:
        flips = 0
        for _ in range(n):
            a, b = kern[i], plain[i]
            i += 1
            ka = torch.sort(a["idx"], dim=1).values
            kb = torch.sort(b["idx"], dim=1).values
            rows = torch.nonzero((ka != kb).any(1)).flatten()
            if rows.numel() == 0:
                continue
            flips += int(rows.numel())
            r = b["router"].float()
            rmax = float(torch.linalg.vector_norm(r, dim=0).max())
            xb = b["x"][rows].float()
            lg = torch.sort(xb @ r, dim=1, descending=True).values
            margin = lg[:, top_k - 1] - lg[:, top_k]
            dx = torch.linalg.vector_norm(a["x"][rows].float() - xb, dim=1)
            bnd = (2 * dx + MOE_FLIP_SLACK
                   * torch.linalg.vector_norm(xb, dim=1)) * rmax
            ratio = float((margin / bnd).max())
            worst = max(worst, ratio)
            if ratio > 1.0:
                raise Mismatch(f"{label} {name}: a routing flip at margin "
                               f"{float(margin.max())} beyond its near-tie "
                               f"bound")
        out[name] = flips
    return {"flips": out, "worst_margin_over_bound": worst}


def lm_moe_ssm(torch, dev, tables):
    """The MoE and mamba mixers on the card.  jamba-v0.1-52b (one period:
    8 layers), qwen3-moe-235b-a22b and llama4-maverick-400b-a17b (2 layers
    each) at full width in bf16, seed-initialised, one after the other:
    a prefill of MOE_B x MOE_T tokens, timed; the prefill and first
    decode step against the plain attention path on the same weights with
    the kernel path's routing replayed (``moe_routing``), every routing
    flip of the plain path's own choice a near-tie (``routing_flips``);
    greedy generation with bf16 and int8 caches (qwen3 through B10 at
    G 16, two slices of 8; llama4 at G 5).  jamba also: the decode
    state's bytes at two budgets (seven O(1) mamba states and one layer's
    kv), one mamba layer in f32 stepped against its prefill, extractor
    rows bitwise under two chunk sizes and a ragged tail block.  The three
    smoke configs in f32, card against CPU, and their gather dispatch
    under deterministic algorithms (two train steps bitwise, equal to the
    einsum dispatch within the smoke tolerance).  Every run's launches are
    exact; the first B9 and B10 launch of each model is replayed against
    its plain version (``attn_replay``).  Returns the runs' launch counts,
    the replays' errors and their timing cases."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.embed import EmbeddingExtractor, EmbeddingSource
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models import model as model_mod
    from repro_torch.models import ssm as ssm_mod
    from repro_torch.models.layers import tree_items, tree_map
    from repro_torch.serve import engine
    from repro_torch.serve.kv_cache import cache_bytes, pad_cache
    from repro_torch.train.lm_trainer import value_and_grad
    paths, out, errs, cases = {}, {}, {}, []
    mods = {"flash_attention": fa_ops, "decode_attention": dec_ops}
    t_phase = time.perf_counter()

    def counted(label, fn, expect, record=()):
        zero_counts(tables)
        rec = {name: [] for name, _ in record}
        with contextlib.ExitStack() as st:
            for name in rec:
                st.enter_context(recorded(mods[name], ATTN_WRAPPERS[name],
                                          rec[name], keep=1, device=dev))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn()
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        paths[label] = read_counts(tables)
        require_launches(label, paths[label], expect)
        family = label.split(" ")[0]
        for name, what in record:
            e, case = attn_replay(torch, family, what, name, rec[name][0])
            errs[case[0]] = e
            cases.append(case)
        return res, secs

    for arch, n_layers, new in MOE_MODELS:
        cfg = dataclasses.replace(get_arch(arch).config, n_layers=n_layers)
        plain = dataclasses.replace(cfg, attn_impl="ref")
        name = cfg.name
        kinds = [cfg.period_pattern[i % cfg.period] for i in range(n_layers)]
        n_attn = sum(m == "attn" for m, _ in kinds)
        n_moe = sum(f == "moe" for _, f in kinds)
        g = cfg.n_heads // cfg.n_kv_heads
        per_step = n_attn
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        params = model_mod.init_params(
            cfg, torch.Generator(device=dev).manual_seed(SEED))
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        prompt = torch.as_tensor(np.random.default_rng(SEED).integers(
            0, cfg.vocab, (MOE_B, MOE_T)).astype(np.int32)).to(dev)
        engine.prefill_step(cfg, params, prompt)            # warm the shapes
        (_, cache), prefill_s = counted(
            f"{name} prefill", lambda: engine.prefill_step(cfg, params,
                                                           prompt),
            {"flash_attention": n_attn}, [("flash_attention", "prefill")])
        budgets = (MOE_T + MOE_NEW_JAMBA, 524_288)
        state = {b: cache_bytes(cfg, MOE_B, b) for b in budgets}
        padded = pad_cache(cfg, cache, budgets[0])
        got_bytes = sum(leaf.numel() * leaf.element_size()
                        for _, leaf in tree_items(padded))
        del cache, padded
        if got_bytes != state[budgets[0]]:
            raise Mismatch(f"{name}: the padded cache holds {got_bytes} "
                           f"bytes, cache_bytes says {state[budgets[0]]}")

        # the prefill and first decode step, kernel path vs plain path
        # with the kernel path's routing
        def prefill_step1(c):
            logits, cache = engine.prefill_step(c, params, prompt)
            cache = pad_cache(c, cache, MOE_T + 1)
            first = logits.argmax(-1)[:, None].to(torch.int32)
            step1, _ = engine.serve_step(c, params, first, cache, MOE_T)
            return logits.cpu(), step1.cpu()
        log_k, log_p = [], []
        with moe_routing(log_k):
            (lg_k, st_k), _ = counted(
                f"{name} prefill + one step", lambda: prefill_step1(cfg),
                {"flash_attention": n_attn, "decode_attention": per_step},
                [("decode_attention", "step")])
        with moe_routing(log_p, forced=log_k):
            lg_p, st_p = prefill_step1(plain)
        n_chunks = -(-MOE_B * MOE_T // cfg.moe_chunk)
        groups = ([(f"prefill moe layer {j}", n_chunks)
                   for j in range(n_moe)]
                  + [(f"step moe layer {j}", 1) for j in range(n_moe)])
        flips = routing_flips(torch, name, log_k, log_p, cfg.top_k, groups)
        del log_k, log_p
        shares = {
            "prefill logits": _tol_share(
                f"{name} prefill logits vs plain (routing replayed)", lg_k,
                lg_p, LM_LOGIT_TOL),
            "first decode step": _tol_share(
                f"{name} first decode-step logits vs plain (routing "
                f"replayed)", st_k, st_p, LM_LOGIT_TOL)}
        del lg_k, st_k, lg_p, st_p
        gen_runs = {}
        for kv in ("bf16", "int8"):
            c = dataclasses.replace(cfg, kv_cache_dtype=kv)
            _, pre_s = counted(f"{name} prefill[{kv}]",
                               lambda c=c: engine.prefill_step(c, params,
                                                               prompt),
                               {"flash_attention": n_attn})
            toks, gen_s = counted(
                f"{name} generate[{kv}]",
                lambda c=c: engine.generate(c, params, prompt, new),
                {"flash_attention": n_attn,
                 "decode_attention": per_step * (new - 1)},
                [("decode_attention", "generate")] if kv == "int8" else ())
            if (toks.shape != (MOE_B, MOE_T + new)
                    or not torch.equal(toks[:, :MOE_T].cpu(), prompt.cpu())
                    or int(toks.min()) < 0 or int(toks.max()) >= c.vocab):
                raise Mismatch(f"{name} generate[{kv}]: bad tokens")
            gen_runs[kv] = {"seconds": gen_s, "prefill_s": pre_s,
                            "decode_ms_per_step":
                                (gen_s - pre_s) * 1e3 / (new - 1)}
        rec = {"layers": n_layers, "published_layers":
                   get_arch(arch).config.n_layers,
               "d_model": cfg.d_model, "heads": cfg.n_heads,
               "kv_heads": cfg.n_kv_heads, "group": g,
               "b10_group_slices": dec_ops.group_slices(g)[1],
               "experts": cfg.n_experts, "top_k": cfg.top_k,
               "moe_d_ff": cfg.moe_d_ff, "moe_layers": n_moe,
               "shared_expert": "shared" in params["stack"][
                   f"pos{cfg.period - 1}"]["mlp"],
               "params": cfg.param_count(), "dtype": str(cfg.dtype),
               "batch": MOE_B, "prompt": MOE_T, "new_tokens": new,
               "init_s": init_s, "prefill_s": prefill_s,
               "prefill_tokens_per_s": MOE_B * MOE_T / prefill_s,
               "generate": gen_runs, "routing": flips,
               "state_bytes_by_budget": {str(b): v
                                         for b, v in state.items()},
               "tolerance_share_used": shares}

        if arch == MOE_JAMBA:
            # one mamba layer in f32: a prefill's end state against the
            # same tokens stepped one by one
            pm = {k: v[0].float() for k, v in
                  params["stack"]["pos1"]["mixer"].items()}
            kw = dict(d_inner=cfg.d_inner, d_state=cfg.ssm_d_state,
                      d_conv=cfg.ssm_d_conv, dt_rank=cfg.dt_rank,
                      dtype=torch.float32)
            x = torch.randn(MOE_B, MAMBA_STATE_T, cfg.d_model,
                            generator=torch.Generator(device=dev)
                            .manual_seed(SEED), device=dev)

            def stepped():
                st = ssm_mod.SSMState(
                    torch.zeros(MOE_B, cfg.ssm_d_conv - 1, cfg.d_inner,
                                device=dev),
                    torch.zeros(MOE_B, cfg.d_inner, cfg.ssm_d_state,
                                device=dev))
                ys = []
                for i in range(MAMBA_STATE_T):
                    y, st = ssm_mod.mamba_mixer(pm, x[:, i:i + 1], state=st,
                                                chunk=cfg.ssm_chunk, **kw)
                    ys.append(y)
                return torch.cat(ys, 1), st
            with torch.no_grad():
                (y_pre, s_pre), _ = counted(
                    f"{name} mamba f32 prefill",
                    lambda: ssm_mod.mamba_mixer(pm, x, chunk=cfg.ssm_chunk,
                                                **kw), {})
                (y_alt, s_alt), _ = counted(
                    f"{name} mamba f32 prefill, chunk {MAMBA_ALT_CHUNK}",
                    lambda: ssm_mod.mamba_mixer(pm, x, chunk=MAMBA_ALT_CHUNK,
                                                **kw), {})
                (y_st, s_st), _ = counted(f"{name} mamba f32 stepped",
                                          stepped, {})
            for what, a, b in (("state ssm", s_pre.ssm, s_st.ssm),
                               ("state conv", s_pre.conv, s_st.conv),
                               ("outputs", y_pre, y_st),
                               (f"state ssm, chunk {MAMBA_ALT_CHUNK}",
                                s_alt.ssm, s_st.ssm)):
                shares[f"mamba f32 {what}"] = _tol_share(
                    f"{name} mamba f32 {what}: prefill vs stepped",
                    a.cpu(), b.cpu(), MAMBA_STATE_TOL)
            del pm, x, y_pre, s_pre, y_alt, s_alt, y_st, s_st
            # extractor rows: MoE capacity couples a block's rows; blocks
            # aligned to absolute offsets keep each row's bits
            ex = EmbeddingExtractor(cfg, params, batch_size=MOE_EX_B,
                                    device=dev)
            seqs = np.random.default_rng(SEED + 1).integers(
                0, cfg.vocab, (MOE_EX_N, MOE_EX_T)).astype(np.int32)
            n_blocks = -(-MOE_EX_N // MOE_EX_B)
            rows, ex_s = counted(
                f"{name} embed", lambda: np.concatenate(
                    [c for _, c in EmbeddingSource(seqs, ex).iter_chunks(
                        MOE_EX_CHUNKS[0])]),
                {"flash_attention": n_attn * n_blocks})
            rows_b = np.concatenate(
                [c for _, c in EmbeddingSource(seqs, ex).iter_chunks(
                    MOE_EX_CHUNKS[1])])
            ids = np.arange(MOE_EX_N)[::-1].copy()
            rows_g = EmbeddingSource(seqs, ex).gather(ids)
            invariant = bool(np.isfinite(rows).all()
                             and np.array_equal(rows, rows_b)
                             and np.array_equal(rows_g, rows[ids]))
            rec.update({"embed_s": ex_s, "embed_rows": MOE_EX_N,
                        "embed_seq_len": MOE_EX_T, "embed_block": MOE_EX_B,
                        "rows_bitwise_invariant": invariant,
                        "mamba_state_bytes_per_layer": 4 * MOE_B * (
                            cfg.ssm_d_conv - 1 + cfg.ssm_d_state)
                            * cfg.d_inner})
            if not invariant:
                raise Mismatch(f"{name} embed: rows differ between chunk "
                               f"sizes, blocks or gathers")
            del ex
        rec["peak_memory_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
        out[arch] = rec
        del params, prompt
        torch.cuda.empty_cache()

    # the smoke configs in f32, card against CPU
    cpu = torch.device("cpu")
    smoke = {}
    for arch, _, _ in MOE_MODELS:
        cfg = dataclasses.replace(get_arch(arch).smoke, dtype=torch.float32)
        kinds = [cfg.period_pattern[i % cfg.period]
                 for i in range(cfg.n_layers)]
        n_attn = sum(m == "attn" for m, _ in kinds)
        per_step = n_attn
        p_cpu = model_mod.init_params(cfg,
                                      torch.Generator().manual_seed(SEED))
        p_dev = tree_map(lambda a: a.to(dev), p_cpu)
        xs = np.random.default_rng(SEED).integers(
            0, cfg.vocab, (4, 24 + 3)).astype(np.int64)

        def run(p, d_):
            x = torch.as_tensor(xs).to(d_)
            logits, cache = engine.prefill_step(cfg, p, x[:, :24])
            cache = pad_cache(cfg, cache, 27)
            steps = [logits]
            for j in range(3):
                lj, cache = engine.serve_step(cfg, p, x[:, 24 + j:25 + j],
                                              cache, 24 + j)
                steps.append(lj)
            return [s_.cpu() for s_ in steps]
        got, _ = counted(f"{cfg.name} prefill + 3 steps",
                         lambda: run(p_dev, dev),
                         {"flash_attention": n_attn,
                          "decode_attention": 3 * per_step})
        want = run(p_cpu, cpu)
        smoke[arch] = {f"step {j}": _tol_share(
            f"{cfg.name} logits[{j}] card vs CPU", a.numpy(), b.numpy(),
            FAM_SMOKE_TOL) for j, (a, b) in enumerate(zip(got, want))}
        # the gather dispatch on the card under deterministic algorithms
        # (lm_train's mode): no float atomic sum, so it does not raise,
        # and two train steps give the same bits; its loss and gradients
        # equal the einsum dispatch's within the smoke tolerance
        cg = dataclasses.replace(cfg, moe_impl="gather")
        batch = {"inputs": torch.as_tensor(xs[:, :24]).to(dev),
                 "labels": torch.as_tensor(xs[:, 1:25]).to(dev)}
        torch.use_deterministic_algorithms(True)
        try:
            runs = [value_and_grad(cg, p_dev, batch) for _ in range(2)]
        finally:
            torch.use_deterministic_algorithms(False)
        same = all(torch.equal(a, b) for (_, a), (_, b) in zip(
            tree_items(runs[0][1]), tree_items(runs[1][1]))) and bool(
            torch.equal(runs[0][0], runs[1][0]))
        l_e, g_e = value_and_grad(cfg, p_dev, batch)
        rel = abs(float(runs[0][0]) - float(l_e)) / abs(float(l_e))
        check(f"{cfg.name} gather loss vs einsum (card)", rel, 1e-6,
              deterministic_bitwise=same)
        if not same:
            raise Mismatch(f"{cfg.name}: two gather-dispatch train steps "
                           f"under deterministic algorithms differ")
        want_g = dict(tree_items(g_e))
        share = max(float((g - want_g[path]).abs().max())
                    / (FAM_SMOKE_TOL * max(float(want_g[path].abs().max()),
                                           1e-30))
                    for path, g in tree_items(runs[0][1]))
        check(f"{cfg.name} gather grads vs einsum (card), share of "
              f"{FAM_SMOKE_TOL} of each leaf's largest |value|", share, 1.0)
        smoke[arch]["gather grads vs einsum"] = share
        del runs, g_e
    emit({"phase": "lm_moe_ssm", **out, "smoke_card_vs_cpu": smoke,
          "replayed_max_abs_err": errs,
          "seconds": time.perf_counter() - t_phase, "ok": True})
    return paths, errs, cases


def lm_train(torch, dev, tables):
    """LM training on one card.  Every ported architecture's smoke config
    in f32: one train step's loss and gradients on the card against the
    CPU's, the attention projections' gradients nonzero.  stablelm-1.6b at
    full width under ``Trainer`` (fp32 policy): TRAIN_STEPS steps timed
    with the loss each step and the peak memory (no checkpoint); then at
    full width with the depth cut to TRAIN_RESUME_LAYERS, a run killed
    before step TRAIN_FAIL_AT and resumed from its step-TRAIN_EVERY
    checkpoint ends bitwise equal to the uninterrupted run; B9 and B10
    launch no time, and B9 refuses an operand that requires grad.
    Returns the runs' launch counts."""
    import dataclasses
    import os
    from repro_torch.configs import ARCH_IDS, get_arch
    from repro_torch.data.tokens import TokenPipeline, TokenPipelineConfig
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models import model as model_mod
    from repro_torch.models.layers import tree_items, tree_map
    from repro_torch.train import checkpoint as ckpt_mod
    from repro_torch.train.lm_trainer import (Trainer, TrainLoopConfig,
                                              value_and_grad)
    from repro_torch.train.optimizer import OptConfig
    paths, smoke = {}, {}
    cpu = torch.device("cpu")

    # 1. one train step at every smoke config, card against CPU
    for arch in ARCH_IDS:
        cfg = dataclasses.replace(get_arch(arch).smoke, dtype=torch.float32)
        p_cpu = model_mod.init_params(cfg,
                                      torch.Generator().manual_seed(SEED))
        rng = np.random.default_rng(SEED)
        if cfg.input_kind == "tokens":
            x = rng.integers(0, cfg.vocab, (2, 32)).astype(np.int64)
        else:
            x = rng.standard_normal((2, 32, cfg.d_frontend)
                                    ).astype(np.float32)
        labels = rng.integers(0, cfg.vocab, (2, 32)).astype(np.int64)
        batch = {"inputs": torch.as_tensor(x), "labels": torch.as_tensor(labels)}
        l_cpu, g_cpu = value_and_grad(cfg, p_cpu, batch)
        zero_counts(tables)
        l_dev, g_dev = value_and_grad(
            cfg, tree_map(lambda a: a.to(dev), p_cpu),
            {k: v.to(dev) for k, v in batch.items()})
        torch.cuda.synchronize()
        paths[f"train_smoke[{arch}]"] = read_counts(tables)
        require_launches(f"{arch} smoke train step",
                         paths[f"train_smoke[{arch}]"], {})
        rel = abs(float(l_dev) - float(l_cpu)) / abs(float(l_cpu))
        check(f"{arch} smoke loss card vs CPU", rel, 1e-5,
              loss=float(l_cpu))
        want = dict(tree_items(g_cpu))
        worst = 0.0
        for path, g in tree_items(g_dev):
            g = g.cpu()
            scale = float(want[path].abs().max())
            err = float((g - want[path]).abs().max())
            if not (torch.isfinite(g).all() and err <= FAM_SMOKE_TOL * scale):
                raise Mismatch(f"{arch} smoke grad {path}: {err} > "
                               f"{FAM_SMOKE_TOL} x {scale}")
            worst = max(worst, err / max(scale, 1e-30))
            if (path[-2] == "mixer" and path[-1] in ("wq", "wk", "wv", "wo",
                                                     "wr")
                    and not float(g.abs().max()) > 0.0):
                raise Mismatch(f"{arch} smoke: zero gradient at {path}")
        smoke[arch] = {"loss": float(l_cpu), "loss_rel_err": rel,
                       "grad_max_rel_err": worst}
    emit({"phase": "lm_train_smoke", "tol": FAM_SMOKE_TOL, **smoke,
          "ok": True})

    # 2. stablelm-1.6b at full width under Trainer, and kill-and-resume
    q = torch.zeros((1, 64, 2, 64), device=dev, dtype=torch.bfloat16,
                    requires_grad=True)
    try:
        fa_ops.flash_attention(q, q, q)
        raise Mismatch("flash_attention took an operand that requires grad")
    except ValueError as e:
        refused = "requires grad" in str(e)
    if not refused:
        raise Mismatch("flash_attention: refused for another reason")
    cfg = get_arch(TRAIN_ARCH).config
    cfg_cut = dataclasses.replace(cfg, n_layers=TRAIN_RESUME_LAYERS)
    pipe = TokenPipeline(TokenPipelineConfig(
        vocab=cfg.vocab, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
        seed=SEED))
    opt_cfg = OptConfig(policy="fp32", warmup_steps=2,
                        total_steps=TRAIN_STEPS)

    def trainer(model_cfg, ckpt_dir):
        return Trainer(model_cfg, opt_cfg, TrainLoopConfig(
            total_steps=TRAIN_STEPS, grad_accum=TRAIN_ACCUM,
            ckpt_every=TRAIN_EVERY, keep_last=1, log_every=1,
            ckpt_dir=None if ckpt_dir is None else str(ckpt_dir)),
            pipe, device=dev)

    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    free_gb = shutil.disk_usage(ROOT).free / 1e9
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    try:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        zero_counts(tables)
        run = trainer(cfg, None).run(seed=SEED)
        torch.cuda.synchronize()
        paths["train[full depth]"] = read_counts(tables)
        require_launches("lm_train full depth", paths["train[full depth]"],
                         {})
        peak = torch.cuda.max_memory_allocated(dev)
        hist = run["history"]
        del run
        torch.cuda.empty_cache()
        zero_counts(tables)
        run = trainer(cfg_cut, None).run(seed=SEED)
        torch.cuda.synchronize()
        paths["train[uninterrupted]"] = read_counts(tables)
        require_launches("lm_train uninterrupted",
                         paths["train[uninterrupted]"], {})
        cut_hist = run["history"]
        want = [leaf.detach().cpu() for leaf in
                ckpt_mod.tree_leaves((run["params"], run["opt"]))]
        del run
        torch.cuda.empty_cache()
        zero_counts(tables)
        t0 = time.perf_counter()
        try:
            trainer(cfg_cut, TRAIN_DIR).run(seed=SEED, fail_at=TRAIN_FAIL_AT)
            raise Mismatch("lm_train: the injected failure did not fire")
        except RuntimeError as e:
            if "injected failure" not in str(e):
                raise
        killed_s = time.perf_counter() - t0
        saved = ckpt_mod.list_steps(str(TRAIN_DIR))
        ckpt_gb = sum(f.stat().st_size for f in TRAIN_DIR.rglob("*")
                      if f.is_file()) / 1e9
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        resumed = trainer(cfg_cut, TRAIN_DIR).run(seed=SEED)
        resumed_s = time.perf_counter() - t0
        paths["train[killed and resumed]"] = read_counts(tables)
        require_launches("lm_train killed and resumed",
                         paths["train[killed and resumed]"], {})
        got = ckpt_mod.tree_leaves((resumed["params"], resumed["opt"]))
        same = len(got) == len(want) and all(
            a.dtype == b.dtype and torch.equal(a.cpu(), b)
            for a, b in zip(got, want))
        r_hist = resumed["history"]
        del resumed, got, want
    finally:
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    losses = [h["loss"] for h in hist]
    times = [h["elapsed_s"] for h in hist]
    step_ms = [1e3 * (b - a) for a, b in zip([0.0] + times[:-1], times)]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    emit({"phase": "lm_train", "arch": cfg.name, "layers": cfg.n_layers,
          "d_model": cfg.d_model, "params": cfg.param_count(),
          "policy": opt_cfg.policy, "dtype": str(cfg.dtype),
          "seq_len": TRAIN_SEQ, "global_batch": TRAIN_BATCH,
          "grad_accum": TRAIN_ACCUM, "steps": TRAIN_STEPS,
          "deterministic_algorithms": True,
          "loss_by_step": losses, "grad_norm_by_step":
              [h["grad_norm"] for h in hist],
          "step_ms": step_ms,
          "tokens_per_s_after_first": tokens * (len(times) - 1)
              / (times[-1] - times[0]),
          "peak_memory_gb": peak / 1e9,
          "resume_layers": cfg_cut.n_layers,
          "resume_params": cfg_cut.param_count(),
          "resume_loss_by_step": [h["loss"] for h in cut_hist],
          "checkpoint_steps_before_resume": saved,
          "checkpoint_gb": ckpt_gb, "disk_free_gb_before": free_gb,
          "killed_run_s": killed_s, "resumed_run_s": resumed_s,
          "resumed_steps": [h["step"] for h in r_hist],
          "resumed_losses": [h["loss"] for h in r_hist],
          "b9_refuses_grad": refused, "resume_bitwise": same,
          "ok": same and bool(np.isfinite(losses).all())})
    if not same:
        raise Mismatch("lm_train: the resumed run's final state differs "
                       "from the uninterrupted run's")
    if saved != [TRAIN_EVERY] or not np.isfinite(losses).all():
        raise Mismatch(f"lm_train: checkpoints {saved} before the resume, "
                       f"losses {losses}")
    torch.cuda.empty_cache()
    return paths


# ------------------------------------------------- several devices (A4)
def _fit_arrays(tr) -> dict:
    return {k: np.asarray(getattr(tr, k)) for k in
            ("coefs", "gamma", "lam", "tau", "val_loss", "surf_loss",
             "surf_fa", "surf_det", "iters")}


def _wave_digest(args) -> str:
    """sha256 of a wave's inputs (x, y, task mask, mask, gammas, keys)."""
    h = hashlib.sha256()
    for a in args[:6]:
        h.update(np.ascontiguousarray(np.asarray(
            a.cpu() if hasattr(a, "cpu") else a)).tobytes())
    return h.hexdigest()


def _counted_fit(torch, dev, data, cfg, tables, label: str, mesh=None,
                 axes=None, keep_wave: bool = False):
    """``LiquidSVM(cfg, mesh=...)`` fitted with the launches of its waves
    counted (only those: the counts are set to 0 as each wave starts and
    read as it ends), then its decisions on the held-out rows with the
    test phase's launches counted alone.  The cells are packed for
    MESH_PACK ranks whatever the mesh (``pack_cells`` patched into the
    session), so every fit of the phase solves the same slots.  The
    fit's first B1-sym, B2 and B4 launches and the test phase's B1 and B2
    are replayed against their plain versions (``replay_kernels``).
    Returns (model, fit counts, test counts, seconds, decisions, replays,
    the first wave's (args, kwargs, outputs on the host) when
    ``keep_wave``)."""
    from repro_torch.api import session as session_mod
    from repro_torch.distributed import cell_trainer
    from repro_torch.distributed.planner import pack_cells
    from repro_torch.train.svm_trainer import LiquidSVM
    x, y, xt = data
    solve_wave = cell_trainer.train_cells
    per_wave, waves = [], []

    def counted_wave(*args, **kwargs):
        zero_counts(tables)
        out = solve_wave(*args, **kwargs)
        per_wave.append(read_counts(tables))
        if keep_wave and not waves:
            waves.append((args, kwargs, [o.cpu() for o in out]))
        return out

    model = LiquidSVM(cfg, device=dev, mesh=mesh, mesh_axes=axes)
    cell_trainer.train_cells = counted_wave
    session_mod.pack_cells = lambda plan, n_dev: pack_cells(plan, MESH_PACK)
    try:
        with recorded_kernels(dev, keep=1) as fit_rec:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model.fit(x, y)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
    finally:
        cell_trainer.train_cells = solve_wave
        session_mod.pack_cells = pack_cells
    counts = {k: sum(c[k] for c in per_wave) for k in per_wave[0]}
    zero_counts(tables)
    with recorded_kernels(dev, keep=1) as test_rec:
        dec = model.decision_function(xt)
        torch.cuda.synchronize()
    test_counts = read_counts(tables)
    replays = {
        "fit": replay_kernels(torch, f"{label} fit", fit_rec, {
            "sq_dists_sym": 1, "gram_from_d2": 1, "cd_wave_epoch": 1}),
        "test": replay_kernels(torch, f"{label} test phase", test_rec, {
            "sq_dists": 1, "gram_from_d2": 1})}
    return (model, counts, test_counts, secs, dec, replays,
            waves[0] if waves else None)


def mesh_two_ranks(data, cfg_kw: dict, seed: int):
    """One rank of the two-rank run on one card (``launch.local.run_local``
    with gloo for CPU and CUDA tensors): the fit split over a (2,)
    ``("data",)`` mesh with its own launches replayed, this rank's block
    of the wave solved again alone (bitwise the block it solved under the
    mesh: the same slots at the same batch), and ``ef_psum`` of a seeded
    (1 << 20,) gradient.  Returns numpy results for the parent."""
    import torch
    import torch.distributed as dist
    from repro_torch.distributed import cell_trainer
    from repro_torch.distributed.compression import ef_psum
    from repro_torch.kernels.cd_solver import ops as cd_ops
    from repro_torch.kernels.kernel_matrix import ops as km_ops
    from repro_torch.kernels.svm_predict import ops as sp_ops
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.kernels import runtime
    from repro_torch.train.svm_trainer import SVMTrainerConfig
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = runtime.resolve_device(None)
    rank = dist.get_rank()
    tables = (km_ops.launches, sp_ops.launches, cd_ops.launches)
    mesh = mesh_mod.make_mesh((2,), ("data",))
    cfg = SVMTrainerConfig(**cfg_kw)
    model, counts, test_counts, secs, dec, replays, (args, kw, out) = (
        _counted_fit(torch, dev, data, cfg, tables, f"mesh rank {rank}",
                     mesh, ("data",), keep_wave=True))
    kw = {k: v for k, v in kw.items() if k not in ("mesh", "axis_names")}
    b = cell_trainer._block(args[0].shape[0], mesh, ("data",))
    with runtime.full_fp32():
        alone = cell_trainer.train_cells(
            *[a[b] for a in args[:5]], np.asarray(args[5])[b], *args[6:],
            **kw)
    torch.cuda.synchronize()
    block_same = all(torch.equal(o[b], a.cpu()) for o, a in zip(out, alone))
    g = torch.randn(1 << 20, generator=torch.Generator().manual_seed(
        seed + rank)).to(dev)
    g_hat, err = ef_psum(g, torch.zeros_like(g), "data", mesh)
    torch.cuda.synchronize()
    return {"rank": rank, "device": str(dev), "seconds": secs,
            "launches": counts, "test_launches": test_counts,
            "replays": replays, "block": [b.start, b.stop],
            "wave_digest": _wave_digest(args),
            "wave_out": [o.numpy() for o in out],
            "block_bitwise_alone": bool(block_same),
            "arrays": _fit_arrays(model.train_result), "decisions": dec,
            "ef": {"g": g.cpu().numpy(), "out": g_hat.cpu().numpy(),
                   "err": err.cpu().numpy()}}


def mesh_phase(torch, dev, tables, smi: str):
    """Several devices (A4) on the one card.  Returns the paths' launch
    counts.

    1. One NCCL rank in this process (``cpu:gloo,cuda:nccl`` over a file
       store under MESH_DIR), a (1, 1) ``("data", "model")`` mesh: the
       training cell's widths and settings at MESH_N rows (one wave of
       MESH_SLOTS slots, packed for the MESH_PACK ranks of part 2)
       fitted without a mesh and with it: arrays, launches and held-out
       decisions bitwise equal, each fit's first B1-sym, B2 and B4 and
       its test phase's B1 and B2 replayed; ``ef_psum_tree``
       over stablelm-1.6b's full gradient tree (seeded f32) on the card,
       with ms and bytes, against the CPU's ``ef_psum`` of each leaf at
       MESH_EF_SAMPLE + 1 positions (its largest |g| among them, so the
       scale is the leaf's); one
       ``Trainer`` step of stablelm-1.6b at full width with ``fsdp_params``
       and ``shard_activations`` on the mesh against the unsharded step
       (loss within MESH_LOSS_TOL, parameters within MESH_PARAM_TOL:
       ``test_torch_lm_mesh.py``'s bounds), step ms and peak GB; its
       parameters checkpointed from the mesh and restored into the
       unsharded tree bitwise.
    2. Two ranks on the one card (MESH_TWO_BACKEND; NCCL refuses two ranks
       on one card): the same fit split over a (2,) mesh, each rank's
       launches replayed; each rank's block bitwise its one-process solve
       at the same batch; both ranks' results equal; the gathered wave
       against the fit without a mesh of part 1, which solved the same
       wave (the same inputs, by digest) in one process (``surface_parity``:
       cuBLAS may pick other algorithms for another batch); ``ef_psum``
       over the two ranks equal on both and to its f32 arithmetic done
       here."""
    import dataclasses
    import torch.distributed as dist
    from repro_torch.configs import get_arch
    from repro_torch.kernels import runtime
    from repro_torch.data.synthetic import covtype_like, covtype_like_heldout
    from repro_torch.data.tokens import TokenPipeline, TokenPipelineConfig
    from repro_torch.distributed.compression import ef_psum, ef_psum_tree
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch.local import run_local
    from repro_torch.models import model as model_mod
    from repro_torch.models.layers import tree_items, tree_map
    from repro_torch.train import checkpoint as ckpt_mod
    from repro_torch.train.lm_trainer import Trainer, TrainLoopConfig
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.svm_trainer import SVMTrainerConfig
    shutil.rmtree(MESH_DIR, ignore_errors=True)
    MESH_DIR.mkdir(parents=True)
    x, y = covtype_like(n=MESH_N, d=DIM, n_classes=N_CLASSES, seed=SEED)
    xt, _ = covtype_like_heldout(MESH_HELDOUT, n=MESH_N, d=DIM,
                                 n_classes=N_CLASSES, seed=SEED,
                                 new_seed=HELDOUT_SEED)
    data = (x, y, xt)
    cfg_kw = dict(TRAIN_CFG, n_slots_per_wave=MESH_SLOTS)
    cfg = SVMTrainerConfig(**cfg_kw)
    paths = {}
    out = {"phase": "mesh", "card": smi, "n": int(x.shape[0]),
           "slots": MESH_SLOTS}

    # ------------------------------------------------ 1. one NCCL rank
    dist.init_process_group("cpu:gloo,cuda:nccl",
                            init_method=f"file://{MESH_DIR / 'store'}",
                            rank=0, world_size=1)
    try:
        mesh = mesh_mod.make_mesh((1, 1), ("data", "model"))
        axes = ("data", "model")
        plain, n_plain, t_plain, s_plain, dec_plain, rep_plain, wave = (
            _counted_fit(torch, dev, data, cfg, tables, "mesh unmeshed",
                         keep_wave=True))
        meshed, n_mesh, t_mesh, s_mesh, dec_mesh, rep_mesh, _ = _counted_fit(
            torch, dev, data, cfg, tables, "mesh (1, 1)", mesh, axes)
        paths.update({"fit": n_plain, "test": t_plain,
                      "fit[(1, 1) mesh]": n_mesh,
                      "test[(1, 1) mesh]": t_mesh})
        expect_fit = {k: v for k, v in n_plain.items() if v}
        expect_test = {k: v for k, v in t_plain.items() if v}
        if set(expect_fit) != {"sq_dists_sym", "gram_from_d2",
                               "cd_wave_epoch"} or set(expect_test) != {
                "sq_dists", "gram_from_d2"}:
            raise Mismatch(f"mesh: the fit launched {n_plain}, its test "
                           f"phase {t_plain}")
        a, b = _fit_arrays(plain.train_result), _fit_arrays(
            meshed.train_result)
        same = all(np.array_equal(a[k], b[k]) for k in a)
        if plain.packed.n_slots > MESH_SLOTS:
            raise Mismatch(f"mesh: {plain.packed.n_slots} slots, more than "
                           f"one wave of {MESH_SLOTS}")
        require_launches("mesh fit on one rank", n_mesh, expect_fit)
        require_launches("mesh test phase on one rank", t_mesh, expect_test)
        out["one_rank"] = {
            "backend": "cpu:gloo,cuda:nccl", "mesh": [1, 1],
            "cells": plain.plan.n_cells, "k_max": plain.plan.k_max,
            "fit_s": s_plain, "mesh_fit_s": s_mesh, "launches": n_plain,
            "mesh_launches": n_mesh, "test_launches": t_plain,
            "mesh_test_launches": t_mesh, "replays": {
                "unmeshed": rep_plain, "mesh": rep_mesh},
            "arrays_bitwise": same,
            "decisions_bitwise": bool(np.array_equal(dec_plain, dec_mesh))}
        if not (same and out["one_rank"]["decisions_bitwise"]):
            raise Mismatch("mesh: the (1, 1) mesh fit differs from the fit "
                           "without a mesh")
        emit({"phase": "mesh_one_rank", **out["one_rank"]})
        del plain, meshed

        # ef_psum_tree over the full gradient tree, card against CPU
        lm = get_arch(TRAIN_ARCH).config
        cpu_mesh = mesh_mod.make_mesh((1,), ("pod",), "cpu")
        dev_mesh = mesh_mod.make_mesh((1,), ("pod",))
        gen = torch.Generator(device=dev).manual_seed(SEED)
        grads = tree_map(lambda s: torch.randn(
            s.shape, generator=gen, device=dev, dtype=torch.float32) * 1e-3,
            model_mod.build_template(lm))
        errs = tree_map(torch.zeros_like, grads)
        n_el = sum(g.numel() for _, g in tree_items(grads))
        ef_psum_tree(grads, errs, "pod", dev_mesh)       # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        g_hat, new_err = ef_psum_tree(grads, errs, "pod", dev_mesh)
        torch.cuda.synchronize()
        ef_ms = (time.perf_counter() - t0) * 1e3
        # the CPU's ef_psum of each leaf at MESH_EF_SAMPLE + 1 positions:
        # its first MESH_EF_SAMPLE and the one of largest |g|, so the
        # sample's scale is the leaf's (the whole tree took 36 s on the
        # host CPU of an H100 machine)
        worst = {"out": 0.0, "err": 0.0}
        t0 = time.perf_counter()
        for (path, g), (_, o), (_, e) in zip(tree_items(grads),
                                             tree_items(g_hat),
                                             tree_items(new_err)):
            flat = g.reshape(-1)
            idx = torch.cat([torch.arange(min(MESH_EF_SAMPLE, flat.numel()),
                                          device=dev),
                             torch.argmax(flat.abs())[None]])
            gc = flat[idx].cpu()
            oc, ec = ef_psum(gc, torch.zeros_like(gc), "pod", cpu_mesh)
            worst["out"] = max(worst["out"], float(
                (o.reshape(-1)[idx].cpu() - oc).abs().max()))
            worst["err"] = max(worst["err"], float(
                (e.reshape(-1)[idx].cpu() - ec).abs().max()))
        cpu_s = time.perf_counter() - t0
        out["ef_psum_tree"] = {
            "arch": lm.name, "leaves": len(list(tree_items(grads))),
            "elements": n_el, "ms": ef_ms, "f32_bytes": 4 * n_el,
            "int8_wire_bytes": n_el, "int32_reduced_bytes": 4 * n_el,
            "max_abs_diff_vs_cpu": worst, "cpu_positions_per_leaf":
                MESH_EF_SAMPLE + 1, "cpu_s": cpu_s}
        emit({"phase": "mesh_ef_psum_tree", **out["ef_psum_tree"]})
        del grads, errs, g_hat, new_err
        torch.cuda.empty_cache()
        if worst["out"] or worst["err"]:
            raise Mismatch(f"ef_psum_tree on the card vs the CPU: {worst}")

        # one sharded Trainer step against the unsharded step
        lm_cfg = dataclasses.replace(lm, fsdp_params=True,
                                     batch_axes=("data",),
                                     shard_activations=True)
        pipe = TokenPipeline(TokenPipelineConfig(
            vocab=lm.vocab, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
            seed=SEED))
        opt_cfg = OptConfig(policy="fp32", warmup_steps=2,
                            total_steps=TRAIN_STEPS)
        loop = TrainLoopConfig(total_steps=1, grad_accum=TRAIN_ACCUM,
                               ckpt_every=100, log_every=1)
        steps = {}
        for label, m in (("unsharded", None), ("mesh", mesh)):
            zero_counts(tables)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            run = Trainer(lm_cfg, opt_cfg, loop, pipe, mesh=m,
                          device=dev).run(seed=SEED)
            torch.cuda.synchronize()
            full = {p: (v.full_tensor() if m is not None else v)
                    for p, v in tree_items(run["params"])}
            steps[label] = {
                "run_s": time.perf_counter() - t0,
                "step_ms": 1e3 * run["history"][0]["elapsed_s"],
                "loss": run["history"][0]["loss"],
                "grad_norm": run["history"][0]["grad_norm"],
                "peak_memory_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
                "launches": read_counts(tables)}
            paths[f"lm_step[{label}]"] = steps[label]["launches"]
            require_launches(f"mesh lm step {label}",
                             steps[label]["launches"], {})
            if m is None:
                # host memory, so the mesh run's peak is its own; compared
                # leaf by leaf on the card
                want = {p: v.cpu() for p, v in full.items()}
            else:
                d_param = max(float((v.float() - want[p].to(dev).float())
                                    .abs().max()) for p, v in full.items())
                # its parameters checkpointed from the mesh, restored into
                # the unsharded tree
                t1 = time.perf_counter()
                ckpt_mod.save_checkpoint(str(MESH_DIR / "ckpt"), 1,
                                         run["params"])
                save_s = time.perf_counter() - t1
                t1 = time.perf_counter()
                stored, _, _ = ckpt_mod.restore_checkpoint(
                    str(MESH_DIR / "ckpt"), tree_map(
                        lambda s: 0, model_mod.build_template(lm_cfg)))
                restore_s = time.perf_counter() - t1
                restored = all(torch.equal(torch.as_tensor(v).to(dev),
                                           full[p])
                               for p, v in tree_items(stored))
                del stored
            del run, full
        torch.cuda.empty_cache()
        d_loss = abs(steps["mesh"]["loss"] - steps["unsharded"]["loss"])
        out["lm_step"] = {"arch": lm_cfg.name, "fsdp_params": True,
                          "shard_activations": True,
                          "seq_len": TRAIN_SEQ, "global_batch": TRAIN_BATCH,
                          "grad_accum": TRAIN_ACCUM, **steps,
                          "loss_diff": d_loss, "max_param_diff": d_param,
                          "tol": [MESH_LOSS_TOL, MESH_PARAM_TOL],
                          "checkpoint_save_s": save_s,
                          "checkpoint_restore_s": restore_s,
                          "restored_unsharded_bitwise": restored}
        emit({"phase": "mesh_lm_step", **out["lm_step"],
              "earlier_step_s": MESH_STEP_BEFORE_S})
        del want
        if not (d_loss < MESH_LOSS_TOL and d_param < MESH_PARAM_TOL):
            raise Mismatch(f"mesh lm step: loss diff {d_loss}, param diff "
                           f"{d_param}")
        if not restored:
            raise Mismatch("mesh lm step: the checkpoint restored into the "
                           "unsharded tree differs")
    finally:
        dist.destroy_process_group()
        shutil.rmtree(MESH_DIR / "ckpt", ignore_errors=True)

    # ------------------------------------------- 2. two ranks, one card
    t0 = time.perf_counter()
    ranks = run_local(mesh_two_ranks, 2, data, cfg_kw, SEED,
                      backend=MESH_TWO_BACKEND, threads=None, timeout=600,
                      work_dir=str(MESH_DIR))
    two_s = time.perf_counter() - t0
    r0, r1 = ranks
    both_same = all(np.array_equal(r0["arrays"][k], r1["arrays"][k])
                    for k in r0["arrays"]) and np.array_equal(
        r0["decisions"], r1["decisions"])
    for r in ranks:
        # each rank runs the one wave's B1-sym / B2 / B4 on its block, and
        # its block's test phase (B1, B2)
        require_launches(f"mesh two ranks: rank {r['rank']}", r["launches"],
                         expect_fit)
        if set(k for k, v in r["test_launches"].items() if v) != set(
                expect_test):
            raise Mismatch(f"mesh two ranks: rank {r['rank']}'s test phase "
                           f"launched {r['test_launches']}")
    # the gathered wave against the fit without a mesh, which solved the
    # same wave in one process (cuBLAS may pick other algorithms for
    # another batch: the CPU-vs-card tolerance of small_fit_parity)
    from repro_torch.core.cv import make_fold_masks
    from repro_torch.core.select import argmin_winners
    from repro_torch.distributed import cell_trainer
    w_args, _, w_out = wave
    if any(r["wave_digest"] != _wave_digest(w_args) for r in ranks):
        raise Mismatch("mesh two ranks: their wave's inputs differ from "
                       "the one-rank fit's")
    surf = cell_trainer.wave_keys(w_args[9]).index("surf_loss")
    mask_w = w_args[3].cpu()
    vmask = make_fold_masks(np.asarray(w_args[5]), mask_w, cfg.n_folds)
    parity = surface_parity(vmask, mask_w.numpy(), w_out[surf].numpy(),
                            r0["wave_out"][surf], argmin_winners)
    del wave, w_args, w_out
    g = np.stack([r["ef"]["g"] for r in ranks])
    f32 = np.float32
    scale = max(f32(np.abs(g).max()) / f32(127.0), f32(1e-30))
    q = np.clip(np.round(g / scale), -127, 127)
    want_out = q.sum(0).astype(f32) * scale / f32(2)
    ef_diff = max(float(np.abs(r["ef"]["out"] - want_out).max())
                  for r in ranks)
    err_diff = max(float(np.abs(r["ef"]["err"] - (g[i] - q[i].astype(f32)
                                                  * scale)).max())
                   for i, r in enumerate(ranks))
    out["two_ranks"] = {
        "backend": MESH_TWO_BACKEND, "mesh": [2], "seconds": two_s,
        "fit_s": [r["seconds"] for r in ranks],
        "devices": [r["device"] for r in ranks],
        "blocks": [r["block"] for r in ranks],
        "launches": [r["launches"] for r in ranks],
        "test_launches": [r["test_launches"] for r in ranks],
        "replays": [r["replays"] for r in ranks],
        "blocks_bitwise_alone": [r["block_bitwise_alone"] for r in ranks],
        "ranks_equal": both_same, "vs_unmeshed_fit": parity,
        "ef_psum": {"elements": int(g.shape[1]), "max_abs_diff": ef_diff,
                    "residual_max_abs_diff": err_diff}}
    for i, r in enumerate(ranks):
        paths[f"two_ranks[rank {i}]"] = r["launches"]
        paths[f"two_ranks_test[rank {i}]"] = r["test_launches"]
    out["ok"] = bool(all(r["block_bitwise_alone"] for r in ranks)
                     and both_same and parity["ok"] and ef_diff == 0.0
                     and err_diff <= 2.0 ** -23 * float(np.abs(g).max()))
    emit(out)
    shutil.rmtree(MESH_DIR, ignore_errors=True)
    if not out["ok"]:
        raise Mismatch(f"mesh: two ranks {out['two_ranks']}")
    return paths


def mesh_prefill_ranks(seed: int):
    """One rank of the head-parallel prefill on one card
    (``run_local`` over MESH_TWO_BACKEND), in f32 and in bf16:
    stablelm-1.6b at full width, its parameters drawn from ``seed`` and
    split over a (1, 2) ("data", "model") mesh by their templates'
    placements, a prefill of MESH_PREFILL_B x MESH_PREFILL_T seeded tokens
    with B9's launches counted and its first launch recorded, and the
    regions that ran.  Then MESH_DECODE_NEW decode steps with the prompt's
    cache split over the sequence ('model': each rank its half of the
    ring, placed as ``launch.shapes.cache_structs`` places it): B10's
    partials mode counted and its first launch recorded, each step fed
    the unsharded decode's greedy token.  Each rank first runs the
    unsharded prefill and decode (the cache to split, the tokens, and on
    rank 0 the logits to hold them against).  The vocab-split logits are
    gathered by c10d (torch 2.11's DTensor gather of CUDA tensors over
    gloo ends the rank with SIGSEGV)."""
    import dataclasses
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, distribute_tensor
    from repro_torch.configs import get_arch
    from repro_torch.kernels import runtime
    from repro_torch.configs.common import ShapeSpec
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch.shapes import cache_structs
    from repro_torch.models import layers, model as model_mod
    from repro_torch.serve.kv_cache import pad_cache
    dev = runtime.resolve_device(None)
    rank = dist.get_rank()
    mesh = mesh_mod.make_mesh((1, 2), ("data", "model"))
    tables = (fa_ops.launches, dec_ops.launches)
    ring = MESH_PREFILL_T + MESH_DECODE_NEW
    out = {"rank": rank, "device": str(dev)}
    for dtype in (torch.float32, torch.bfloat16):
        cfg = dataclasses.replace(get_arch(LM_ARCH).config, dtype=dtype)
        params = model_mod.init_params(cfg, torch.Generator(
            device=dev).manual_seed(seed))
        tok = torch.randint(0, cfg.vocab, (MESH_PREFILL_B, MESH_PREFILL_T),
                            generator=torch.Generator(device=dev).manual_seed(
                                seed + 1), device=dev, dtype=torch.int32)
        # the unsharded prefill and decode on every rank: the cache to
        # split, the greedy tokens to feed, rank 0's logits to hold against
        want, cache0 = model_mod.prefill(cfg, params, tok)
        cache0 = pad_cache(cfg, cache0, ring)
        split0 = layers.tree_map(lambda t: t.clone(), cache0)
        feed, want_dec = [], []
        nxt = torch.argmax(want, -1).to(torch.int32)[:, None]
        for i in range(MESH_DECODE_NEW):
            feed.append(nxt)
            lg, cache0 = model_mod.decode_step(cfg, params, nxt, cache0,
                                               MESH_PREFILL_T + i)
            want_dec.append(lg.cpu())
            nxt = torch.argmax(lg, -1).to(torch.int32)[:, None]
        del cache0
        want = want.cpu() if rank == 0 else None
        sharded = layers.tree_map(lambda a, pl: distribute_tensor(
            a, mesh, pl, src_data_rank=None), params,
            layers.sharding_tree(model_mod.build_template(cfg), mesh))
        del params
        torch.cuda.empty_cache()
        tok_d = distribute_tensor(tok, mesh, [Replicate(), Replicate()],
                                  src_data_rank=None)
        calls = []
        zero_counts(tables)
        layers.REGION_TRACE = []
        try:
            with recorded(fa_ops, "flash_attention", calls, keep=1):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                logits, _ = model_mod.prefill(cfg, sharded, tok_d)
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
            regions = sorted({(n, tuple(sorted(i.items())))
                              for n, i in layers.REGION_TRACE})
        finally:
            layers.REGION_TRACE = None
        got = layers.all_gather(logits.to_local(), 1,
                                mesh.get_group("model")).cpu()
        args, kw, o = calls[0]
        out[str(dtype)[6:]] = {
            "seconds": secs, "launches": read_counts(tables),
            "regions": regions, "logits": got, "want": want,
            "call": (tuple(a.cpu() for a in args), kw, o.cpu())}
        del logits
        # decode with the cache split over the sequence (flash-decoding)
        structs = cache_structs(dataclasses.replace(cfg, seq_axes=("model",)),
                                ShapeSpec("decode", "decode", ring,
                                          MESH_PREFILL_B), mesh)
        cache_d = layers.tree_map(lambda a, st: distribute_tensor(
            a, mesh, st.placements, src_data_rank=None), split0, structs)
        del split0
        dcalls, dec_got = [], []
        zero_counts(tables)
        layers.REGION_TRACE = []

        def launched(a, kw):     # a block with a visible key launches
            return dec_ops.block_visible_range(
                kw["block"][1], a[3], kw.get("window", 0), kw["block"][0],
                a[1].shape[1])[1] > 0
        try:
            with recorded(dec_ops, "decode_attention_partials", dcalls,
                          keep=1, key=launched):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for i, nxt in enumerate(feed):
                    lg, cache_d = model_mod.decode_step(
                        cfg, sharded, distribute_tensor(
                            nxt, mesh, [Replicate(), Replicate()],
                            src_data_rank=None), cache_d, MESH_PREFILL_T + i)
                    dec_got.append(layers.all_gather(
                        lg.to_local(), 1, mesh.get_group("model")).cpu())
                torch.cuda.synchronize()
                dsecs = time.perf_counter() - t0
            dregions = sorted({(n, tuple(sorted(i.items())))
                               for n, i in layers.REGION_TRACE})
        finally:
            layers.REGION_TRACE = None
        args, kw, o = dcalls[0]
        out[str(dtype)[6:]]["decode"] = {
            "seconds": dsecs, "launches": read_counts(tables),
            "regions": dregions, "logits": dec_got,
            "want": want_dec if rank == 0 else None,
            "call": (tuple(a.cpu() if hasattr(a, "cpu") else a
                           for a in args), kw, tuple(x.cpu() for x in o))}
        del sharded, cache_d
        torch.cuda.empty_cache()
    return out


def local_head_shapes(model: int = 16):
    """(arch, heads, kv heads, head dim, mask kind) a rank runs B9 at when
    each attention config's prefill is head-parallel over ``model``
    'model' ranks (the production mesh's 16): its query heads and the kv
    heads they read, by head group where the ranks do not divide the
    heads (``models.attention.head_groups``: gemma3-4b 1 head, llama4 5)."""
    from repro_torch.configs import ARCH_IDS, get_arch
    from repro_torch.models.attention import head_groups
    out = []
    for arch in ARCH_IDS:
        c = get_arch(arch).config
        if not any(m.startswith("attn") for m, _ in c.period_pattern):
            continue
        grp = head_groups(c.n_heads, c.n_kv_heads, c.head_dim, model)
        out.append((arch, grp.heads, grp.kv, c.head_dim,
                    "bidir" if not c.is_decoder else "causal"))
    return out


def mesh_prefill(torch, dev, tables):
    """Head-parallel prefill (A4b) on the one card.  Returns (the ranks'
    launch counts, the replayed launches' errors, their timing cases).

    1. Two ranks (MESH_TWO_BACKEND, ``mesh_prefill_ranks``): stablelm-1.6b
       at full width over a (1, 2) ("data", "model") mesh, each rank its
       16 of the 32 heads, in f32 and in bf16: B9 once a layer at the
       local 16 heads, the embedding vocab-parallel (50,176 rows a rank),
       no ``run_on_rows``; the gathered logits equal on both ranks and
       held against the unsharded prefill: in f32 within ``attn_tol``
       (the sharded sums only reorder f32 additions), in bf16 within
       LM_LOGIT_TOL of the largest logit (each rank rounds its part of
       every row-split product to bf16 before the sum, another order of
       bf16 roundings, as the kernel-vs-plain paths are held); the greedy
       tokens compared; each rank's first B9 launch replayed here against
       the plain version (``attn_replay``).  Then MESH_DECODE_NEW decode
       steps with the cache split over the sequence (each rank its half of
       the ring): B10's partials mode once a layer a step, attention
       through the ``decode_attention`` region only (no ``run_on_rows``),
       the logits held against the unsharded decode within the prefill's
       bounds, the greedy tokens compared, and each rank's first partials
       launch replayed against the plain partials.
    2. B9 at the local heads of every head-parallel config at the
       production mesh (``local_head_shapes``: 1 x LOCAL_HEADS_T tokens,
       seeded operands, bf16) against the plain version."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch.local import run_local
    t0 = time.perf_counter()
    cfg = get_arch(LM_ARCH).config
    MESH_DIR.mkdir(parents=True, exist_ok=True)
    ranks = run_local(mesh_prefill_ranks, 2, SEED, backend=MESH_TWO_BACKEND,
                      threads=None, timeout=600, work_dir=str(MESH_DIR))
    shutil.rmtree(MESH_DIR, ignore_errors=True)
    paths, errs, cases, report = {}, {}, [], {}
    h_loc = cfg.n_heads // 2
    regions = [("attention", (("heads", h_loc), ("kv_heads", h_loc))),
               ("dense", (("ff", cfg.d_ff // 2),)),
               ("embed", (("vocab_rows", cfg.vocab // 2),)), ("norm", ())]
    ring = MESH_PREFILL_T + MESH_DECODE_NEW
    dec_regions = [sorted([
        ("decode_attention", (("heads", cfg.n_heads), ("seq_block", blk))),
        ("dense", (("ff", cfg.d_ff // 2),)),
        ("embed", (("vocab_rows", cfg.vocab // 2),)), ("norm", ())])
        for blk in (-(-ring // 2), ring - -(-ring // 2))]
    for dt in ("float32", "bfloat16"):
        want = ranks[0][dt]["want"]
        for r in ranks:
            got = r[dt]
            label = f"mesh prefill (1, 2) {dt} rank {r['rank']}"
            require_launches(label, got["launches"],
                             {"flash_attention": cfg.n_layers})
            paths[f"prefill_two_ranks[{dt} rank {r['rank']}]"] = got[
                "launches"]
            if got["regions"] != regions:
                raise Mismatch(f"{label}: regions {got['regions']}, "
                               f"expected {regions}")
            name = f"{label}: logits vs the unsharded prefill"
            if dt == "float32":
                check(name, float((got["logits"] - want).abs().max()),
                      attn_tol(want))
            else:
                _tol_share(name, got["logits"].float(), want.float(),
                           LM_LOGIT_TOL)
            args, kw, out = got["call"]
            err, case = attn_replay(torch, f"mesh prefill (1, 2) rank "
                                    f"{r['rank']}", "first launch",
                                    "flash_attention",
                                    (tuple(a.to(dev) for a in args), kw,
                                     out.to(dev)))
            errs[case[0]] = err
            cases.append(case + (f"prefill_two_ranks[{dt} rank "
                                 f"{r['rank']}]",))
            dec = got["decode"]
            path = f"decode_two_ranks[{dt} rank {r['rank']}]"
            require_launches(f"mesh decode (1, 2) {dt} rank {r['rank']}",
                             dec["launches"], {"decode_attention_partials":
                                               cfg.n_layers * MESH_DECODE_NEW})
            paths[path] = dec["launches"]
            if dec["regions"] != dec_regions[r["rank"]]:
                raise Mismatch(f"mesh decode {dt} rank {r['rank']}: regions "
                               f"{dec['regions']}, expected "
                               f"{dec_regions[r['rank']]}")
            for i, (lg, w) in enumerate(zip(dec["logits"],
                                            ranks[0][dt]["decode"]["want"])):
                name = (f"mesh decode (1, 2) {dt} rank {r['rank']} step {i}: "
                        f"logits vs the unsharded decode")
                if dt == "float32":
                    check(name, float((lg - w).abs().max()), attn_tol(w))
                else:
                    _tol_share(name, lg.float(), w.float(), LM_LOGIT_TOL)
            args, kw, out = dec["call"]
            err, case = attn_replay(
                torch, f"mesh decode (1, 2) rank {r['rank']}", "first launch",
                "decode_attention_partials",
                (tuple(a.to(dev) if hasattr(a, "to") else a for a in args),
                 kw, tuple(x.to(dev) for x in out)))
            errs[case[0]] = err
            cases.append(case + (path,))
        if not torch.equal(ranks[0][dt]["logits"], ranks[1][dt]["logits"]):
            raise Mismatch(f"mesh prefill {dt}: the two ranks' logits "
                           f"differ")
        report[dt] = {
            "prefill_s": [r[dt]["seconds"] for r in ranks],
            "logits_max_abs_diff": float((ranks[0][dt]["logits"].float()
                                          - want.float()).abs().max()),
            "max_abs_logit": float(want.float().abs().max()),
            "greedy_equal": int((ranks[0][dt]["logits"].argmax(-1)
                                 == want.argmax(-1)).sum()),
            "decode": {
                "steps": MESH_DECODE_NEW, "ring": ring,
                "seconds": [r[dt]["decode"]["seconds"] for r in ranks],
                "logits_max_abs_diff": max(
                    float((g.float() - w.float()).abs().max())
                    for r in ranks for g, w in zip(
                        r[dt]["decode"]["logits"],
                        ranks[0][dt]["decode"]["want"])),
                "max_abs_logit": max(float(w.float().abs().max()) for w in
                                     ranks[0][dt]["decode"]["want"]),
                "greedy_equal": sum(int((g.argmax(-1) == w.argmax(-1)).sum())
                                    for g, w in zip(
                                        ranks[0][dt]["decode"]["logits"],
                                        ranks[0][dt]["decode"]["want"])),
                "greedy_of": MESH_DECODE_NEW * MESH_PREFILL_B}}
    gen = torch.Generator(device=dev).manual_seed(SEED)
    for arch, h, hk, d, kind in local_head_shapes():
        q = torch.randn(1, LOCAL_HEADS_T, h, d, generator=gen, device=dev,
                        dtype=torch.bfloat16)
        k, v = (torch.randn(1, LOCAL_HEADS_T, hk, d, generator=gen,
                            device=dev, dtype=torch.bfloat16)
                for _ in range(2))
        out = fa_ops.flash_attention(q, k, v, mask_kind=kind)
        err, case = attn_replay(torch, f"{arch} at 16 'model' ranks",
                                "local heads", "flash_attention",
                                ((q, k, v), {"mask_kind": kind}, out))
        errs[case[0]] = err
        cases.append(case + (None,))
    emit({"phase": "mesh_prefill", "arch": cfg.name, "mesh": [1, 2],
          "backend": MESH_TWO_BACKEND,
          "tokens": [MESH_PREFILL_B, MESH_PREFILL_T],
          "devices": [r["device"] for r in ranks],
          "regions": [n for n, _ in regions], **report,
          "local_head_shapes": local_head_shapes(),
          "seconds": time.perf_counter() - t0,
          "earlier_seconds": MESH_PREFILL_BEFORE_S})
    return paths, errs, cases


def seeded_params(torch, cfg, seed: int, dev, mesh=None):
    """``cfg``'s parameters drawn on the card leaf by leaf (the template's
    init recipes, as ``models.layers.init_params``), each leaf in chunks
    of UNEVEN_CHUNK leading rows, each chunk from a generator of its own
    seed: the same values whoever draws them, and a rank draws only the
    chunks its block meets.  With ``mesh`` each leaf is this rank's block
    as a DTensor on the template's placements; the whole model never lies
    on a rank.  Without, the whole leaves."""
    import math
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    from repro_torch.models import layers, model as model_mod
    tmpl = model_mod.build_template(cfg)
    pls = dict(layers.tree_items(layers.sharding_tree(tmpl, mesh))
               ) if mesh is not None else {}
    items = []
    for li, (path, ps) in enumerate(layers.tree_items(tmpl)):
        shape = tuple(ps.shape)
        if mesh is None:
            lshape, off = shape, (0,) * len(shape)
        else:
            lshape, off = compute_local_shape_and_global_offset(
                shape, mesh, pls[path])
        if ps.init in ("zeros", "ones"):
            local = torch.full(tuple(lshape), float(ps.init == "ones"),
                               dtype=ps.dtype, device=dev)
        else:
            fan = ps.fan if ps.fan is not None else (
                shape[0] if len(shape) <= 2 else math.prod(shape[:-1]))
            std = ps.scale if ps.init == "normal" else ps.scale / math.sqrt(
                max(fan, 1))
            cols = tuple(slice(o, o + n) for o, n in zip(off[1:],
                                                          lshape[1:]))
            parts = []
            for c, lo in enumerate(range(0, shape[0], UNEVEN_CHUNK)):
                hi = min(lo + UNEVEN_CHUNK, shape[0])
                a, b = max(lo, off[0]), min(hi, off[0] + lshape[0])
                if a >= b:
                    continue
                gen = torch.Generator(device=dev).manual_seed(
                    seed * 1_000_003 + li * 1009 + c)
                v = torch.randn((hi - lo,) + shape[1:], generator=gen,
                                dtype=torch.float32, device=dev)
                parts.append((v[(slice(a - lo, b - lo),) + cols] * std)
                             .to(ps.dtype))
                del v
            local = (torch.cat(parts) if parts else torch.empty(
                tuple(lshape), dtype=ps.dtype, device=dev))
        if mesh is not None:
            local = DTensor.from_local(
                local.contiguous(), mesh, pls[path], run_check=False,
                shape=torch.Size(shape),
                stride=layers._contiguous_stride(shape))
        items.append((path, local))
    return layers.tree_from_items(items)


def mesh_uneven_ranks(seed: int):
    """One rank of attention by head group on one card (``run_local`` over
    MESH_TWO_BACKEND), in f32 and in bf16: gemma3-4b at its published
    widths and UNEVEN_LAYERS layers, its parameters drawn from ``seed``
    (``seeded_params``: this rank's blocks on their templates' placements
    over a (1, 16) ("data", "model") mesh), a prefill of UNEVEN_B x
    UNEVEN_T seeded tokens (B9 counted, its first launch replayed here
    against the plain version, the regions that ran), then
    MESH_DECODE_NEW decode steps on the prefill's own cache padded to the
    ring and split over the sequence as ``launch.shapes.cache_structs``
    places it (no communication: the prefill lays out every row with the
    heads whole on each rank), B10's partials mode counted and its first
    launch replayed; each step fed rank 0's unsharded greedy token.  Rank
    0 first runs the unsharded prefill and decode (the logits to hold
    the ranks against, the tokens to feed) and returns its first launches
    for timing.  The vocab-split logits are gathered by c10d."""
    import dataclasses
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, distribute_tensor
    from repro_torch.configs import get_arch
    from repro_torch.configs.common import ShapeSpec
    from repro_torch.kernels import runtime
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.kernels.decode_attention import ref as dec_ref
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch.shapes import cache_structs
    from repro_torch.models import layers, model as model_mod
    from repro_torch.serve.kv_cache import pad_cache
    dev = runtime.resolve_device(None)
    rank = dist.get_rank()
    mesh = mesh_mod.make_mesh(UNEVEN_MESH, ("data", "model"))
    group = mesh.get_group("model")
    tables = (fa_ops.launches, dec_ops.launches)
    ring = UNEVEN_T + MESH_DECODE_NEW
    rep = [Replicate(), Replicate()]
    out = {"rank": rank, "device": str(dev)}
    for dtype in (torch.float32, torch.bfloat16):
        cfg = dataclasses.replace(get_arch(UNEVEN_ARCH).config,
                                  n_layers=UNEVEN_LAYERS, dtype=dtype)
        tok = torch.randint(0, cfg.vocab, (UNEVEN_B, UNEVEN_T),
                            generator=torch.Generator(device=dev).manual_seed(
                                seed + 1), device=dev, dtype=torch.int32)
        res = {}
        feed = None
        if rank == 0:            # the unsharded prefill and decode
            params = seeded_params(torch, cfg, seed, dev)
            t0 = time.perf_counter()
            want, cache0 = model_mod.prefill(cfg, params, tok)
            torch.cuda.synchronize()
            res["unsharded_prefill_s"] = time.perf_counter() - t0
            cache0 = pad_cache(cfg, cache0, ring)
            feed, want_dec = [], []
            nxt = torch.argmax(want, -1).to(torch.int32)[:, None]
            for i in range(MESH_DECODE_NEW):
                feed.append(nxt.cpu())
                lg, cache0 = model_mod.decode_step(cfg, params, nxt, cache0,
                                                   UNEVEN_T + i)
                want_dec.append(lg.cpu())
                nxt = torch.argmax(lg, -1).to(torch.int32)[:, None]
            res["want"], res["want_dec"] = want.cpu(), want_dec
            del params, cache0, want
            torch.cuda.empty_cache()
        box = [feed]
        dist.broadcast_object_list(box, src=0)
        feed = box[0]
        sharded = seeded_params(torch, cfg, seed, dev, mesh)
        tok_d = distribute_tensor(tok, mesh, rep, src_data_rank=None)
        calls = []
        zero_counts(tables)
        layers.REGION_TRACE = []
        try:
            with recorded(fa_ops, "flash_attention", calls, keep=1):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                logits, cache = model_mod.prefill(cfg, sharded, tok_d)
                torch.cuda.synchronize()
                res["seconds"] = time.perf_counter() - t0
            res["regions"] = sorted({(n, tuple(sorted(i.items())))
                                     for n, i in layers.REGION_TRACE})
        finally:
            layers.REGION_TRACE = None
        res["launches"] = read_counts(tables)
        res["logits"] = layers.all_gather(logits.to_local(), 1, group).cpu()
        del logits
        # the first B9 launch against the plain version, here
        (q, k, v), kw, o = calls[0]
        kind, win = kw.get("mask_kind", "causal"), kw.get("window", 0)
        want = fa_ref.flash_attention_ref(q, k, v, kind, win)
        diff = (o.float() - want.float()).abs()
        res["b9_replay"] = {
            "shape": [*q.shape, k.shape[2]], "kind": kind, "window": win,
            "err": float(diff.max()), "tol": attn_tol(want),
            "over_bound": float((diff / attn_err_bound(
                fa_ref, q, k, v, kind, win, want)).max())
            if q.dtype == torch.bfloat16 else None}
        if rank == 0:
            res["b9_call"] = ((q.cpu(), k.cpu(), v.cpu()), kw, o.cpu())
        del calls, q, k, v, o, want, diff
        # decode on the prefill's own cache: every row, the heads whole
        local = layers.tree_map(lambda t: t.to_local(), cache)
        if any(a.shape != t.shape for a, t in zip(
                (a for _, a in layers.tree_items(local)),
                (t for _, t in layers.tree_items(cache)))):
            raise Mismatch(f"mesh uneven rank {rank}: the prefill's cache "
                           f"is not whole on the rank")
        del cache
        structs = cache_structs(dataclasses.replace(cfg, seq_axes=("model",)),
                                ShapeSpec("decode", "decode", ring, UNEVEN_B),
                                mesh)
        cache_d = layers.tree_map(lambda a, st: distribute_tensor(
            a, mesh, st.placements, src_data_rank=None),
            pad_cache(cfg, local, ring), structs)
        del local
        ck = next(t for _, t in layers.tree_items(cache_d) if t.ndim >= 4)
        lo, n_loc = layers.local_offset(ck)[-3], ck.to_local().shape[-3]
        wins = [cfg.window if m == "attn_local" else 0
                for m, _ in cfg.period_pattern]
        res["expect_partials"] = sum(
            dec_ops.block_visible_range(ring, UNEVEN_T + i, w, lo, n_loc)[1] > 0
            for i in range(MESH_DECODE_NEW)
            for w in (wins * cfg.n_layers)[:cfg.n_layers])
        dcalls, dec_got = [], []
        zero_counts(tables)
        layers.REGION_TRACE = []

        def launched(a, kw):     # a block with a visible key launches
            return dec_ops.block_visible_range(
                kw["block"][1], a[3], kw.get("window", 0), kw["block"][0],
                a[1].shape[1])[1] > 0
        try:
            with recorded(dec_ops, "decode_attention_partials", dcalls,
                          keep=1, key=launched):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for i, nxt in enumerate(feed):
                    lg, cache_d = model_mod.decode_step(
                        cfg, sharded, distribute_tensor(
                            nxt.to(dev), mesh, rep, src_data_rank=None),
                        cache_d, UNEVEN_T + i)
                    dec_got.append(layers.all_gather(lg.to_local(), 1,
                                                     group).cpu())
                torch.cuda.synchronize()
                res["decode_seconds"] = time.perf_counter() - t0
            res["decode_regions"] = sorted({(n, tuple(sorted(i.items())))
                                            for n, i in layers.REGION_TRACE})
        finally:
            layers.REGION_TRACE = None
        res["decode_launches"] = read_counts(tables)
        res["decode_logits"] = dec_got
        args, kw, (o, lse) = next(c for c in dcalls if launched(*c[:2]))
        q, k, v, pos, scale = args[:5]
        blo, bring = kw["block"]
        s0, nvis = dec_ops.block_visible_range(bring, pos,
                                               kw.get("window", 0), blo,
                                               k.shape[1])
        want_o, want_lse = dec_ref.decode_attention_partials_ref(
            q, k, v, s0, nvis, scale)
        res["b10_replay"] = {
            "block": [blo, k.shape[1], bring], "pos": pos, "visible": nvis,
            "err": float((o - want_o).abs().max()), "tol": attn_tol(want_o),
            "lse_err": float((lse - want_lse).abs().max()),
            "lse_tol": 1e-5 * max(1.0, float(want_lse.abs().max()))}
        if rank == 0:
            res["b10_call"] = (tuple(a.cpu() if hasattr(a, "cpu") else a
                                     for a in args), kw,
                               (o.cpu(), lse.cpu()))
        del sharded, cache_d, dcalls
        torch.cuda.empty_cache()
        out[str(dtype)[6:]] = res
    out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    return out


def mesh_uneven(torch, dev, tables):
    """Attention by head group (A4) on the one card: 16 ranks
    (``mesh_uneven_ranks``) of gemma3-4b over a (1, 16) mesh, in f32 and
    bf16.  Each rank's prefill launches B9 once a layer at its group's one
    head on its one row (``attention`` heads 1, kv heads 1, rows 1; no
    ``run_on_rows``), the embedding vocab-parallel; the gathered logits
    equal on every rank and held against rank 0's unsharded prefill: in
    f32 within ``attn_tol``, in bf16 within LM_LOGIT_TOL of the largest
    logit; the greedy tokens compared.  The decode on the prefill's cache
    split over the sequence launches B10's partials once a layer a step
    where the rank's block of the ring holds a visible key (the 1024
    window leaves the early blocks none in the local layers), through the
    ``decode_attention`` region only; its logits held against the
    unsharded decode within the prefill's bounds.  Each rank's first B9
    and partials launch is held against its plain version (in the rank:
    ``attn_tol``, a bf16 B9 also value by value); rank 0's are replayed
    here again for the kernel table.  Returns (the ranks' launch counts,
    the replays' errors, their timing cases)."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.launch.local import run_local
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_arch(UNEVEN_ARCH).config,
                              n_layers=UNEVEN_LAYERS)
    m = UNEVEN_MESH[1]
    MESH_DIR.mkdir(parents=True, exist_ok=True)
    ranks = run_local(mesh_uneven_ranks, m, SEED, backend=MESH_TWO_BACKEND,
                      threads=1, timeout=900, work_dir=str(MESH_DIR))
    shutil.rmtree(MESH_DIR, ignore_errors=True)
    paths, errs, cases, report = {}, {}, [], {}
    ring = UNEVEN_T + MESH_DECODE_NEW
    blk = -(-ring // m)
    regions = [("attention", (("heads", 1), ("kv_heads", 1),
                              ("rows", UNEVEN_B // 2))),
               ("dense", (("ff", cfg.d_ff // m),)),
               ("embed", (("vocab_rows", cfg.vocab // m),)), ("norm", ())]
    for dt in ("float32", "bfloat16"):
        want = ranks[0][dt]["want"]
        for r in ranks:
            got, i = r[dt], r["rank"]
            label = f"mesh uneven {UNEVEN_MESH} {dt} rank {i}"
            require_launches(label, got["launches"],
                             {"flash_attention": cfg.n_layers})
            paths[f"uneven_prefill[{dt} rank {i}]"] = got["launches"]
            if got["regions"] != regions:
                raise Mismatch(f"{label}: regions {got['regions']}, "
                               f"expected {regions}")
            name = f"{label}: logits vs the unsharded prefill"
            if dt == "float32":
                check(name, float((got["logits"] - want).abs().max()),
                      attn_tol(want))
            else:
                _tol_share(name, got["logits"].float(), want.float(),
                           LM_LOGIT_TOL)
            rep = got["b9_replay"]
            check(f"flash_attention[{label} first launch: {rep['shape']} "
                  f"{rep['kind']}]", rep["err"], rep["tol"])
            if rep["over_bound"] is not None and not rep["over_bound"] <= 1:
                raise Mismatch(f"{label}: B9's first launch "
                               f"{rep['over_bound']} times its bound")
            path = f"uneven_decode[{dt} rank {i}]"
            if got["expect_partials"] < 1:
                raise Mismatch(f"{label}: no visible key in the rank's block")
            require_launches(f"{label} decode", got["decode_launches"],
                             {"decode_attention_partials":
                              got["expect_partials"]})
            paths[path] = got["decode_launches"]
            seq = blk if i < m - 1 else ring - blk * (m - 1)
            want_dec = sorted([("decode_attention", (
                ("heads", cfg.n_heads), ("seq_block", seq)))] + regions[1:])
            if got["decode_regions"] != want_dec:
                raise Mismatch(f"{label} decode: regions "
                               f"{got['decode_regions']}, expected {want_dec}")
            for j, (lg, w) in enumerate(zip(got["decode_logits"],
                                            ranks[0][dt]["want_dec"])):
                name = f"{label} decode step {j}: logits vs the unsharded"
                if dt == "float32":
                    check(name, float((lg - w).abs().max()), attn_tol(w))
                else:
                    _tol_share(name, lg.float(), w.float(), LM_LOGIT_TOL)
            rep = got["b10_replay"]
            name = (f"decode_attention_partials[{label} first launch: "
                    f"block {rep['block']}, pos {rep['pos']}, visible "
                    f"{rep['visible']}]")
            check(name, rep["err"], rep["tol"])
            check(name + "[lse]", rep["lse_err"], rep["lse_tol"])
            if not torch.equal(got["logits"], ranks[0][dt]["logits"]):
                raise Mismatch(f"{label}: logits differ from rank 0's")
        r0 = ranks[0][dt]
        args, kw, o = r0["b9_call"]
        err, case = attn_replay(torch, f"mesh uneven {UNEVEN_MESH} rank 0",
                                "first launch", "flash_attention",
                                (tuple(a.to(dev) for a in args), kw,
                                 o.to(dev)))
        errs[case[0]] = err
        cases.append(case + (f"uneven_prefill[{dt} rank 0]",))
        args, kw, out = r0["b10_call"]
        err, case = attn_replay(
            torch, f"mesh uneven {UNEVEN_MESH} rank 0", "first launch",
            "decode_attention_partials",
            (tuple(a.to(dev) if hasattr(a, "to") else a for a in args), kw,
             tuple(x.to(dev) for x in out)))
        errs[case[0]] = err
        cases.append(case + (f"uneven_decode[{dt} rank 0]",))
        report[dt] = {
            "prefill_s": [r[dt]["seconds"] for r in ranks],
            "unsharded_prefill_s": r0["unsharded_prefill_s"],
            "logits_max_abs_diff": max(float((r[dt]["logits"].float()
                                              - want.float()).abs().max())
                                       for r in ranks),
            "max_abs_logit": float(want.float().abs().max()),
            "greedy_equal": int((r0["logits"].argmax(-1)
                                 == want.argmax(-1)).sum()),
            "greedy_of": UNEVEN_B,
            "b9_replay_max_err": max(r[dt]["b9_replay"]["err"]
                                     for r in ranks),
            "decode": {
                "steps": MESH_DECODE_NEW, "ring": ring,
                "seconds": [r[dt]["decode_seconds"] for r in ranks],
                "partials_launches": [r[dt]["expect_partials"]
                                      for r in ranks],
                "logits_max_abs_diff": max(
                    float((g.float() - w.float()).abs().max())
                    for r in ranks for g, w in zip(
                        r[dt]["decode_logits"], r0["want_dec"])),
                "greedy_equal": sum(int((g.argmax(-1) == w.argmax(-1)).sum())
                                    for g, w in zip(r0["decode_logits"],
                                                    r0["want_dec"])),
                "greedy_of": MESH_DECODE_NEW * UNEVEN_B,
                "b10_replay_max_err": max(r[dt]["b10_replay"]["err"]
                                          for r in ranks)}}
    emit({"phase": "mesh_uneven", "arch": cfg.name,
          "layers": UNEVEN_LAYERS, "mesh": list(UNEVEN_MESH),
          "backend": MESH_TWO_BACKEND, "tokens": [UNEVEN_B, UNEVEN_T],
          "devices": sorted({r["device"] for r in ranks}),
          "regions": [n for n, _ in regions], **report,
          "peak_gb": [r["peak_gb"] for r in ranks],
          "seconds": time.perf_counter() - t0})
    return paths, errs, cases


def examples_phase(torch, dev, tables, card: str):
    """EXAMPLES at their defaults on the card, in this process (each
    module's ``main``), their launches counted alone and what they report
    (their last line) held as ``tests/test_torch_examples.py`` holds it on
    the CPU.  Each example's first launch of every kernel it runs (B1 and
    B1-sym apart) is recorded, replayed against its plain version
    (``replay_kernels``; B3 within ``predict_bound``) and timed at that
    shape: the ``example_kernel_times`` rows.  A launched kernel with no
    replay fails.  Returns each example's launch counts."""
    import importlib.util
    import io
    from repro_torch import obs
    from repro_torch.kernels.kernel_matrix import ops as km_ops
    from repro_torch.kernels.kernel_matrix import ref as km_ref
    from repro_torch.kernels.svm_predict import ops as sp_ops
    from repro_torch.kernels.svm_predict import ref as sp_ref
    paths, rows = {}, []
    t0 = time.perf_counter()
    tracing = obs.tracer.enabled
    for name in EXAMPLES:
        spec = importlib.util.spec_from_file_location(
            name, ROOT / "examples" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        buf = io.StringIO()
        b3 = []
        zero_counts(tables)
        t1 = time.perf_counter()
        try:
            with recorded_kernels(dev, keep=1, by_body=True) as rec, \
                    recorded(sp_ops, "svm_predict_cells", b3, keep=1,
                             device=dev), \
                    contextlib.redirect_stdout(buf):
                mod.main([])
            torch.cuda.synchronize()
        finally:
            obs.configure(trace=tracing)   # torch_serve_svm turns it on
        secs = time.perf_counter() - t1
        counts = read_counts(tables)
        res = _last_json(buf.getvalue())
        ok = res["device"].startswith("cuda")
        if name == "torch_quickstart":
            lo, mid, hi = res["qt_coverage"]
            ok &= (res["mc_error"] < 0.4 and lo < mid < hi
                   and res["npl_test_fa_at_0.01"] <= 0.1)
            need = ("sq_dists_sym", "gram_from_d2", "sq_dists")
        else:
            n = res["submitted"]
            ok &= (res["served"] == res["async_served"]
                   == res["swap_served"] == n and res["accuracy"] > 0.8
                   and bool(res["drifted"]))
            need = ("sq_dists_sym", "gram_from_d2", "svm_predict_cells")
        if not ok or not all(counts[k] > 0 for k in need):
            raise Mismatch(f"example {name}: {res}, launches {counts}")
        paths[f"example[{name}]"] = counts
        replayable = ("sq_dists", "sq_dists_sym", "gram_from_d2",
                      "cd_wave_epoch", "svm_predict_cells")
        other = [k for k, v in counts.items() if v and k not in replayable]
        if other:
            raise Mismatch(f"example {name}: launched {other}, which this "
                           f"phase does not replay")
        label = f"example {name}"
        rep = replay_kernels(torch, label, rec, {
            k: 1 for k in replayable[:4] if counts[k]})
        errs, replayed = dict(rep["max_abs_err"]), dict(rep["replayed"])
        if counts["svm_predict_cells"]:
            if not b3:
                raise Mismatch(f"{label}: svm_predict_cells launched but "
                               f"none recorded on {dev}")
            (xt, sv, co, ga), kw, out = b3[0]
            kind = kw.get("kind", "gauss_rbf")
            dd2 = 64 * float(np.finfo(np.float32).eps) * float(
                (xt * xt).sum(-1).max() + (sv * sv).sum(-1).max())
            errs["svm_predict_cells"] = check_bound(
                f"{label}: svm_predict_cells", out.cpu(),
                sp_ref.svm_predict_cells_ref(xt, sv, co, ga,
                                             kind=kind).cpu(),
                predict_bound(torch, km_ref.sq_dists_ref, xt, sv, co, ga,
                              kind, dd2).cpu(), shape=list(out.shape))
            replayed["svm_predict_cells"] = 1
        calls = {("sq_dists_sym" if _sym(a, k) else "sq_dists"): (a, k)
                 for a, k, _ in rec["sq_dists"]}
        calls.update({"gram_from_d2": (a, k)
                      for a, k, _ in rec["gram_from_d2"]})
        calls.update({"svm_predict_cells": (a, k) for a, k, _ in b3})
        for kern, (args, kw) in sorted(calls.items()):
            fn, plain, lib, shape, b = _example_case(
                torch, km_ops, km_ref, sp_ops, sp_ref, kern, args, kw)
            rows.append({
                "name": f"{kern}[{name}: {shape}]", "route": "cuda",
                "source": KERNELS[kern][0], "replaces": KERNELS[kern][1],
                "launches": counts[kern], "max_abs_err": errs[kern],
                "ms": cuda_ms(torch, fn), "plain_ms": cuda_ms(torch, plain),
                "bound_ms": b[0], "bound_by": b[1],
                "library_ms": None if lib is None else cuda_ms(torch, lib)})
        emit({"phase": "example", "name": name, "seconds": secs,
              "launches": counts, "replayed": replayed,
              "report": res})
    emit({"phase": "example_kernel_times", "rows": rows, "card": card})
    emit({"phase": "examples", "seconds": time.perf_counter() - t0})
    return paths


def _example_case(torch, km_ops, km_ref, sp_ops, sp_ref, kern: str,
                  args, kw):
    """A recorded launch of B1, B1-sym, B2 or B3 as a timing case: (the
    kernel, its plain version, the library call or None, the shape, the
    bound: each operand read once and the result written once, the
    operations as the kernel table's rows count them)."""
    f32 = 4
    if kern in ("sq_dists", "sq_dists_sym"):
        x, z = args[0], args[1]
        sym = kern == "sq_dists_sym"
        s = int(np.prod(x.shape[:-2]))
        n, m, d = x.shape[-2], z.shape[-2], x.shape[-1]
        ops = (s * (n * (n + 1) // 2 * (2 * d + 3) + n * 2 * d) if sym
               else s * n * m * (2 * d + 3) + s * (n + m) * 2 * d)
        nbytes = f32 * (s * n * d + (0 if sym else s * m * d) + s * n * m)
        return (lambda: km_ops.sq_dists(x, z, symmetric=sym),
                lambda: km_ref.sq_dists_ref(x, z, symmetric=sym), None,
                f"{s}x{n}x{m}, d {d}", bound(nbytes, ops))
    if kern == "gram_from_d2":
        d2, gamma = args[:2]
        kind = kw.get("kind", args[2] if len(args) > 2 else "gauss_rbf")
        dout = kw.get("out_dtype", args[3] if len(args) > 3 else "f32")
        if d2.dim() == 3:
            g4 = gamma[:, :, None, None]
            n_out = d2.numel() * gamma.shape[1]
            plain = (lambda: km_ref.gram_from_d2_ref(d2[:, None], g4, kind,
                                                     dout))
            neg = (-(d2[:, None].float() / torch.clamp(g4 * g4, min=1e-12))
                   ).contiguous()
            g_bytes, shape = f32 * gamma.numel(), (
                f"{d2.shape[0]}x{gamma.shape[1]}x{d2.shape[1]}x"
                f"{d2.shape[2]}")
        else:
            g = float(gamma)
            n_out = d2.numel()
            plain = lambda: km_ref.gram_from_d2_ref(d2, gamma, kind, dout)
            neg = (-(d2.float() / max(g * g, 1e-12))).contiguous()
            g_bytes, shape = 0, "x".join(str(v) for v in d2.shape)
        lib = (lambda: torch.exp(neg)) if kind == "gauss_rbf" else None
        nbytes = (d2.numel() * d2.element_size() + g_bytes
                  + n_out * (2 if dout == "bf16" else f32))
        return (lambda: km_ops.gram_from_d2(d2, gamma, kind=kind,
                                            out_dtype=dout),
                plain, lib, f"{shape}, {kind}, {dout}",
                bound(nbytes, 4 * n_out))
    xt, sv, co, ga = args
    kind = kw.get("kind", "gauss_rbf")
    c, m, d = xt.shape
    k, p = sv.shape[1], co.shape[2]
    return (lambda: sp_ops.svm_predict_cells(xt, sv, co, ga, kind=kind),
            lambda: sp_ref.svm_predict_cells_ref(xt, sv, co, ga, kind=kind),
            None, f"{c}x{m}x{k}x{d}, P {p}",
            bound(f32 * (c * m * d + c * k * d + c * k * p + c * p
                         + c * m * p),
                  c * m * k * (2 * d + 3) + c * (m + k) * 2 * d
                  + 4 * c * m * k * p))


# the launch tooling (A5): the serve launcher at its defaults (the smoke
# config on the card: 4 prompts of 16 tokens, 16 new; gemma3-4b for its
# window attention), the train launcher at stablelm-1.6b's full width, and
# the dry run of stablelm-1.6b's train_4k cell on the (16, 16) production
# mesh (a fake process group on the CPU, started beside the build); each
# launcher in a process of its own, files under LAUNCH_DIR (removed at the
# start and the end)
LAUNCH_SERVE = ("stablelm-1.6b", "gemma3-4b")
LAUNCH_SERVE_NEW = 16
LAUNCH_TRAIN = ("--arch", "stablelm-1.6b", "--full", "--steps", "3")
LAUNCH_DRYRUN = ("--arch", "stablelm-1.6b", "--shape", "train_4k",
                 "--mesh", "single")
LAUNCH_DIR = ROOT / "build" / "chip_smoke_launch"


def _src_env(**extra) -> dict:
    path = [str(ROOT / "src")] + ([os.environ["PYTHONPATH"]]
                                  if os.environ.get("PYTHONPATH") else [])
    return dict(os.environ, PYTHONPATH=os.pathsep.join(path), **extra)


def start_dryrun():
    """``python -m repro_torch.launch.dryrun`` on LAUNCH_DRYRUN in a niced
    CPU process of its own (no card visible to it), beside the build.
    Returns (process, its JSON-lines file, its log, start time); the
    process is killed at exit if it still runs."""
    shutil.rmtree(LAUNCH_DIR, ignore_errors=True)
    LAUNCH_DIR.mkdir(parents=True)
    out, log = LAUNCH_DIR / "dryrun.jsonl", LAUNCH_DIR / "dryrun.log"
    with open(log, "w") as f:
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun",
             *LAUNCH_DRYRUN, "--out", str(out)], cwd=ROOT, stdout=f,
            stderr=subprocess.STDOUT, preexec_fn=lambda: os.nice(10),
            env=_src_env(CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1"))
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return proc, out, log, time.perf_counter()


def launch_serve_child(arch: str, out_path: str) -> None:
    """Run in a process of its own: ``repro_torch.launch.serve --arch
    <arch>`` at its defaults (the card), B9 and B10 counted from 0 and
    their first launches recorded.  Saves the launcher's exit code and
    output, the counts and the recorded calls to ``out_path``."""
    import io
    import torch
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch import serve
    tables = (fa_ops.launches, dec_ops.launches)
    calls = {"flash_attention": [], "decode_attention": []}
    buf = io.StringIO()
    zero_counts(tables)
    with recorded(fa_ops, "flash_attention", calls["flash_attention"],
                  keep=1), \
            recorded(dec_ops, "decode_attention_fused",
                     calls["decode_attention"], keep=1), \
            contextlib.redirect_stdout(buf):
        rc = serve.main(["--arch", arch, "--new", str(LAUNCH_SERVE_NEW)])
    torch.save({"rc": rc, "stdout": buf.getvalue(),
                "counts": read_counts(tables), "calls": calls}, out_path)


def _last_json(text: str) -> dict:
    return json.loads(text.strip().splitlines()[-1])


def launch_phase(torch, dev, dry):
    """The launchers as a user runs them.  Returns (each serve run's
    launch counts, the replayed launches' errors, their timing cases).

    1. ``launch.serve`` for each of LAUNCH_SERVE in a process of its own:
       exit code 0, ``out_shape`` (4, 32), B9 once an attention layer
       (the prefill) and B10 once a layer a decode step, nothing else;
       its first B9 and B10 launches replayed here against their plain
       versions (``attn_replay``);
    2. ``launch.train`` at stablelm-1.6b's full width for 3 steps on the
       card: finite losses, ``wall_s``;
    3. the dry run started by ``start_dryrun``: exit code 0 and its
       result, with the reference's keys less the compiled program's."""
    from repro_torch.configs import get_arch
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    paths, errs, cases = {}, {}, []
    for arch in LAUNCH_SERVE:
        out = LAUNCH_DIR / f"serve_{arch}.pt"
        t1 = time.perf_counter()
        subprocess.run(
            [sys.executable, "-c",
             f"import sys; sys.path.insert(0, {str(ROOT)!r}); "
             f"import chip_smoke; chip_smoke.launch_serve_child({arch!r}, "
             f"{str(out)!r})"], cwd=ROOT, env=_src_env(), check=True,
            timeout=600)
        wall = time.perf_counter() - t1
        got = torch.load(out, map_location=dev)
        res = _last_json(got["stdout"])
        if got["rc"] != 0 or res["out_shape"] != [4, 16 + LAUNCH_SERVE_NEW]:
            raise Mismatch(f"launch.serve {arch}: exit {got['rc']}, "
                           f"out_shape {res.get('out_shape')}")
        cfg = get_arch(arch).smoke
        n_attn = sum(cfg.period_pattern[i % cfg.period][0].startswith("attn")
                     for i in range(cfg.n_layers))
        label = f"launch.serve[{arch}]"
        require_launches(label, got["counts"], {
            "flash_attention": n_attn,
            "decode_attention": n_attn * (LAUNCH_SERVE_NEW - 1)})
        paths[label] = got["counts"]
        for name in ("flash_attention", "decode_attention"):
            err, case = attn_replay(torch, f"launch.serve {arch}",
                                    "first launch", name,
                                    got["calls"][name][0])
            errs[case[0]] = err
            cases.append(case)
        emit({"phase": "launch_serve", "arch": arch, **res,
              "launches": got["counts"], "process_s": wall})
    t1 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *LAUNCH_TRAIN],
        cwd=ROOT, env=_src_env(), capture_output=True, text=True,
        timeout=900)
    if run.returncode != 0:
        raise Mismatch(f"launch.train: exit {run.returncode}: "
                       f"{run.stderr[-3000:]}")
    res = _last_json(run.stdout)
    if not (np.isfinite(res["loss_first"]) and np.isfinite(res["loss_last"])
            and res["steps"] == 3):
        raise Mismatch(f"launch.train: {res}")
    emit({"phase": "launch_train", **res,
          "process_s": time.perf_counter() - t1})
    proc, out, log, t_start = dry
    rc = proc.wait(timeout=900)
    if rc != 0 or not out.exists():
        tail = log.read_text()[-3000:] if log.exists() else ""
        raise Mismatch(f"launch.dryrun: exit {rc}: {tail}")
    r = _last_json(out.read_text())
    keys = {"arch", "shape", "mesh", "kind", "variant", "n_devices", "flops",
            "bytes_accessed", "collective_bytes", "collective_counts",
            "memory", "trace_s"}
    if set(r) != keys or r["n_devices"] != 256 or not r["flops"] > 0:
        raise Mismatch(f"launch.dryrun: {r}")
    emit({"phase": "launch_dryrun", **r,
          "process_s_from_start": time.perf_counter() - t_start})
    shutil.rmtree(LAUNCH_DIR, ignore_errors=True)
    emit({"phase": "launch", "seconds": time.perf_counter() - t0})
    return paths, errs, cases


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
    Returns the fit's and the serving run's launch counts, B3's operands
    at the run's most frequent wave shape (the LM head's wave) and the
    fit's first B1-sym operand (the LM head's fit wave)."""
    from repro_torch.api.session import SVM
    from repro_torch.kernels.kernel_matrix import ops as km_ops
    from repro_torch.serve import EmbedServe, SVMEngine
    from repro_torch.train.svm_trainer import SVMTrainerConfig
    _, _, x_ho, y_ho = corpus
    cfg = SVMTrainerConfig(**LM_SVM_CFG)
    zero_counts(tables)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with recorded(km_ops, "sq_dists", [], snap=False) as calls:
        sess = SVM(src_tr, None, cfg, device=dev)
        sel = sess.train().select()
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fit_d2 = next(a[0] for a, kw, _ in calls if kw.get("symmetric"))
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
    return fit_counts, srv_counts, head_wave, fit_d2


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
    state = {"cache": cache, "pos": GEN_PROMPT}

    def run(n):
        for _ in range(n):
            _, state["cache"] = engine.serve_step(cfg, params, tok,
                                                  state["cache"],
                                                  state["pos"])
            state["pos"] += 1

    run(2)
    prof = _profile(torch, lambda: run(steps), per=steps, host_top=10)
    t0 = time.perf_counter()
    run(steps)
    torch.cuda.synchronize()
    emit({"phase": "lm_decode_profile", "steps": steps, "per_step": prof,
          "unprofiled_wall_ms_per_step":
              (time.perf_counter() - t0) * 1e3 / steps})


def lm_smoke_tokens(torch, dev, tables):
    """At the smoke configs in f32: greedy tokens through B9/B10 equal the
    plain path's, with a bf16 (here: f32) and an int8 cache (stablelm-12b's
    and command-r's smoke configs too: head_dim 16 and 8)."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.models import model as model_mod
    from repro_torch.serve import engine
    out = {}
    for arch in ("stablelm-1.6b", "gemma3-4b", "stablelm-12b",
                 "command-r-plus-104b"):
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


def attn_bound(torch, b, t, s, h, hk, d, kind, window, esize,
               peak: float = BF16_FLOP_PER_S):
    """B9's least time: q, k, v read and o written once, or 4 D operations
    per visible (row, column) pair and head at ``peak`` (the bf16
    tensor-core peak unless the kernel runs on CUDA cores)."""
    from repro_torch.kernels.flash_attention.ref import attention_mask
    pairs = int(attention_mask(t, s, kind, window).sum())
    return bound(esize * (2 * b * t * h * d + 2 * b * s * hk * d),
                 4 * d * pairs * b * h, peak)


def lm_timing_cases(torch, dev, cfg):
    """B9 and B10 at the LM path's shapes and at long contexts (B10 at B =
    16 and B = 1, bf16 and int8), and B9's f32 kernel at jamba's prefill
    shape (JAMBA_F32_B9):
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
    # the CUDA-core (f32) kernel at jamba's prefill shape: on no f32 path
    b, t, h32, hk32, d32 = JAMBA_F32_B9
    q = torch.randn(b, t, h32, d32, generator=gen, device=dev)
    k, v = (torch.randn(b, t, hk32, d32, generator=gen, device=dev)
            for _ in range(2))
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    cases.append((
        "flash_attention[jamba f32: B=%d,T=S=%d,H=%d,Hk=%d,D=%d]"
        % JAMBA_F32_B9,
        lambda q=q, k=k, v=v: fa_ops.flash_attention(q, k, v, "causal"),
        lambda q=q, k=k, v=v: fa_ref.flash_attention_ref(q, k, v, "causal"),
        lambda q=qt, k=kt, v=vt: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True),
        attn_bound(torch, b, t, t, h32, hk32, d32, "causal", 0, 4,
                   FP32_FLOP_PER_S)))
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
    from repro_torch.api import nplSVM
    from repro_torch.api import session as session_mod
    from repro_torch.serve.refresh import refresh_drifted
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
    # the CPU sides of the two small CPU-vs-card fits need no kernel: one
    # process of their own runs them beside the build (~45 s on the host),
    # niced so that nvcc keeps the cores it needs
    cpu_pool = concurrent.futures.ProcessPoolExecutor(
        1, mp_context=multiprocessing.get_context("spawn"),
        initializer=os.nice, initargs=(10,))
    cpu_small = cpu_pool.submit(small_fit_run, "cpu")
    cpu_staged = cpu_pool.submit(staged_small_run, "cpu")
    dry = start_dryrun()
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
    small_fit_parity(torch, dev, cpu_small.result(), make_fold_masks,
                     argmin_winners)
    model, fit_counts, test_counts, dec_df, err_df, test_d2 = full_fit(
        torch, dev, (x_tr, y_tr, x_te, y_te), LiquidSVM, SVMTrainerConfig,
        tables, cell_trainer, obs)
    bank_counts = serve_trained(torch, dev, model, x_te, y_te, dec_df,
                                err_df, SVMEngine, tables, refs)
    b5_counts = b5_entry(torch, dev, model, tables)
    fista_profile(torch, prob)
    del model
    staged_small(dev, cpu_staged.result())
    cpu_pool.shutdown()
    staged_paths = staged(torch, dev, nplSVM, covtype_like,
                          covtype_like_heldout, tables, refs, session_mod,
                          ModelBank, refresh_drifted)
    resume_paths = wave_resume(torch, dev, nplSVM, covtype_like,
                               covtype_like_heldout, tables)
    train_paths = {"fit": fit_counts, "test": test_counts,
                   "trained_bank": bank_counts, "cd_epochs": b5_counts,
                   **{f"staged_{k}": v for k, v in staged_paths.items()},
                   **{f"resume[{k}]": v for k, v in resume_paths.items()}}
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
    fit_counts_lm, serve_counts_lm, head_wave, lm_fit_d2 = lm_svm_head(
        torch, dev, ex, src_tr, src_ho, corpus, tables, refs)
    prompt = torch.as_tensor(corpus[2][:GEN_BATCH, :GEN_PROMPT]).to(dev)
    gen_counts = lm_generate(torch, dev, lm_cfg, ex.params, prompt, tables)
    lm_decode_profile(torch, dev, lm_cfg, ex.params, prompt)
    lm_smoke_tokens(torch, dev, tables)
    gemma_counts = lm_gemma_long(torch, dev, tables)
    lm_families_kernels(torch, dev)
    fam_paths, fam_errs, fam_cases = lm_families(torch, dev, tables)
    rwkv_paths = lm_rwkv6(torch, dev, tables)
    moe_paths, moe_errs, moe_cases = lm_moe_ssm(torch, dev, tables)
    train_lm_paths = lm_train(torch, dev, tables)
    lm_paths = {"embed": embed_counts, "svm_fit": fit_counts_lm,
                "embed_serve": serve_counts_lm, "generate": gen_counts,
                "gemma_long": gemma_counts,
                **{f"families[{k}]": v for k, v in fam_paths.items()},
                **{f"rwkv6[{k}]": v for k, v in rwkv_paths.items()},
                **{f"moe_ssm[{k}]": v for k, v in moe_paths.items()},
                **{f"lm_train[{k}]": v for k, v in train_lm_paths.items()}}
    emit({"phase": "lm_launches", "per_path": lm_paths})
    launches = {name: launches.get(name, 0)
                + sum(n[name] for n in lm_paths.values())
                for name in embed_counts}
    del ex, src_tr, src_ho
    torch.cuda.empty_cache()

    # ------------------------------------------ 6b. several devices (A4)
    mesh_paths = mesh_phase(torch, dev, tables, smi.splitlines()[0])
    emit({"phase": "mesh_launches", "per_path": mesh_paths})
    launches = {name: n + sum(c.get(name, 0) for c in mesh_paths.values())
                for name, n in launches.items()}

    prefill_paths, prefill_errs, prefill_cases = mesh_prefill(torch, dev,
                                                              tables)
    # the kernels line's row of B10's partials mode: rank 0's first bf16
    # launch of the split decode, one rank's half of the ring
    partials_case = next(c for c in prefill_cases
                         if c[2] == "decode_attention_partials"
                         and c[-1] == "decode_two_ranks[bfloat16 rank 0]")
    errs["decode_attention_partials"] = prefill_errs[partials_case[0]]
    emit({"phase": "mesh_prefill_launches", "per_path": prefill_paths})
    launches = {name: n + sum(c.get(name, 0) for c in prefill_paths.values())
                for name, n in launches.items()}
    uneven_paths, uneven_errs, uneven_cases = mesh_uneven(torch, dev, tables)
    emit({"phase": "mesh_uneven_launches", "per_path": uneven_paths})
    launches = {name: n + sum(c.get(name, 0) for c in uneven_paths.values())
                for name, n in launches.items()}
    prefill_paths.update(uneven_paths)
    prefill_errs.update(uneven_errs)
    prefill_cases += uneven_cases

    # ------------------------------------------ 6c. the launch tooling (A5)
    launch_paths, launch_errs, launch_cases = launch_phase(torch, dev, dry)
    emit({"phase": "launch_launches", "per_path": launch_paths})
    launches = {name: n + sum(c.get(name, 0) for c in launch_paths.values())
                for name, n in launches.items()}

    # ------------------------------------------------- 6d. the examples
    example_paths = examples_phase(torch, dev, tables, smi.splitlines()[0])
    emit({"phase": "example_launches", "per_path": example_paths})
    launches = {name: n + sum(c.get(name, 0) for c in example_paths.values())
                for name, n in launches.items()}

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
    timing["decode_attention_partials"] = partials_case[3:7]
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
    # B1-sym at the LM head's fit wave: the fit's own launch
    s_l, n_l, d_l = lm_fit_d2.shape
    label = f"sq_dists_sym[LM head fit: {s_l}x{n_l}^2, d {d_l}]"
    got = km_ops.sq_dists(lm_fit_d2, lm_fit_d2, symmetric=True)
    want = km_ref.sq_dists_ref(lm_fit_d2, lm_fit_d2, symmetric=True)
    torch.cuda.synchronize()
    sym = bool(torch.equal(got, got.transpose(1, 2)))
    e_l = check(label, float((got - want).abs().max()),
                64 * eps * float(2 * (lm_fit_d2 * lm_fit_d2).sum(-1).max()),
                bitwise_symmetric=sym)
    if not sym:
        raise Mismatch(f"{label}: result differs from its transpose")
    del got, want
    b_l = bound(f32 * (s_l * n_l * d_l + s_l * n_l * n_l),
                s_l * (n_l * (n_l + 1) // 2 * (2 * d_l + 3) + n_l * 2 * d_l))
    lm_rows.append({
        "name": label, "launches": fit_counts_lm["sq_dists_sym"],
        "max_abs_err": e_l,
        "ms": cuda_ms(torch, lambda: km_ops.sq_dists(
            lm_fit_d2, lm_fit_d2, symmetric=True)),
        "plain_ms": cuda_ms(torch, lambda: km_ref.sq_dists_ref(
            lm_fit_d2, lm_fit_d2, symmetric=True)),
        "bound_ms": b_l[0], "bound_by": b_l[1], "library_ms": None})
    del lm_fit_d2
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
    # B1 at the fit's test phase: decision_function's own launch
    xq, zq = test_d2
    s_q, m_q, d_q = xq.shape
    k_q = zq.shape[1]
    label = f"sq_dists[test phase: {s_q}x{m_q}x{k_q}, d {d_q}]"
    got = km_ops.sq_dists(xq, zq)
    want = km_ref.sq_dists_ref(xq, zq)
    torch.cuda.synchronize()
    e_q = check(label, float((got - want).abs().max()),
                64 * eps * float((xq * xq).sum(-1).max()
                                 + (zq * zq).sum(-1).max()))
    del got, want
    b_q = bound(f32 * (s_q * m_q * d_q + s_q * k_q * d_q + s_q * m_q * k_q),
                s_q * m_q * k_q * (2 * d_q + 3) + s_q * (m_q + k_q) * 2 * d_q)
    train_rows = [{
        "name": label, "launches": test_counts["sq_dists"],
        "max_abs_err": e_q, "ms": cuda_ms(torch, lambda: km_ops.sq_dists(
            xq, zq)),
        "plain_ms": cuda_ms(torch, lambda: km_ref.sq_dists_ref(xq, zq)),
        "bound_ms": b_q[0], "bound_by": b_q[1], "library_ms": None}, {
        "name": "gram_from_d2[train: %d x %d^2, G 1]" % (s_t, n_t),
        "ms": cuda_ms(torch, lambda: km_ops.gram_from_d2(d2_t, gam_t)),
        "plain_ms": cuda_ms(torch, lambda: km_ref.gram_from_d2_ref(
            d2_t[:, None], gam_t[:, :, None, None])),
        "bound_ms": b2_train[0], "bound_by": b2_train[1],
        "library_ms": cuda_ms(torch, lambda: torch.exp(neg_t))}]
    del neg_t
    # B9 and B10 at the families' own launches (``lm_families`` recorded
    # and replayed them): launches over that family's runs, the error of
    # the replay at the row's shape
    fam_rows = []
    for label, family, name, kern, plain, lib, (b_ms, b_by) in fam_cases:
        fam_rows.append({
            "name": label, "route": "cuda", "source": KERNELS[name][0],
            "replaces": KERNELS[name][1],
            "launches": sum(n[name] for k, n in fam_paths.items()
                            if k.startswith(family)),
            "max_abs_err": fam_errs[label],
            "ms": cuda_ms(torch, kern), "plain_ms": cuda_ms(torch, plain),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None if lib is None else cuda_ms(torch, lib)})
    del fam_cases
    moe_rows = []
    for label, family, name, kern, plain, lib, (b_ms, b_by) in moe_cases:
        moe_rows.append({
            "name": label, "route": "cuda", "source": KERNELS[name][0],
            "replaces": KERNELS[name][1],
            "launches": sum(n[name] for k, n in moe_paths.items()
                            if k.startswith(family)),
            "max_abs_err": moe_errs[label],
            "ms": cuda_ms(torch, kern), "plain_ms": cuda_ms(torch, plain),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None if lib is None else cuda_ms(torch, lib)})
    del moe_cases
    launch_rows = []
    for label, family, name, kern, plain, lib, (b_ms, b_by) in launch_cases:
        launch_rows.append({
            "name": label, "route": "cuda", "source": KERNELS[name][0],
            "replaces": KERNELS[name][1],
            "launches": launch_paths[f"launch.serve[{family.split()[-1]}]"][
                name],
            "max_abs_err": launch_errs[label],
            "ms": cuda_ms(torch, kern), "plain_ms": cuda_ms(torch, plain),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None if lib is None else cuda_ms(torch, lib)})
    del launch_cases
    mesh_rows = []
    for (label, family, name, kern, plain, lib, (b_ms, b_by),
         path) in prefill_cases:
        mesh_rows.append({
            "name": label, "route": "cuda", "source": KERNELS[name][0],
            "replaces": KERNELS[name][1],
            "launches": prefill_paths[path][name] if path else 0,
            "max_abs_err": prefill_errs[label],
            "ms": cuda_ms(torch, kern), "plain_ms": cuda_ms(torch, plain),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None if lib is None else cuda_ms(torch, lib)})
    del prefill_cases
    emit({"phase": "mesh_kernel_times", "rows": mesh_rows,
          "library": "torch.nn.functional.scaled_dot_product_attention",
          "card": smi.splitlines()[0]})
    emit({"phase": "launch_kernel_times", "rows": launch_rows,
          "library": "torch.nn.functional.scaled_dot_product_attention",
          "card": smi.splitlines()[0]})
    emit({"phase": "lm_moe_ssm_kernel_times", "rows": moe_rows,
          "library": "torch.nn.functional.scaled_dot_product_attention",
          "card": smi.splitlines()[0]})
    emit({"phase": "lm_families_kernel_times", "rows": fam_rows,
          "library": "torch.nn.functional.scaled_dot_product_attention",
          "card": smi.splitlines()[0]})
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
    emit({"phase": "timeline", "seconds_at_phase_end": dict(PHASE_END_S)})
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
