#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port: the cell-routed serving path.

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (``nvcc``); builds the port's
kernels from ``src/repro_torch/csrc/`` into ``build/kernels/`` and then:

  1. prints the card (``nvidia-smi`` name and power limit) and the build;
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
  4. times each kernel at the main path's shapes beside its plain version,
     its bound from bytes and operations, and a one-call PyTorch yardstick
     where one exists, and times the serving waves;
  5. prints one JSON line per phase, the kernel table, and last
     ``{"ok": true, "device": {...}}``.

Any mismatch or exception ends the run with a non-zero exit code.  Without
a card, or without the rest of the repository beside it, it exits non-zero
before printing any result.
"""
from __future__ import annotations

import json
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

# the card's published peaks (H100 SXM data sheet, dense, 700 W)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

KERNELS = {  # name -> (wrapper source, TPU kernel it replaces)
    "sq_dists": ("src/repro_torch/csrc/kernel_matrix.cu",
                 "src/repro/kernels/kernel_matrix/kernel_matrix.py:134"),
    "gram_from_d2": ("src/repro_torch/csrc/kernel_matrix.cu",
                     "src/repro/kernels/kernel_matrix/kernel_matrix.py:190"),
    "svm_predict_cells": ("src/repro_torch/csrc/svm_predict.cu",
                          "src/repro/kernels/svm_predict/svm_predict.py:122"),
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


def cuda_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(n_bytes: float, n_ops: float) -> tuple:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_FLOP_PER_S * 1e3
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
    from repro_torch.kernels.kernel_matrix import ops as km_ops
    from repro_torch.kernels.kernel_matrix import ref as km_ref
    from repro_torch.kernels.svm_predict import ops as sp_ops
    from repro_torch.kernels.svm_predict import ref as sp_ref
    from repro_torch.distributed.planner import plan_wave
    from repro_torch.pipeline.assign import nearest_center, nearest_top2_dists
    from repro_torch.serve import ModelBank, SVMEngine, blend_weights

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
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})
    emit({"phase": "build", "seconds": build_s,
          "per_source_s": {k: v["seconds"] for k, v in logs.items()},
          "ptxas": ptxas})

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
        for table in (km_ops.launches, sp_ops.launches):
            for name in table:
                table[name] = 0
        out = run()
        return out, {**km_ops.launches, **sp_ops.launches}

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
    for name, (kern, plain, lib, (b_ms, b_by)) in timing.items():
        rows.append({
            "name": name, "route": "cuda", "source": KERNELS[name][0],
            "replaces": KERNELS[name][1], "launches": launches[name],
            "max_abs_err": errs[name], "ms": cuda_ms(torch, kern),
            "plain_ms": cuda_ms(torch, plain), "bound_ms": b_ms,
            "bound_by": b_by,
            "library_ms": None if lib is None else cuda_ms(torch, lib)})
    emit({"phase": "kernel_times", "shapes": shapes,
          "card": smi.splitlines()[0]})
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
