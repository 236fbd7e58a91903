#!/usr/bin/env python3
"""B1, B1-sym, B3, B4, B5, B6, B7, B8, B9 and B10 device times from the port
in a given checkout, for comparing two commits in turns on one card.

    python3 scripts/kernel_turns.py --root . --label change
    python3 scripts/kernel_turns.py --root build/parent --label parent

Builds the checkout's kernels (into <root>/build/kernels), times each row
with CUDA events behind a sleep kernel (as ``chip_smoke.py``'s
``cuda_ms``), and prints one JSON line: the label, the card (``nvidia-smi``
name and power limit), {row: ms} and {row: digest}, the first 16 hex
digits of the sha256 of a row's output bytes from seeded operands, so
that two checkouts can be seen to give the same bits.  Rows: the D²
kernels (D2_ROWS below, digests): B1-sym at the training wave (16 slots
x 1824 rows, d 54) and at the LM SVM head's fit wave (3 cells of 921
rows, d 2048), B1 at the serving wave (256 slots x 8 rows x 2048 SVs, d
54) and at the fit's test phase (26 slots x 416 routed rows x 1824 SVs,
d 54: the launch of ``chip_smoke.py``'s train_fit test), B7 at (2048,
54)^2; B3 at the serving wave (256 slots x 8 rows x 2048 SVs x d 54, P 7)
and at the LM head's wave (the shape of ``chip_smoke.py``'s EmbedServe
launches: LM_HEAD below, d 2048), with digests; B8 at the one-cell shape
(8192 test rows x 2048 SVs x d 54, P 7), B6 at a Covertype chunk (65,536
rows x 291 centers x d 54) and at a HIGGS-width table (5500 x 28), with
the digests of their int32 owners; B4 at the training wave's
shape (16 slots x 5 folds x 1824 x 70 columns), B5 at one slot (1824 x
350), B10 at the LM path's decode step (B 8, S 320, Hk 32, G 1, D 64) and
at S = 32768 with B = 16 and B = 1, each with a bf16 and an int8 cache,
and SDPA (``torch.nn.functional.scaled_dot_product_attention`` on the
(B, Hk, S, D) layout) beside each bf16 B10 row.  The operands are random:
these kernels' times do not depend on the values.  Then the LM path's
decode step end to end (stablelm-1.6b at full width, seed-initialised,
batch 8, prompt 256): ms per step of ``serve.engine.generate`` over 64
new tokens less one, bf16 and int8 caches, the median of 3 runs on the
host clock.  Needs a CUDA card.

    python3 scripts/kernel_turns.py --root . --b9

builds only B9 and B10, where their libraries are missing or stale, and
times only B9's rows (B9_ROWS: the f32 shapes of the CUDA-core kernel,
and the LM path's bf16 shape as a control of the tensor-core kernel) and
B10's partials mode at the split decode's half ring, each with the
digest of its output and SDPA beside it (with an explicit boolean mask
for the window rows), and prints one JSON line; where it built B9, the
line also holds ``ptxas`` (registers and spills of each CUDA-core
instance), and where the checkout has it, ``blocks_per_sm`` (its
occupancy by head dim).  The same rows run at the end of the full mode.

    python3 scripts/kernel_turns.py --root . --b3-paths

times only B3 at the serving wave's shape for banks of B3_PATH_P columns,
each through the plan's choice and with each copy path forced
(``BULK_BANK_WAYS`` 0: per-thread copies; 32: the TMA spans wherever the
tile allows them), and prints one JSON line.

    python3 scripts/kernel_turns.py --root . --b10

builds only B10, and only where its library is missing or stale, and
times only its rows (the three B10_ROWS shapes with bf16 and int8
caches, SDPA beside the bf16 ones), each with the digest of its output
bytes, and prints one JSON line: quick turns for B10 alone, run again
and again in turns.  Where it built, the line also holds ``ptxas``:
ptxas's registers, stack and spills of each B10 instance at D 64 with a
bf16 query and cache and G 1 (the B10_ROWS' bf16 instances), by heads a
block and path.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import re
import subprocess
import sys
from pathlib import Path

SLEEP_CYCLES = 50_000_000
LM_HEAD = (4, 16, 704, 2048, 3)    # C, m, k, d, P
B3_PATH_P = (6, 7, 8, 16, 32, 64)
# name, kind, shape: sym (B, n, d), cross (B, n, m, d), gram (n, m, d)
D2_ROWS = (
    ("sq_dists_sym[train wave]", "sym", (16, 1824, 54)),
    ("sq_dists_sym[LM head fit]", "sym", (3, 921, 2048)),
    ("sq_dists[serving wave]", "cross", (256, 8, 2048, 54)),
    ("sq_dists[test phase]", "cross", (26, 416, 1824, 54)),
    ("gram", "gram", (2048, 2048, 54)))
# name, (B, T, S, H, Hk, D, mask kind, window, dtype)
B9_ROWS = (
    ("flash_attention[hubert-xlarge f32: 4x1024, H 16, D 80, bidir]",
     (4, 1024, 1024, 16, 16, 80, "bidir", 0, "float32")),
    ("flash_attention[head-parallel rank f32: 4x512, H 16, D 64, causal]",
     (4, 512, 512, 16, 16, 64, "causal", 0, "float32")),
    ("flash_attention[gemma3-4b group rank f32: 1x2048, H 1, D 256, "
     "window 1024]", (1, 2048, 2048, 1, 1, 256, "window", 1024, "float32")),
    ("flash_attention[jamba f32: 2x2048, H 32, Hk 8, D 128, causal]",
     (2, 2048, 2048, 32, 8, 128, "causal", 0, "float32")),
    ("flash_attention[command-r smoke f32: 4x24, H 8, Hk 2, D 8, causal]",
     (4, 24, 24, 8, 2, 8, "causal", 0, "float32")),
    ("flash_attention[stablelm-12b f32: 1x2048, H 32, Hk 8, D 160, causal]",
     (1, 2048, 2048, 32, 8, 160, "causal", 0, "float32")),
    ("flash_attention[LM path bf16: 32x256, H 32, D 64, causal]",
     (32, 256, 256, 32, 32, 64, "causal", 0, "bfloat16")))
B10_ROWS = (("decode_attention", 8, 320), ("decode_attention[B=16,S=32768]",
                                           16, 32768),
            ("decode_attention[B=1,S=32768]", 1, 32768))


def cuda_ms(torch, fn, iters: int, warmup: int = 2) -> float:
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


def digest(t) -> str:
    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:16]


def d2_rows(torch, gen, dev, rows: dict, digests: dict) -> None:
    from repro_torch.kernels.kernel_matrix import ops as km_ops

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)
    for name, kind, shape in D2_ROWS:
        if kind == "sym":
            x = randn(*shape)

            def fn():
                return km_ops.sq_dists(x, x, symmetric=True)
        elif kind == "cross":
            b, n, m, d = shape
            x, z = randn(b, n, d), randn(b, m, d)

            def fn():
                return km_ops.sq_dists(x, z)
        else:
            n, m, d = shape
            x, z = randn(n, d), randn(m, d)

            def fn():
                return km_ops.kernel_matrix(x, z, 0.7 * d ** 0.5)
        rows[name] = cuda_ms(torch, fn, 20)
        digests[name] = digest(fn())


def decode_steps(torch, dev) -> dict:
    import dataclasses
    import statistics
    import time
    from repro_torch.configs import get_arch
    from repro_torch.models import model as model_mod
    from repro_torch.serve import engine
    cfg = get_arch("stablelm-1.6b").config
    params = model_mod.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    prompt = torch.randint(0, cfg.vocab, (8, 256), device=dev, generator=gen)
    out = {}
    for kv in ("bf16", "int8"):
        c = dataclasses.replace(cfg, kv_cache_dtype=kv)
        engine.generate(c, params, prompt, 4)           # warm-up
        runs = []
        for _ in range(3):
            secs = []
            for new in (1, 64):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                engine.generate(c, params, prompt, new)
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
            runs.append((secs[1] - secs[0]) * 1e3 / 63)
        out[kv] = statistics.median(runs)
    return out


def b10_rows(torch, gen, dev, rows: dict, digests: dict) -> None:
    """B10 at B10_ROWS with bf16 and int8 caches (SDPA beside the bf16
    rows), each with the digest of its output."""
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.models.attention import quantize_kv
    hk, d = 32, 64
    for name, b, n_keys in B10_ROWS:
        q = torch.randn(b, hk, 1, d, generator=gen, device=dev,
                        dtype=torch.bfloat16)
        kc, vc = (torch.randn(b, n_keys, hk, d, generator=gen, device=dev,
                              dtype=torch.bfloat16) for _ in range(2))
        iters = 50 if n_keys < 1000 else 10
        rows[name] = cuda_ms(torch, lambda: dec_ops.decode_attention_fused(
            q, kc, vc, n_keys - 1, d ** -0.5), iters)
        digests[name] = digest(dec_ops.decode_attention_fused(
            q, kc, vc, n_keys - 1, d ** -0.5).float())
        kt, vt = (t.transpose(1, 2).contiguous() for t in (kc, vc))
        rows[name + "[sdpa]"] = cuda_ms(
            torch, lambda: F.scaled_dot_product_attention(q, kt, vt), iters)
        del kt, vt
        (k8, ks), (v8, vs) = quantize_kv(kc), quantize_kv(vc)
        del kc, vc
        label = name[:-1] + ",int8]" if "[" in name else name + "[int8]"
        rows[label] = cuda_ms(torch, lambda: dec_ops.decode_attention_fused(
            q, k8, v8, n_keys - 1, d ** -0.5, ks, vs), iters)
        digests[label] = digest(dec_ops.decode_attention_fused(
            q, k8, v8, n_keys - 1, d ** -0.5, ks, vs).float())
        del k8, v8, ks, vs
        torch.cuda.empty_cache()


def b9_rows(torch, gen, dev, rows: dict, digests: dict) -> None:
    """B9 at B9_ROWS and B10's partials mode at the split decode's half
    ring (B 4, the first 258 of 516 slots, Hk 32, G 1, D 64, bf16), each
    with SDPA beside it and the digest of its output."""
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import attention_mask
    for name, (b, t, s, h, hk, d, kind, win, dt) in B9_ROWS:
        dtype = getattr(torch, dt)
        q = torch.randn(b, t, h, d, generator=gen, device=dev, dtype=dtype)
        k, v = (torch.randn(b, s, hk, d, generator=gen, device=dev,
                            dtype=dtype) for _ in range(2))
        rows[name] = cuda_ms(torch, lambda: fa_ops.flash_attention(
            q, k, v, kind, win), 20)
        digests[name] = digest(fa_ops.flash_attention(q, k, v, kind,
                                                      win).float())
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        mask = (attention_mask(t, s, kind, win, dev) if kind == "window"
                else None)
        rows[name + "[sdpa]"] = cuda_ms(
            torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, is_causal=kind == "causal",
                enable_gqa=h > hk), 20)
        del q, k, v, qt, kt, vt
    name = "decode_attention_partials[B 4, 258 of 516, Hk 32, G 1, D 64]"
    q = torch.randn(4, 32, 1, 64, generator=gen, device=dev,
                    dtype=torch.bfloat16)
    kc, vc = (torch.randn(4, 258, 32, 64, generator=gen, device=dev,
                          dtype=torch.bfloat16) for _ in range(2))
    rows[name] = cuda_ms(torch, lambda: dec_ops.decode_attention_partials(
        q, kc, vc, 515, 0.125, block=(0, 516)), 50)
    digests[name] = digest(torch.cat([x.flatten() for x in
                                      dec_ops.decode_attention_partials(
        q, kc, vc, 515, 0.125, block=(0, 516))]))
    kt, vt = (x.transpose(1, 2).contiguous() for x in (kc, vc))
    rows[name + "[sdpa]"] = cuda_ms(
        torch, lambda: F.scaled_dot_product_attention(q, kt, vt,
                                                      scale=0.125), 50)


def cc_ptxas(log: str) -> dict:
    """{"<dtype> D <d>": "<registers>; <stack and spill line>"} of the
    CUDA-core B9 instances (flash_fwd_kernel<T, D>) in an ``-Xptxas -v``
    log."""
    pat = re.compile(r"flash_fwd_kernelI(f|13__nv_bfloat16)Li(\d+)E")
    out, key = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\w+)", line)
        if m:
            hit = pat.search(m.group(1))
            key = (f"{'f32' if hit.group(1) == 'f' else 'bf16'} D "
                   f"{hit.group(2)}" if hit else None)
            continue
        if key is not None and ("stack frame" in line or "Used" in line):
            out[key] = "; ".join(filter(None, (
                out.get(key), line.split(" : ", 1)[-1].strip())))
    return out


# decode_fwd_kernel<bf16, bf16, D 64, G 1, HB, DIRECT>, mangled (in an
# anonymous namespace: the second bf16 a back reference)
B10_BF16_D64_G1 = re.compile(
    r"decode_fwd_kernelI13__nv_bfloat16S\d*_Li64ELi1ELi(\d+)ELb([01])E")


def b10_ptxas(log: str) -> dict:
    """{"HB <h>, direct|ring": "<registers>; <stack and spill line>"} of
    the B10 instances B10_BF16_D64_G1 matches, from an ``-Xptxas -v``
    log."""
    out, key = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\w+)", line)
        if m:
            hit = B10_BF16_D64_G1.search(m.group(1))
            key = (f"HB {hit.group(1)}, "
                   f"{'direct' if hit.group(2) == '1' else 'ring'}"
                   if hit else None)
            continue
        if key is None:
            continue
        if "stack frame" in line or "Used" in line:
            out[key] = "; ".join(filter(None, (
                out.get(key), line.split(" : ", 1)[-1].strip())))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=".", help="checkout whose src/ to time")
    ap.add_argument("--label", default="")
    ap.add_argument("--b3-paths", action="store_true",
                    help="time only B3's copy paths at the serving wave")
    ap.add_argument("--b10", action="store_true",
                    help="build and time only B10's rows, with digests")
    ap.add_argument("--b9", action="store_true",
                    help="build B9 and B10 and time only B9's rows and "
                         "B10's partials, with digests")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("kernel_turns: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.root).resolve() / "src"))
    from repro_torch.kernels import runtime
    from repro_torch.kernels.assign import ops as as_ops
    from repro_torch.kernels.cd_solver import ops as cd_ops
    from repro_torch.kernels.svm_predict import ops as sp_ops

    ptxas = None
    if args.b9:
        stale = [n for n in ("flash_attention", "decode_attention")
                 if runtime._stale(n)]
        built = runtime.build(stale) if stale else {}
        if "flash_attention" in built:
            ptxas = cc_ptxas(built["flash_attention"]["log"])
    elif not args.b10:
        runtime.build(("kernel_matrix", "cd_solver", "decode_attention",
                       "svm_predict", "assign", "flash_attention"))
    elif runtime._stale("decode_attention"):
        ptxas = b10_ptxas(runtime.build(("decode_attention",))
                          ["decode_attention"]["log"])
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    rows, digests = {}, {}

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    def card() -> str:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True, check=True).stdout.strip()

    if args.b3_paths:
        default = sp_ops.BULK_BANK_WAYS
        for p in B3_PATH_P:
            c, m, k, d = 256, 8, 2048, 54
            xt, sv, co = randn(c, m, d), randn(c, k, d), randn(c, k, p)
            ga = (torch.rand(c, p, generator=gen, device=dev) + 0.5) * d ** 0.5
            for label, ways in (("plan", default), ("copies", 0),
                                ("bulk", 32)):
                sp_ops.BULK_BANK_WAYS = ways
                plan = sp_ops.predict_plan(c, m, k, d, p, 132, 2, True)
                rows[f"svm_predict_cells[P {p}, {label}: "
                     f"{'bulk' if plan.bulk else 'copies'}]"] = cuda_ms(
                    torch, lambda: sp_ops.svm_predict_cells(xt, sv, co, ga),
                    50)
            sp_ops.BULK_BANK_WAYS = default
        print(json.dumps({"label": args.label, "card": card(), "ms": rows}))
        return 0

    if args.b9:
        from repro_torch.kernels.flash_attention import ops as fa_ops
        occupancy = ({d: fa_ops.cc_blocks_per_sm(d) for d in fa_ops.HEAD_DIMS}
                     if hasattr(fa_ops, "cc_blocks_per_sm") else None)
        b9_rows(torch, gen, dev, rows, digests)
        print(json.dumps({"label": args.label, "card": card(), "ms": rows,
                          "digests": digests, "ptxas": ptxas,
                          "blocks_per_sm": occupancy}))
        return 0
    if args.b10:
        b10_rows(torch, gen, dev, rows, digests)
        print(json.dumps({"label": args.label, "card": card(), "ms": rows,
                          "digests": digests, "ptxas": ptxas}))
        return 0
    d2_rows(torch, gen, dev, rows, digests)
    for name, (c, m, k, d, p) in (("svm_predict_cells", (256, 8, 2048, 54, 7)),
                                  ("svm_predict_cells[LM head]", LM_HEAD)):
        xt, sv, co = randn(c, m, d), randn(c, k, d), randn(c, k, p)
        ga = (torch.rand(c, p, generator=gen, device=dev) + 0.5) * d ** 0.5
        rows[name] = cuda_ms(torch, lambda: sp_ops.svm_predict_cells(
            xt, sv, co, ga), 50)
        digests[name] = digest(sp_ops.svm_predict_cells(xt, sv, co, ga))
    x, sv, co = randn(8192, 54), randn(2048, 54), randn(2048, 7)
    rows["svm_predict"] = cuda_ms(torch, lambda: sp_ops.svm_predict(
        x, sv, co, 0.7 * 54 ** 0.5), 20)
    for name, (n, c, d) in (("assign", (65536, 291, 54)),
                            ("assign[HIGGS]", (65536, 5500, 28))):
        x = randn(n, d) * 2
        cen = (x[torch.randint(0, n, (c,), generator=gen, device=dev)]
               + 0.5 * randn(c, d))
        rows[name] = cuda_ms(torch, lambda: as_ops.assign(x, cen), 20)
        digests[name] = digest(as_ops.assign(x, cen))
    del x, sv, co, cen

    s, f, n, p = 16, 5, 1824, 70
    x = torch.randn(s, n, 5, generator=gen, device=dev)
    k = torch.exp(-torch.cdist(x, x) ** 2 / 4.0)
    k = (k + k.transpose(1, 2)) / 2          # symmetric bit for bit
    lo = -torch.rand(s, f, n, p, generator=gen, device=dev)
    hi = torch.rand(s, f, n, p, generator=gen, device=dev)
    c = torch.zeros(s, f, n, p, device=dev)
    g = torch.randn(s, f, n, p, generator=gen, device=dev)
    rows["cd_wave_epoch"] = cuda_ms(
        torch, lambda: cd_ops.cd_wave_epoch(k, c, g, lo, hi), 5, 1)
    one = [t[0].permute(1, 0, 2).reshape(n, f * p).contiguous()
           for t in (c, g, lo, hi)]
    rows["cd_epoch"] = cuda_ms(torch, lambda: cd_ops.cd_epoch(k[0], *one),
                               5, 1)
    del k, lo, hi, c, g, one

    b10_rows(torch, gen, dev, rows, digests)
    b9_rows(torch, gen, dev, rows, digests)
    decode = decode_steps(torch, dev)
    print(json.dumps({"label": args.label, "card": card(), "ms": rows,
                      "digests": digests, "decode_ms_per_step": decode}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
