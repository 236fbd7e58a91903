#!/usr/bin/env python3
"""B4, B5 and B10 device times from the port in a given checkout, for
comparing two commits in turns on one card.

    python3 scripts/kernel_turns.py --root . --label change
    python3 scripts/kernel_turns.py --root build/parent --label parent

Builds the checkout's kernels (into <root>/build/kernels), times each row
with CUDA events behind a sleep kernel (as ``chip_smoke.py``'s
``cuda_ms``), and prints one JSON line: the label, the card (``nvidia-smi``
name and power limit) and {row: ms}.  Rows: B4 at the training wave's
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
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

SLEEP_CYCLES = 50_000_000
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=".", help="checkout whose src/ to time")
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("kernel_turns: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.root).resolve() / "src"))
    from repro_torch.kernels import runtime
    from repro_torch.kernels.cd_solver import ops as cd_ops
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.models.attention import quantize_kv
    import torch.nn.functional as F

    runtime.build(("cd_solver", "decode_attention"))
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = {}

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

    hk, d = 32, 64
    for name, b, n_keys in B10_ROWS:
        q = torch.randn(b, hk, 1, d, generator=gen, device=dev,
                        dtype=torch.bfloat16)
        kc, vc = (torch.randn(b, n_keys, hk, d, generator=gen, device=dev,
                              dtype=torch.bfloat16) for _ in range(2))
        iters = 50 if n_keys < 1000 else 10
        rows[name] = cuda_ms(torch, lambda: dec_ops.decode_attention_fused(
            q, kc, vc, n_keys - 1, d ** -0.5), iters)
        kt, vt = (t.transpose(1, 2).contiguous() for t in (kc, vc))
        rows[name + "[sdpa]"] = cuda_ms(
            torch, lambda: F.scaled_dot_product_attention(q, kt, vt), iters)
        del kt, vt
        (k8, ks), (v8, vs) = quantize_kv(kc), quantize_kv(vc)
        del kc, vc
        rows[name[:-1] + ",int8]" if "[" in name else name + "[int8]"] = \
            cuda_ms(torch, lambda: dec_ops.decode_attention_fused(
                q, k8, v8, n_keys - 1, d ** -0.5, ks, vs), iters)
        del k8, v8, ks, vs
        torch.cuda.empty_cache()

    decode = decode_steps(torch, dev)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(json.dumps({"label": args.label, "card": card, "ms": rows,
                      "decode_ms_per_step": decode}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
