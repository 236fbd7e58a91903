#!/usr/bin/env python3
"""Variants of B9's CUDA-core (f32) kernel, built side by side and timed
through the wrapper in turns on one card.

    python3 scripts/b9_variants.py SPEC.json

SPEC maps a variant's name to either a list of [old, new] text
substitutions, each applied once to ``src/repro_torch/csrc/flash_attention.cu``
(``[]``: the source as it is), or the path of a whole source file
relative to the repository root.  Each variant is compiled by its own
``nvcc`` (all started together, the runtime's flags) into
``build/variants/lib<name>.so``; the line printed for it holds ptxas's
registers and spills of each CUDA-core instance and the occupancy
calculator's blocks an SM by head dim.  Then the f32 rows of
``scripts/kernel_turns.py``'s B9_ROWS run through
``kernels.flash_attention.ops.flash_attention`` with the module's library
and ``CC_BLOCKS_PER_SM`` pointed at each variant in turn, forward and
then backward over the variants, and one JSON line gives each variant's
ms per row (one value a turn) and its largest error against the plain
version.  A substitution that cuts a phase out (an ablation) gives
wrong outputs by design: read its error as such.  Needs a CUDA card.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "src" / "repro_torch" / "csrc" / "flash_attention.cu"


def variant_source(spec) -> str:
    if isinstance(spec, str):
        return (ROOT / spec).read_text()
    src = SOURCE.read_text()
    for old, new in spec:
        if src.count(old) != 1:
            raise ValueError(f"substitution not found once: {old[:60]!r}")
        src = src.replace(old, new)
    return src


def bind(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_attention_fwd.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i,
                                        i, i, i, f, i, p]
    lib.flash_attention_fwd.restype = i
    lib.flash_attention_cc_blocks_per_sm.argtypes = [i, i]
    lib.flash_attention_cc_blocks_per_sm.restype = i
    return lib


def main() -> int:
    import torch
    if not torch.cuda.is_available() or len(sys.argv) != 2:
        print("b9_variants: needs a CUDA card and a SPEC.json",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT / "scripts"))
    import kernel_turns as kt
    from repro_torch.kernels import runtime
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref

    specs = json.loads(Path(sys.argv[1]).read_text())
    out_dir = ROOT / "build" / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "async_copy.cuh").write_text(
        (SOURCE.parent / "async_copy.cuh").read_text())
    procs = {}
    for name, spec in specs.items():
        cu = out_dir / f"{name}.cu"
        cu.write_text(variant_source(spec))
        procs[name] = subprocess.Popen(
            [runtime.nvcc(), *runtime.NVCC_FLAGS, "-o",
             str(out_dir / f"lib{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            print(json.dumps({"variant": name, "build_failed": log[-3000:]}))
            continue
        libs[name] = bind(out_dir / f"lib{name}.so")
        print(json.dumps({"variant": name, "ptxas": kt.cc_ptxas(log),
                          "blocks_per_sm": {
                              d: libs[name].flash_attention_cc_blocks_per_sm(
                                  d, 0) for d in fa_ops.HEAD_DIMS}}),
              flush=True)

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for label, (b, t, s, h, hk, d, kind, win, dt) in kt.B9_ROWS:
        if dt != "float32":
            continue
        q = torch.randn(b, t, h, d, generator=gen, device=dev)
        k, v = (torch.randn(b, s, hk, d, generator=gen, device=dev)
                for _ in range(2))
        rows.append((label, q, k, v, kind, win,
                     fa_ref.flash_attention_ref(q, k, v, kind, win)))
    lib0, bps0 = fa_ops._lib, dict(fa_ops.CC_BLOCKS_PER_SM)
    res = {name: {} for name in libs}
    try:
        for name in list(libs) + list(reversed(list(libs))):
            lib = libs[name]
            fa_ops._lib = lambda lib=lib: lib
            fa_ops.CC_BLOCKS_PER_SM = {
                d: max(1, lib.flash_attention_cc_blocks_per_sm(d, 0))
                for d in fa_ops.HEAD_DIMS}
            fa_ops.split_count.cache_clear()
            for label, q, k, v, kind, win, want in rows:
                got = fa_ops.flash_attention(q, k, v, kind, win)
                res[name][label + "[err]"] = float((got - want).abs().max())
                res[name].setdefault(label, []).append(kt.cuda_ms(
                    torch, lambda: fa_ops.flash_attention(q, k, v, kind,
                                                          win), 20))
    finally:
        fa_ops._lib, fa_ops.CC_BLOCKS_PER_SM = lib0, bps0
        fa_ops.split_count.cache_clear()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(json.dumps({"card": card, "results": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
