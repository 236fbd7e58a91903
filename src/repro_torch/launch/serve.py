"""Serving launcher: batched generation with the reduced config.

``python -m repro_torch.launch.serve --arch stablelm-1.6b --batch 4 --new 16``

On the card (the default device) the prefill runs the flash attention
kernel (B9) and every decode step the fused decode kernel (B10);
``--device cpu`` runs their plain versions.  Prints one JSON line:
``arch``, ``out_shape``, ``tokens_per_s``, ``wall_s``.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.kernels import runtime
from repro_torch.models import model as model_mod
from repro_torch.serve.engine import generate


def run(cfg, dev: torch.device, batch: int, prompt_len: int, new: int,
        temperature: float = 0.0, seed: int = 0):
    """Parameters and a prompt drawn from ``seed`` on ``dev``, then
    ``generate`` -> (prompt, tokens, wall seconds of the generation)."""
    params = model_mod.init_params(
        cfg, torch.Generator(device=dev).manual_seed(seed))
    prompt = torch.randint(
        0, cfg.vocab, (batch, prompt_len), dtype=torch.int32,
        generator=torch.Generator(device=dev).manual_seed(seed + 1),
        device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.time()
    out = generate(cfg, params, prompt, max_new_tokens=new,
                   temperature=temperature, generator=gen)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return prompt, out, time.time() - t0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list(ARCH_IDS))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device (default: the card)")
    args = ap.parse_args(argv)

    arch = get_arch(args.arch)
    cfg = arch.smoke
    if not cfg.is_decoder:
        print(f"{args.arch} is encoder-only; no autoregressive serve path")
        return 0
    dev = runtime.resolve_device(args.device)
    _, out, dt = run(cfg, dev, args.batch, args.prompt_len, args.new,
                     args.temperature, args.seed)
    print(json.dumps({
        "arch": args.arch, "out_shape": list(out.shape),
        "tokens_per_s": round(args.batch * args.new / dt, 1),
        "wall_s": round(dt, 2)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
