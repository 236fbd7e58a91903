"""Batched LM serving on the PyTorch/CUDA port: generation, and
co-located embed->SVM serving.

    PYTHONPATH=src python examples/torch_serve_lm.py --arch gemma3-4b --batch 4
    PYTHONPATH=src python examples/torch_serve_lm.py --svm-head   # EmbedServe demo
    PYTHONPATH=src python examples/torch_serve_lm.py --device cpu --new 8

The twin of ``examples/serve_lm.py`` through ``repro_torch.serve``: the
default path is prefill + autoregressive decode with a KV cache
(``serve.engine.generate``, through the serve launcher's
``launch.serve.run``; on the card the prefill runs the flash
attention kernel and every decode step the fused decode kernel).  With
``--svm-head`` the serving half flips to the embedding vertical: a small
SVM bank is trained over frozen-backbone embeddings, then token requests
are served through ``repro_torch.serve.EmbedServe`` (backbone forward and
cell-routed SVM evaluation co-located in one process, the per-request
latency breakdown with an ``embed_ms`` stage).

It runs on the card unless ``--device cpu`` is given, and raises without
one.  The last line is one JSON object: tokens generated (or requests
submitted and served) and the rate.
"""
import argparse
import json
import os
import sys
import time

import numpy as np

from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.kernels import runtime
from repro_torch.launch import serve as serve_launch


def svm_head_demo(arch: str, dev, n_per_class: int) -> dict:
    """Token requests -> embed -> route -> blend, one process."""
    from repro_torch.api.session import SVM
    from repro_torch.embed import EmbeddingExtractor, EmbeddingSource, resolve_arch
    from repro_torch.serve import EmbedServe, SVMEngine
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from torch_lm_svm_head import token_domains

    cfg = resolve_arch(f"{arch}:smoke")
    tok, y = token_domains(cfg, n_per_class=n_per_class, seq=24, n_classes=2)
    y = np.where(y > 0, 1.0, -1.0)
    extractor = EmbeddingExtractor(cfg, pooling="mean", batch_size=64,
                                   seed=0, device=dev)
    xs = EmbeddingSource(tok, extractor, labels=y)
    bank = SVM(xs, FOLDS=2, MAX_ITERATIONS=200, CELL_SIZE=120,
               device=dev).train().select().to_bank()

    serve = EmbedServe(SVMEngine(bank, deadline_ms=5.0, device=dev),
                       extractor)
    rng = np.random.default_rng(3)
    queries = tok[rng.integers(0, len(tok), 64)]
    t0 = time.time()
    results = serve.run_tokens(queries[i:i + 16] for i in range(0, 64, 16))
    dt = time.time() - t0
    rid = sorted(results)[0]
    b = serve.breakdown(rid)
    stages = {k: v for k, v in b.items() if k.endswith("_ms")
              and k != "total_ms"}
    assert abs(sum(stages.values()) - b["total_ms"]) < 1e-6
    print(f"arch={arch} (reduced config) embed->route->blend co-located")
    print(f"served {len(results)} token requests in {dt:.2f}s "
          f"({len(results) / dt:.1f} rps)")
    print(f"request {rid} breakdown (ms): " + ", ".join(
        f"{k[:-3]}={v:.3f}" for k, v in b.items() if k.endswith("_ms")))
    return {"submitted": len(queries), "served": len(results),
            "requests_per_s": len(results) / dt}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-4b", choices=list(ARCH_IDS))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--new", type=int, default=24)
    ap.add_argument("--svm-head", action="store_true",
                    help="serve token requests through the co-located "
                         "embed->SVM engine (EmbedServe) instead of "
                         "autoregressive generation")
    ap.add_argument("--n-per-class", type=int, default=200,
                    help="--svm-head: training sequences a class")
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device (default: the card)")
    args = ap.parse_args(argv)
    dev = runtime.resolve_device(args.device)    # raises without a card
    print(f"device: {dev}")

    if args.svm_head:
        out = svm_head_demo(args.arch, dev, args.n_per_class)
        print(json.dumps({"device": str(dev), "arch": args.arch, **out}))
        return

    cfg = get_arch(args.arch).smoke
    if not cfg.is_decoder:
        print(f"{args.arch} is encoder-only — no decode path (by design)")
        return
    prompt, out, dt = serve_launch.run(cfg, dev, args.batch,
                                       args.prompt_len, args.new,
                                       temperature=0.8, seed=2)
    prompt, out = prompt.cpu().numpy(), out.cpu().numpy()
    print(f"arch={args.arch} (reduced config) batch={args.batch}")
    print(f"generated {args.batch}x{args.new} tokens in {dt:.2f}s "
          f"({args.batch * args.new / dt:.1f} tok/s incl. prefill)")
    print("sample row:", out[0, -args.new:].tolist()[:16], "...")
    print(json.dumps({"device": str(dev), "arch": args.arch,
                      "shape": list(out.shape),
                      "prompt_kept": bool((out[:, :args.prompt_len]
                                           == prompt).all()),
                      "in_vocab": bool(((out >= 0) & (out < cfg.vocab)).all()),
                      "tokens_per_s": args.batch * args.new / dt}))


if __name__ == "__main__":
    main()
