"""liquidSVM as a downstream head over LM embeddings, on the PyTorch/CUDA
port.

    PYTHONPATH=src python examples/torch_lm_svm_head.py              # the card
    PYTHONPATH=src python examples/torch_lm_svm_head.py --device cpu --n-per-class 60

The twin of ``examples/lm_svm_head.py`` through ``repro_torch.embed`` and
``repro_torch.api``.

This is the composition the assignment asks about: the paper's technique
(cells + CV'd local SVMs) applied to the assigned LM architectures, now
through the ``repro_torch.embed`` subsystem.  The backbone (any
``--arch``, at its smoke widths) embeds sequences lazily behind the
ChunkSource contract at one fixed batch shape (on the card its attention
runs the flash attention kernel), with a write-through ``EmbedCache`` so
the second pass (and every rerun) is I/O-bound.  Voronoi cells are built
in EMBEDDING space; each cell gets a fully CV'd multiclass SVM.  Local
SVMs with a learned metric — Bottou-Vapnik local learning on top of an
LM.

It runs on the card unless ``--device cpu`` is given, and raises without
one.  The last line is one JSON object: the held-out error and the warm
re-embed's seconds.
"""
import argparse
import json
import shutil
import tempfile
import time

import numpy as np

from repro_torch.api.session import SVM
from repro_torch.configs import ARCH_IDS
from repro_torch.data.tokens import TokenPipeline, TokenPipelineConfig
from repro_torch.embed import EmbeddingExtractor, EmbeddingSource, resolve_arch
from repro_torch.kernels import runtime


def token_domains(cfg, n_per_class: int, seq: int, n_classes: int = 3):
    """Synthetic "domains": HMM pipelines with different seeds emit
    distinguishable token statistics — the LM embeds them apart."""
    toks, ys = [], []
    for cls in range(n_classes):
        pipe = TokenPipeline(TokenPipelineConfig(
            vocab=cfg.vocab, seq_len=seq, global_batch=n_per_class,
            seed=100 + cls, n_states=4,
            input_kind=cfg.input_kind, d_frontend=cfg.d_frontend))
        toks.append(np.asarray(pipe.batch(0)["inputs"]))
        ys.append(np.full(n_per_class, cls))
    tok = np.concatenate(toks)
    y = np.concatenate(ys)
    perm = np.random.default_rng(0).permutation(len(y))
    return tok[perm], y[perm]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device (default: the card)")
    ap.add_argument("--max-iters", type=int, default=400)
    ap.add_argument("--arch", default="stablelm-1.6b", choices=list(ARCH_IDS))
    ap.add_argument("--n-per-class", type=int, default=300)
    ap.add_argument("--seq", type=int, default=32)
    args = ap.parse_args(argv)
    dev = runtime.resolve_device(args.device)    # raises without a card
    print(f"device: {dev}")

    cfg = resolve_arch(f"{args.arch}:smoke")
    tok, y = token_domains(cfg, args.n_per_class, args.seq)
    n_te = len(y) // 4
    tok_te, y_te, tok_tr, y_tr = (tok[:n_te], y[:n_te],
                                  tok[n_te:], y[n_te:])

    # ONE extractor for train and test: one fixed-batch forward, frozen
    # deterministic params, mean pooling
    extractor = EmbeddingExtractor(cfg, pooling="mean", batch_size=64,
                                   seed=0, device=dev)
    cache_root = tempfile.mkdtemp(prefix="embed_cache_")
    xtr = EmbeddingSource(tok_tr, extractor, cache=cache_root,
                          labels=y_tr.astype(np.float32))

    # cells in embedding space + per-cell CV'd OvA SVM; labels stream from
    # the source (y=None), features are embedded lazily per chunk
    t0 = time.perf_counter()
    sess = SVM(xtr, scenario="ova", VORONOI="voronoi", CELL_SIZE=200,
               FOLDS=3, MAX_ITERATIONS=args.max_iters, device=dev)
    sel = sess.train().select()
    t_train = time.perf_counter() - t0

    err = sel.test(EmbeddingSource(tok_te, extractor), y_te).error
    print(f"arch={args.arch}  embed dim={xtr.dim}  "
          f"cells={sess.train_result.plan.n_cells}  "
          f"test error={100 * err:.2f}%  (train {t_train:.1f}s)")

    # the cache is now complete: a second pass over the same corpus
    # replays npz shards instead of running the backbone
    warm = EmbeddingSource(tok_tr, extractor, cache=cache_root)
    assert warm.cache_complete(), "write-through cache should be sealed"
    t0 = time.perf_counter()
    warm.materialize()
    warm_s = time.perf_counter() - t0
    print(f"warm re-embed of {warm.n_rows} rows: "
          f"{warm_s:.3f}s (cache replay, backbone idle)")
    shutil.rmtree(cache_root, ignore_errors=True)
    print(json.dumps({"device": str(dev), "arch": args.arch,
                      "embed_dim": int(xtr.dim), "error": err,
                      "warm_s": warm_s}))
    assert err < 0.34, "should beat 3-class chance (66%) by a wide margin"


if __name__ == "__main__":
    main()
