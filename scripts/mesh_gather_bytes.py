#!/usr/bin/env python3
"""What ``models.layers.run_on_rows`` gathers whole on every rank of the
production mesh, per model config.

    PYTHONPATH=src python3 scripts/mesh_gather_bytes.py [--mesh 16 16]

The sharded LM step runs the embedding gather, training attention and the
cross-entropy on each rank's own rows with the weights gathered whole
(ROADMAP A4's note), so each rank holds, per step, the whole embedding
table and head matrix in their stored dtype, where the specs would give it
one shard; and, per layer, the q, k and v of its rows with every head,
where a head-parallel split over 'model' would give it 1/model of the
heads.  Prints one JSON line a config: those bytes per rank (the weights
a step, their gradients reduced as sums of the same size), the shard the
specs give, and q/k/v bytes per token and layer, whole and head-split.
Computed from the templates, no run.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.configs import ARCH_IDS, get_arch  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models import model as model_mod  # noqa: E402


def shard_factor(spec, sizes: dict) -> int:
    n = 1
    for s in spec:
        for a in (s,) if isinstance(s, str) else (s or ()):
            n *= sizes[a]
    return n


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mesh", type=int, nargs=2, default=(16, 16),
                    metavar=("DATA", "MODEL"))
    args = ap.parse_args()
    sizes = {"data": args.mesh[0], "model": args.mesh[1]}
    for arch in ARCH_IDS:
        cfg = get_arch(arch).config
        tmpl = model_mod.build_template(cfg)
        whole = shard = 0
        for path, ps in layers.tree_items(tmpl):
            if path in (("embed", "tok"), ("lm_head", "w")):
                n = math.prod(ps.shape) * ps.dtype.itemsize
                whole += n
                shard += n // shard_factor(ps.spec, sizes)
        esize = cfg.dtype.itemsize
        # rwkv6 has no attention layer
        attn = any(m.startswith("attn") for m, _ in cfg.period_pattern)
        qkv = ((cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.head_dim * esize
               if attn else 0)
        print(json.dumps({
            "arch": arch, "mesh": list(args.mesh),
            "embed_and_head_whole_bytes_per_rank": whole,
            "embed_and_head_shard_bytes_per_rank": shard,
            "qkv_bytes_per_token_layer_heads_whole": qkv,
            "qkv_bytes_per_token_layer_head_split":
                qkv / sizes["model"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
