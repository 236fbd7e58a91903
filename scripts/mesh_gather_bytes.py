#!/usr/bin/env python3
"""What each rank of the production mesh holds per region of the sharded
LM step, per model config.

    PYTHONPATH=src python3 scripts/mesh_gather_bytes.py [--mesh 16 16]

The sharded step runs four regions on local shards with explicit
collectives (``models.layers.Region``): attention head-parallel over
'model' (by head group where 'model' does not divide the heads:
``models.attention.head_groups``), the embedding and the cross-entropy
vocab-parallel, the MoE expert-parallel; what has no split to use runs on
each rank's rows (``layers.run_on_rows``: a vocabulary that is not split).
Prints one JSON line a config: each region's path and local sizes, and
for one rank, computed from the templates (no run):

  * ``weight_bytes_a_step``: the weights it holds for the region in a
    step: its 'model' blocks with the FSDP split over 'data' gathered
    (``fsdp_params``), a head group's wq / wo blocks and the wk / wv
    blocks of the neighbours that hold its kv heads gathered; on the rows
    path the whole matrices (their gradients are reduced as sums of the
    same size);
  * ``shard_bytes_a_step``: the shard of those weights the specs give it;
  * ``activation_bytes_a_token_layer``: the activations it holds whole
    for the region, per token and layer: the row with d whole (a
    head-parallel or expert-parallel region), or the q, k and v of every
    head (the rows path).
"""
from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.configs import ARCH_IDS, get_arch  # noqa: E402
from repro_torch.models import model as model_mod  # noqa: E402
from repro_torch.models.attention import head_groups  # noqa: E402


def shard_factor(spec, sizes: dict) -> int:
    n = 1
    for s in spec:
        for a in (s,) if isinstance(s, str) else (s or ()):
            n *= sizes[a]
    return n


def regions(cfg, sizes: dict) -> dict:
    """Each region's path and, for one rank: the weight bytes it holds
    for the region in a step (``weight_bytes_a_step``: its 'model' blocks
    with the FSDP split gathered, a shared kv head whole; the whole
    matrices on the rows path), the shard the specs give it
    (``shard_bytes_a_step``) and the activation bytes it gathers per token
    and layer (a head group's rank computes on 1 / ``ranks_a_group`` of
    the rows it gathers)."""
    m = sizes["model"]
    esize = cfg.dtype.itemsize
    d, hd = cfg.d_model, cfg.head_dim
    tmpl = model_mod.build_template(cfg)
    layer_of = [cfg.period_pattern[i % cfg.period] for i in range(cfg.n_layers)]
    out = {}

    def shard(ps) -> int:
        return math.prod(ps.shape) * ps.dtype.itemsize // shard_factor(
            ps.spec, sizes)

    n_attn = sum(k.startswith("attn") for k, _ in layer_of)
    if n_attn:
        per_layer = esize * d * hd * (2 * cfg.n_heads + 2 * cfg.n_kv_heads)
        grp = head_groups(cfg.n_heads, cfg.n_kv_heads, hd, m)
        if grp is not None:
            kv_cols = grp.kv_ranks * cfg.n_kv_heads * hd // m
            held = esize * d * (2 * grp.heads * hd + 2 * kv_cols)
            out["attention"] = {
                "path": "head-parallel" if grp.ranks == 1 else "head groups",
                "heads_a_rank": grp.heads, "kv_heads_a_rank": grp.kv,
                "ranks_a_group": grp.ranks,
                "weight_bytes_a_step": held * n_attn,
                "activation_bytes_a_token_layer": esize * d}
        else:
            out["attention"] = {
                "path": "rows", "heads_a_rank": cfg.n_heads,
                "weight_bytes_a_step": per_layer * n_attn,
                "activation_bytes_a_token_layer":
                    (cfg.n_heads + 2 * cfg.n_kv_heads) * hd * esize}
        out["attention"]["shard_bytes_a_step"] = (
            per_layer * n_attn // (m * (sizes["data"] if cfg.fsdp_params
                                        else 1)))
    heads = [("embed", tmpl.get("embed", {}).get("tok"), 0)]
    heads.append(("ce", tmpl["lm_head"]["w"], 1) if "lm_head" in tmpl
                 else ("ce", heads[0][1], 0))
    for name, ps, dim in heads:
        if ps is None:                 # frames in: no token table
            continue
        split = len(ps.spec) > dim and ps.spec[dim] == "model"
        whole = math.prod(ps.shape) * ps.dtype.itemsize
        out[name] = {"path": "vocab-parallel" if split else "rows",
                     "vocab_a_rank": cfg.vocab // m if split else cfg.vocab,
                     "weight_bytes_a_step": whole // m if split else whole,
                     "shard_bytes_a_step": shard(ps)}
    n_moe = sum(f == "moe" for _, f in layer_of)
    if n_moe:
        experts = 3 * d * cfg.moe_d_ff * esize * cfg.n_experts
        router = d * cfg.n_experts * 4
        out["moe"] = {
            "path": "expert-parallel", "experts_a_rank": cfg.n_experts // m,
            "weight_bytes_a_step": (experts // m + router) * n_moe,
            "shard_bytes_a_step": (experts // m + router) * n_moe // (
                sizes["data"] if cfg.fsdp_params else 1),
            "activation_bytes_a_token_layer": esize * d}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mesh", type=int, nargs=2, default=(16, 16),
                    metavar=("DATA", "MODEL"))
    args = ap.parse_args()
    sizes = {"data": args.mesh[0], "model": args.mesh[1]}
    for arch in ARCH_IDS:
        cfg = get_arch(arch).config
        print(json.dumps({"arch": arch, "mesh": list(args.mesh),
                          "fsdp": cfg.fsdp_params, **regions(cfg, sizes)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
