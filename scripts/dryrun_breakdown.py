#!/usr/bin/env python3
"""Where one dry-run cell's FLOPs and collectives come from.

    PYTHONPATH=src python3 scripts/dryrun_breakdown.py --arch stablelm-1.6b --shape train_4k
        [--mesh single|multi] [--layers N] [--top 12]
    PYTHONPATH=src python3 scripts/dryrun_breakdown.py --arch stablelm-1.6b --shape decode_32k
    PYTHONPATH=src python3 scripts/dryrun_breakdown.py --arch qwen3-moe-235b-a22b --shape train_4k --layers 2 --plain-loop

Runs the cell as ``python -m repro_torch.launch.dryrun`` does (rank 0 of
a fake process group, fake tensors, ``launch.op_cost.CostMode``) and files
each counted op under:

  * its call site: the innermost frame in ``repro_torch/models`` or
    ``repro_torch/train`` (backward ops land on ``lm_trainer``'s
    ``autograd.grad`` line, a recomputed forward on its own lines);
  * the issuer of each collective: ``region:<function>`` (the c10d
    collectives of ``models.layers.Region``, by the model function that
    issued them: ``_decode_split`` and ``merge_partials`` are the decode
    attention's, ``glu_mlp_region`` the dense MLP's, ``backward`` the
    duals autograd runs), ``dtensor:<op>`` (a DTensor sharding plan of
    that aten op, or ``dtensor:redistribute`` for an explicit
    redistribution), else ``other``.

``--plain-loop`` runs the MoE's chunk loop trip by trip under the meter
(``models.layers.scan_override(None)``), as the model runs it, in place
of the meter's count of it as a scan (``op_cost.loop_trips``): the two
counts should be equal.

Prints one JSON line: the cell's totals, the seconds the step took to
trace (``trace_s``, this counting included), the ``--top`` call sites by
FLOPs, the collective bytes and counts by (issuer, collective), and the
regions rank 0 ran with their local sizes (``models.layers.REGION_TRACE``:
e.g. attention's heads, kv heads and, by head group, rows).  Run it as
its own process (the fake group must not meet a real one).
"""
from __future__ import annotations

import argparse
import collections
import json
import sys
import time
import traceback
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.launch import dryrun, op_cost  # noqa: E402
from repro_torch.launch import shapes as shapes_mod  # noqa: E402
from repro_torch.models import layers  # noqa: E402

_REGION = {"_gather_dim", "_scatter_dim", "_reduce"}
# layers.py's collective plumbing, skipped when naming a region's issuer
_PLUMBING = _REGION | {"forward", "backward", "apply", "all_gather",
                       "all_reduce", "all_reduce_max", "all_reduce_sum_grad",
                       "act", "out", "weight", "weights", "gather_rows",
                       "model_blocks",
                       "<lambda>", "<listcomp>", "<dictcomp>", "<genexpr>",
                       "tree_map"}
_REDISTRIBUTE = {"redistribute_local_tensor", "redistribute"}


def _site() -> str:
    for fr in reversed(traceback.extract_stack()):
        name = fr.filename.replace("\\", "/")
        if "repro_torch/models" in name or "repro_torch/train" in name:
            return f"{name.split('repro_torch/')[1]}:{fr.lineno}"
    return "?"


def _issuer() -> str:
    frames, f = [], sys._getframe(3)
    while f is not None:
        frames.append(f)
        f = f.f_back
    for f in frames:
        if f.f_code.co_name in _REGION and f.f_code.co_filename.endswith(
                "models/layers.py"):
            for g in frames:
                if ("repro_torch/models" in g.f_code.co_filename.replace(
                        "\\", "/") and g.f_code.co_name not in _PLUMBING):
                    return f"region:{g.f_code.co_name}"
            return "region:backward"
    for f in frames:                   # the aten op DTensor was planning
        op = f.f_locals.get("op_call")
        if op is not None:
            return f"dtensor:{op}"
    for f in frames:
        if (f.f_code.co_name in _REDISTRIBUTE
                and "/tensor/" in f.f_code.co_filename):
            return "dtensor:redistribute"
    return "other"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--mesh", default="single", choices=list(dryrun.MESHES))
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--plain-loop", action="store_true",
                    help="trace the MoE chunk loop trip by trip")
    args = ap.parse_args()

    flops = collections.Counter()
    coll = collections.Counter()
    calls = collections.Counter()
    count = op_cost.CostMode._count

    def counted(self, name, a, kw, out):
        f0, b0 = self.cost.flops, sum(self.collective_bytes.values())
        count(self, name, a, kw, out)
        df = self.cost.flops - f0
        db = sum(self.collective_bytes.values()) - b0
        if df:
            flops[_site()] += df
        if name in op_cost.COLLECTIVES:
            key = f"{_issuer()} {op_cost.COLLECTIVES[name]}"
            coll[key] += db
            calls[key] += 1

    op_cost.CostMode._count = counted
    mesh_name, mesh = dryrun.production_mesh(args.mesh)
    overrides = {} if args.layers is None else {"n_layers": args.layers}
    spec = shapes_mod.input_specs(args.arch, args.shape, mesh,
                                  overrides=overrides)
    step = dryrun.build_step_fn(spec)
    if args.plain_loop:
        scan_step = step

        def step(*a):
            with layers.scan_override(None):
                return scan_step(*a)
    layers.REGION_TRACE = []
    t0 = time.time()
    _, _, cm = dryrun._run(step, spec["args"], mesh)
    trace_s = time.time() - t0
    regions = sorted({(name, tuple(sorted(info.items())))
                      for name, info in layers.REGION_TRACE})
    layers.REGION_TRACE = None
    print(json.dumps({
        "arch": args.arch, "shape": args.shape, "mesh": mesh_name,
        "n_layers": spec["cfg"].n_layers, "plain_loop": args.plain_loop,
        "trace_s": trace_s, "flops": cm.cost.flops,
        "bytes": cm.cost.bytes,
        "collective_bytes": dict(cm.collective_bytes),
        "flops_by_site": dict(flops.most_common(args.top)),
        "collective_bytes_by_issuer": dict(coll.most_common()),
        "collective_counts_by_issuer": dict(calls.most_common()),
        "regions": [[name, dict(info)] for name, info in regions]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
