#!/usr/bin/env python3
"""The sharded LM step on CPU ranks, with the port alone, under whatever
torch the host has.

    PYTHONPATH=src python3 scripts/mesh_cpu_ranks.py [--out FILE]

Runs the rank job of ``tests/test_torch_lm_mesh.py`` (``_lm_job``: 8 gloo
ranks on one host; one train step of each case of its ``STEPS`` in f32 on
a ``("data", "model")`` mesh, activations sharded: qwen3-moe on (4, 2)
and (2, 4), stablelm-1.6b with FSDP specs and recomputed periods at
vocabularies 503 and 512, gemma3-4b at vocabulary 1024 and with its 4
heads over 8 ranks (head groups of 2 ranks), llama4-maverick with 6 heads
over 4 ranks on (2, 4), jamba and rwkv6 on (4, 2); then
``Trainer(mesh=...)`` 3 steps on (4, 2) with a
checkpoint, restored and run 2 more steps on (2, 4) and on (4, 2)), and
holds it to the test's bounds against the port's own unsharded runs on
the same weights and batches: loss within 2e-4 and parameters within 5e-3
of the unsharded step, the gradient norm within 1e-5 relative, every rank
equal, every new parameter on its template's placements, the regions
that ran on local shards those the test expects, and no op of a layer's
forward with a DTensor operand (none planned by DTensor); the elastic run within 1e-4
of the same-mesh run; ``Trainer`` on the mesh within 2e-4 / 5e-3 of the
unsharded ``Trainer``.  The test also holds these runs against the JAX
package; this script imports no JAX, so it runs where only torch is
installed (a GPU host's torch may plan DTensor operations differently from
the one the CPU tests ran under).  Prints one JSON line with every
measured value and ``ok``; exits 1 unless every bound holds.
"""
from __future__ import annotations

import argparse
import json
import os
import platform
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tests"))

import torch  # noqa: E402

import test_torch_lm_mesh as lm_mesh  # noqa: E402
from repro_torch.data.tokens import TokenPipeline, TokenPipelineConfig  # noqa: E402
from repro_torch.launch.local import run_local  # noqa: E402
from repro_torch.models import layers, model as model_mod  # noqa: E402
from repro_torch.train.lm_trainer import (Trainer, TrainLoopConfig,  # noqa: E402
                                          make_train_step)
from repro_torch.train.optimizer import OptConfig, init_opt_state  # noqa: E402

WORLD = 8


def unsharded(ocfg):
    """The port's unsharded step of each arch of ``lm_mesh.STEPS`` on its
    seeded weights and batch 0: (rank job inputs, {arch: (loss, grad
    norm, params)})."""
    inputs, local = {}, {}
    for label, (arch, kw, _) in lm_mesh.STEPS.items():
        cfg = lm_mesh._cfg(arch, **kw)
        params = model_mod.init_params(cfg, torch.Generator().manual_seed(0))
        params_np = layers.tree_map(lambda t: t.numpy().copy(), params)
        batch = {k: v.numpy() for k, v in TokenPipeline(TokenPipelineConfig(
            vocab=cfg.vocab, seq_len=32, global_batch=lm_mesh.BATCH, seed=0)).batch(0)
            .items()}
        p, _, m = make_train_step(cfg, ocfg)(
            params, init_opt_state(params, ocfg),
            {k: torch.from_numpy(v) for k, v in batch.items()})
        local[label] = (float(m["loss"]), float(m["grad_norm"]),
                        lm_mesh._tree_np(p))
        inputs[label] = (params_np, batch)
    return inputs, local


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write the JSON line to this file")
    args = ap.parse_args()
    torch.set_num_threads(1)
    ocfg = OptConfig(**lm_mesh.LR)
    t0 = time.perf_counter()
    inputs, local = unsharded(ocfg)
    with tempfile.TemporaryDirectory() as root:
        outs = run_local(lm_mesh._lm_job, WORLD, inputs, root, timeout=900)
    rank_s = time.perf_counter() - t0
    res = {"torch": torch.__version__, "python": platform.python_version(),
           "ranks": WORLD, "backend": "gloo", "cpus": os.cpu_count()}
    ok = True
    for arch in sorted(lm_mesh.STEPS):
        loss, gnorm, params, placed, _, _ = outs[0][arch]
        d_loss = abs(loss - local[arch][0])
        worst = lm_mesh._worst(params, local[arch][2])
        d_norm = abs(gnorm - local[arch][1]) / local[arch][1]
        same = all(o[arch][0] == loss
                   and lm_mesh._worst(o[arch][2], params) == 0.0
                   for o in outs)
        every_placed = all(o[arch][3] for o in outs)
        regions = all(o[arch][4] == lm_mesh.expected_regions(arch)
                      for o in outs)
        planned = sorted({op for o in outs for op in o[arch][5]})
        res[arch] = {"mesh": list(lm_mesh.STEPS[arch][2]), "loss": loss,
                     "loss_diff": d_loss, "max_param_diff": worst,
                     "grad_norm_rel_diff": d_norm, "ranks_equal": same,
                     "placements": every_placed,
                     "regions": sorted(n for n, _ in outs[0][arch][4]),
                     "regions_as_expected": regions,
                     "dtensor_planned_ops": planned}
        ok &= (d_loss < 2e-4 and worst < 5e-3 and d_norm <= 1e-5 and same
               and every_placed and regions and not planned)
    e = outs[0]["elastic"]
    (le, pe), (ls, ps) = e["elastic"], e["same"]
    worst_e = lm_mesh._worst(pe, ps)
    res["elastic"] = {"meshes": [[4, 2], [2, 4]], "loss_diff":
                      abs(le[-1] - ls[-1]), "max_param_diff": worst_e}
    ok &= (len(le) == len(ls) == 2 and abs(le[-1] - ls[-1]) < 1e-4
           and worst_e < 1e-4)
    cfg = lm_mesh._cfg("stablelm-1.6b")
    pipe = TokenPipeline(TokenPipelineConfig(vocab=cfg.vocab, seq_len=16,
                                             global_batch=8, seed=0))
    run = Trainer(cfg, ocfg, TrainLoopConfig(
        total_steps=5, grad_accum=2, ckpt_every=100, log_every=1), pipe,
        device="cpu").run()
    losses = [h["loss"] for h in run["history"]]
    d3 = max(abs(a - b) for a, b in zip(e["first"][0], losses[:3]))
    d5 = max(abs(a - b) for a, b in zip(e["elastic"][0], losses[3:]))
    worst_t = lm_mesh._worst(e["elastic"][1], lm_mesh._tree_np(run["params"]))
    res["trainer_vs_unsharded"] = {"loss_diff_steps_0_2": d3,
                                   "loss_diff_steps_3_4": d5,
                                   "max_param_diff": worst_t}
    ok &= d3 < 2e-4 and d5 < 2e-4 and worst_t < 5e-3
    res["seconds"] = time.perf_counter() - t0
    res["rank_job_s"] = rank_s
    res["ok"] = bool(ok)
    line = json.dumps(res)
    print(line, flush=True)
    if args.out:
        Path(args.out).write_text(line + "\n")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
