"""Production-mesh dry run: every (arch x shape) cell's step built on the
production mesh, on fake tensors, with its per-device roofline terms
(FLOPs, bytes, collective bytes) counted from the ops rank 0 runs (the
JAX package's ``launch/dryrun.py``).

The reference forces 512 host devices and compiles an XLA program.  Here
one process joins a *fake* process group (``torch.testing._internal.
distributed.fake_pg``: backend ``"fake"``, world 256 or 512, rank 0,
collectives that move nothing), builds ``make_production_mesh(...,
device_type="cpu")``, turns the cell's structs (``launch.shapes``) into
fake DTensors (``FakeTensorMode``: shapes, no storage) and runs the step
once under ``launch.op_cost.CostMode``.  Every kernel wrapper takes its
plain version there, since the tensors are (fake) CPU tensors.

It MUST run as its own process: the fake process group is the default
group of the process and must not meet a real one.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch stablelm-1.6b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh single --out results.jsonl
  PYTHONPATH=src python -m repro_torch.launch.dryrun --svm
"""
from __future__ import annotations

import argparse
import functools
import json
import sys
import time
import traceback
from typing import Any, Dict

VARIANTS: Dict[str, Dict[str, Any]] = {
    "baseline": {},
    "kv8": {"kv_cache_dtype": "int8"},
    "moe_gather": {"moe_impl": "gather"},
    "moe_gather_cap1": {"moe_impl": "gather", "moe_capacity_factor": 1.0},
    "moe_bigchunk": {"moe_impl": "gather", "moe_capacity_factor": 1.0,
                     "moe_chunk": 8192},
    "noactshard": {"shard_activations": False},
    "noactshard_accum4": {"shard_activations": False, "grad_accum": 4},
}

MESHES = {"single": ("single_pod_16x16", False),
          "multi": ("multi_pod_2x16x16", True)}


def join_fake_group(world: int) -> None:
    """Make this process rank 0 of a fake process group of ``world``
    ranks (collectives are no-ops)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == world and dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def production_mesh(which: str):
    """(name, mesh) of the production mesh ``single`` or ``multi`` over a
    fake group of its size, on CPU devices."""
    from repro_torch.launch.mesh import make_production_mesh
    name, multi = MESHES[which]
    join_fake_group(512 if multi else 256)
    return name, make_production_mesh(multi_pod=multi, device_type="cpu")


def materialize(args, mesh):
    """The structs of ``args`` as fake tensors (call under a
    ``FakeTensorMode``): parameter, batch and cache structs as DTensors
    with their placements, the optimizer's step counter as the plain
    host scalar ``init_opt_state`` makes; other leaves as they are."""
    import torch
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.launch.shapes import Struct
    from repro_torch.train.optimizer import OptState

    def one(x):
        if isinstance(x, Struct):
            return distribute_tensor(
                torch.empty(x.shape, dtype=x.dtype), mesh, x.placements,
                src_data_rank=None)
        if isinstance(x, OptState):
            return OptState(step=torch.zeros((), dtype=torch.int32),
                            master=tree(x.master), m=tree(x.m), v=tree(x.v))
        if isinstance(x, dict):
            return tree(x)
        if isinstance(x, tuple):
            return tuple(one(v) for v in x)
        return x

    def tree(d):
        return {k: one(v) for k, v in d.items()}

    return one(tuple(args))


def build_step_fn(spec: Dict[str, Any]):
    from repro_torch.models import model as model_mod
    from repro_torch.train.lm_trainer import make_train_step
    cfg = spec["cfg"]
    kind = spec["kind"]
    if kind == "train":
        return make_train_step(cfg, spec["opt_cfg"], spec["grad_accum"])
    if kind == "prefill":
        return functools.partial(model_mod.prefill, cfg)
    if kind == "encode":
        return functools.partial(model_mod.encode, cfg)
    if kind == "decode":
        return functools.partial(model_mod.decode_step, cfg)
    raise ValueError(kind)


def _run(fn, args, mesh, while_trips: float = 1.0):
    """``fn`` over the materialized ``args`` under ``CostMode`` on fake
    tensors -> (args, output, mode)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.launch.op_cost import run_counted
    with FakeTensorMode(allow_non_fake_inputs=True):
        args = materialize(args, mesh)
        out, cm = run_counted(fn, *args, while_trips=while_trips)
    return args, out, cm


def _terms(cm, args, out) -> Dict[str, Any]:
    from repro_torch.launch.op_cost import argument_bytes
    return {
        "flops": cm.cost.flops,
        "bytes_accessed": cm.cost.bytes,
        "collective_bytes": dict(cm.collective_bytes),
        "collective_counts": dict(cm.collective_counts),
        "memory": {"argument_bytes": argument_bytes(*args),
                   "output_bytes": argument_bytes(out)},
    }


def dryrun_cell(arch_id: str, shape_name: str, mesh, mesh_name: str,
                verbose: bool = True, variant: str = "baseline"
                ) -> Dict[str, Any]:
    from repro_torch.launch import shapes as shapes_mod
    t0 = time.time()
    spec = shapes_mod.input_specs(arch_id, shape_name, mesh,
                                  overrides=VARIANTS[variant])
    args, out, cm = _run(build_step_fn(spec), spec["args"], mesh)
    result = {
        "arch": arch_id,
        "shape": shape_name,
        "mesh": mesh_name,
        "kind": spec["kind"],
        "variant": variant,
        "n_devices": mesh.size(),
        **_terms(cm, args, out),
        "trace_s": round(time.time() - t0, 1),
    }
    if verbose:
        print(f"[dryrun] {arch_id} x {shape_name} x {mesh_name}: "
              f"flops/dev={result['flops']:.3e} "
              f"bytes/dev={result['bytes_accessed']:.3e} "
              f"coll/dev={sum(result['collective_bytes'].values()):.3e} "
              f"(trace {result['trace_s']:.0f}s)", flush=True)
        print(f"  memory: {result['memory']}", flush=True)
    return result


def svm_wave(n_slots: int, k: int, d: int, mesh=None, max_iters: int = 500,
             shared_lipschitz: bool = True, gram_dtype: str = "f32"):
    """(fn, args, cfg): one wave of the cell trainer, ``n_slots`` padded
    cells of k samples in d dims, the 10 x 10 grid x 5 folds each, as a
    function of meta stand-ins for its x, y, tmask, mask and per-slot
    gammas (plain tensors: every rank holds the whole wave and solves its
    block of the slots, split over every dim of ``mesh``)."""
    import numpy as np
    import torch
    from repro_torch.core import cv as cv_mod
    from repro_torch.core.grids import liquid_grid
    from repro_torch.distributed.cell_trainer import train_cells
    cfg = cv_mod.CVConfig(n_folds=5, max_iters=max_iters,
                          shared_lipschitz=shared_lipschitz,
                          gram_dtype=gram_dtype)
    grid = liquid_grid(n=k, dim=d)
    lam_c, sub_c, task_c, n_lam, n_sub = cv_mod.grid_columns(grid, cfg, 1)
    axes = None if mesh is None else tuple(mesh.mesh_dim_names)
    keys = np.stack([np.arange(n_slots), np.zeros(n_slots)],
                    1).astype(np.uint32)
    args = tuple(torch.empty(s, dtype=torch.float32, device="meta") for s in (
        (n_slots, k, d), (n_slots, 1, k), (n_slots, 1, k), (n_slots, k),
        (n_slots, len(grid.gammas))))

    def fn(*a):
        return train_cells(*a, keys, lam_c, sub_c, task_c, cfg, n_lam, n_sub,
                           mesh=mesh, axis_names=axes)
    return fn, args, cfg


def dryrun_svm(mesh, mesh_name: str, slots_per_dev: int = 2, k: int = 2000,
               d: int = 128, verbose: bool = True,
               shared_lipschitz: bool = True, gram_dtype: str = "f32",
               max_iters: int = 500) -> Dict[str, Any]:
    """Roofline the paper's own technique: the sharded cell-CV trainer
    (:func:`svm_wave` with ``slots_per_dev`` slots a device).  Each FISTA
    loop runs ``max_iters`` iterations (the reference's ``while_trips``).
    shared_lipschitz=False is the paper-faithful baseline (per-fold
    Lipschitz estimates); True + gram_dtype="bf16" the optimized
    variants."""
    t0 = time.time()
    n_dev = mesh.size()
    fn, args, cfg = svm_wave(n_dev * slots_per_dev, k, d, mesh, max_iters,
                             shared_lipschitz, gram_dtype)
    args, out, cm = _run(fn, args, mesh, while_trips=float(cfg.max_iters))
    variant = ("sharedL" if shared_lipschitz else "baseline") + \
        ("_bf16gram" if gram_dtype == "bf16" else "")
    result = {
        "arch": "svm-cell-trainer", "shape": f"cells_k{k}_d{d}_{variant}",
        "mesh": mesh_name, "kind": "svm_train", "n_devices": n_dev,
        "while_trips_assumed": cfg.max_iters,
        "guessed_whiles": cm.cost.guessed_whiles,
        **_terms(cm, args, out),
        "trace_s": round(time.time() - t0, 1),
    }
    if verbose:
        print(f"[dryrun] svm-cell-trainer x {mesh_name}: "
              f"flops={result['flops']:.3e} "
              f"bytes={result['bytes_accessed']:.3e} "
              f"coll={sum(result['collective_bytes'].values()):.3e}",
              flush=True)
    return result


class CellTimeout(Exception):
    pass


def _alarm(seconds) -> None:
    """Raise :class:`CellTimeout` in this (main) thread after
    ``seconds``; ``None`` cancels."""
    import signal

    def expire(signum, frame):
        raise CellTimeout(f"cell cut after {seconds} s of tracing")
    if seconds is None:
        signal.setitimer(signal.ITIMER_REAL, 0)
        return
    signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, float(seconds))


def main(argv=None) -> int:
    from repro_torch.configs import ARCH_IDS, all_cells
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=list(ARCH_IDS))
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--svm", action="store_true",
                    help="also dry-run the SVM cell trainer workload")
    ap.add_argument("--variant", default="baseline", choices=list(VARIANTS),
                    help="ModelConfig perf-variant overrides")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default=None,
                    help="append JSON-lines results here")
    ap.add_argument("--cell-timeout", type=float, default=None,
                    help="seconds a cell may trace before it counts as "
                         "failed (default: no limit)")
    args = ap.parse_args(argv)

    which = ("single", "multi") if args.mesh == "both" else (args.mesh,)
    cells = all_cells() if args.all else (
        [(args.arch, args.shape)] if args.arch else [])
    failures = []
    results = []
    for m in which:
        # one fake group at a time: the multi-pod mesh's replaces the
        # single pod's
        mesh_name, mesh = production_mesh(m)
        jobs = [("svm-cell-trainer", "cells", dict(shared_lipschitz=shared,
                                                   gram_dtype=gdt))
                for shared, gdt in ((False, "f32"), (True, "f32"),
                                    (True, "bf16")) if args.svm]
        jobs += [(a, s, None) for a, s in cells]
        for arch_id, shape_name, svm_kw in jobs:
            try:
                _alarm(args.cell_timeout)
                if svm_kw is not None:
                    r = dryrun_svm(mesh, mesh_name, **svm_kw)
                else:
                    r = dryrun_cell(arch_id, shape_name, mesh, mesh_name,
                                    variant=args.variant)
                results.append(r)
                if args.out:
                    with open(args.out, "a") as f:
                        f.write(json.dumps(r) + "\n")
            except Exception as e:  # noqa: BLE001 - report every failure
                traceback.print_exc()
                failures.append((arch_id, shape_name, mesh_name, repr(e)))
            finally:
                _alarm(None)

    print(f"\n[dryrun] {len(results)} cells OK, {len(failures)} failed")
    for f in failures:
        print("  FAIL:", f)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
