"""The benchmark's harness: finds a cell's configuration, traffic mix, limits
and per-layer metrics by name, makes the inputs from the seed, runs the
window of fits, checks the outputs and reduces spans, counters and the
device trace to metrics.

Data-driven: ``BENCHMARK.json`` names the cells and metrics; each
configuration is ``configs/<config>.json``, each traffic mix
``traffic/<traffic>.json``, each cell's limits ``limits/<workload>.json``
and each per-layer metric a reader ``metrics/<metric>.py`` (``UNIT``,
``LAYER``, ``SOURCE``, ``MOVES`` and ``read(ctx)``, which returns ``None``
where it finds nothing to read).  A new cell or metric is new files.

What a run does (``run_cell``), on the device it is given:

1. set-up: makes the inputs from the seed, warms every path up with one
   small fit at the cell's widths, and counts all of it, with the process
   start and the first run's kernel build, as ``setup_s``;
2. the window: fits back to back, each on its own training set; a fit
   starts while less than ``seconds`` have passed, and the fit in flight
   when they have runs to its end and counts.  ``train_rows_per_s`` is the
   rows of every fit over the time from the window's start to the end of its
   last fit;
3. the check: one fit of the window, drawn from the seed, judged against
   the plain reference (``perfbench.reference.judge``) once the program's
   device state is freed.

With ``trace`` on, the tracer's spans time every fit and the first fit of
the window runs under ``torch.profiler``; the per-layer readers take both.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# modules whose presence after the window means the run loaded the JAX
# package or JAX: top-level names, compared whole
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class PoolExhausted(RuntimeError):
    """The window needed more training sets than set-up made."""


@dataclasses.dataclass
class Cell:
    workload: str
    config: Dict
    traffic: Dict
    limits: Dict
    end_to_end: List[Dict]
    per_layer: Dict[str, object]     # metric name -> reader module


def _json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_metric(name: str, base: Path = BENCH):
    """The reader module ``metrics/<name>.py``."""
    path = base / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(workload: str, spec: Optional[Dict] = None,
              base: Path = BENCH) -> Cell:
    """A cell of ``spec`` (default: ``BENCHMARK.json``) and its files."""
    if spec is None:
        spec = _json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in the benchmark")
    w = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    cfg_file = Path(configs[w["config"]]["file"])
    config = _json(cfg_file if cfg_file.is_absolute()
                   else base.parent / cfg_file)

    def mine(m):
        return "workloads" not in m or workload in m["workloads"]

    per_layer = {}
    for m in spec["per_layer"]:
        if mine(m):
            mod = load_metric(m["name"], base)
            if mod.UNIT != m["unit"]:
                raise ValueError(f"metric {m['name']}: reader unit "
                                 f"{mod.UNIT!r}, benchmark {m['unit']!r}")
            per_layer[m["name"]] = mod
    return Cell(workload=workload, config=config,
                traffic=_json(base / "traffic" / f"{w['traffic']}.json"),
                limits=_json(base / "limits" / f"{workload}.json"),
                end_to_end=[m for m in spec["end_to_end"] if mine(m)],
                per_layer=per_layer)


# ------------------------------------------------------------------ inputs
@dataclasses.dataclass
class FitInput:
    x: np.ndarray          # (n, d) raw rows as the program gets them
    y: np.ndarray          # (n,) class ids (ova) or +-1 (binary)
    x_held: np.ndarray     # (m, d) held-out rows


def settings(cell: Cell) -> Dict:
    """The liquidSVM keys a fit runs with: the configuration's, then the
    traffic mix's overrides."""
    return {**cell.config["settings"], **cell.traffic.get("overrides", {})}


def make_inputs(cell: Cell, seed: int) -> List[FitInput]:
    """The warm-up set, then the window's training sets.

    The configuration's ``data`` block names its generator
    (``perfbench/data/<generator>.py``) and lists ``sets``: training sets of
    its data set, the rows of set ``j`` drawn from ``[rows_seed, j]``,
    chosen so that every one makes the same cells to within 0.5 % of their
    size: the same work.  From the seed: the order in which the window takes
    them, each set's label noise and held-out rows, and the warm-up set."""
    data = cell.config["data"]
    gen = importlib.import_module(f"perfbench.data.{data['generator']}")
    draw = gen.make_draw(data)
    n, m = cell.config["rows"], cell.config["heldout_rows"]

    def rng(*key):
        return np.random.default_rng(list(key))
    x, y = draw(n + m, rng(seed, 0), rng(seed, 1))
    out = [FitInput(x=x[:n], y=y[:n], x_held=x[n:])]
    for j in rng(seed, 2).permutation(data["sets"]):
        x, y = draw(n, rng(data["rows_seed"], int(j)), rng(seed, 3, int(j)))
        x_held, _ = draw(m, rng(seed, 4, int(j)), rng(seed, 5, int(j)))
        out.append(FitInput(x=x, y=y, x_held=x_held))
    return out


# -------------------------------------------------------------------- fits
@dataclasses.dataclass
class FitRecord:
    rows: int
    wall_s: float
    peak_bytes: int
    spans: List[Dict]
    train: object               # the program's TrainResult
    select: object              # its SelectResult
    dec: np.ndarray             # held-out decisions


def trainer_config(s: Dict, **override):
    from repro_torch.train.svm_trainer import SVMTrainerConfig
    keys = {f.name for f in dataclasses.fields(SVMTrainerConfig)}
    kw = {k: (tuple(v) if isinstance(v, list) else v)
          for k, v in s.items() if k in keys}
    kw.update(override)
    return SVMTrainerConfig(**kw)


def fit_once(cfg, inp: FitInput, device) -> tuple:
    """The timed path: the public fit (``SVM.train`` then ``select``) and
    the held-out decisions of the selected models."""
    from repro_torch.api.session import SVM
    sess = SVM(inp.x, inp.y, config=cfg, device=device)
    tr = sess.train()
    sel = sess.select("argmin")
    dec = sel.decision_function(inp.x_held)
    return tr, sel, dec


def warm_up(cell: Cell, inputs: List[FitInput], device) -> None:
    """One fit of the warm-up set's first 3 x ``cell_size`` rows (a few
    cells) at the cell's widths, its box QPs capped at 20 iterations: every
    path and kernel of the window built and loaded, at a fraction of a
    fit's time."""
    s = settings(cell)
    n = 3 * s["cell_size"]
    w = inputs[0]
    fit_once(trainer_config(s, max_iters=min(20, s["max_iters"])),
             FitInput(x=w.x[:n], y=w.y[:n], x_held=w.x_held[:256]), device)


def _spans() -> List[Dict]:
    from repro_torch import obs
    out = [{"name": s.name, "dur_s": s.dur_s, "depth": s.depth,
            "device_ms": s.elapsed_ms if s.events is not None else None,
            "attrs": dict(s.attrs or {})} for s in obs.tracer.spans]
    obs.tracer.clear()
    return out


def run_window(cell: Cell, inputs: List[FitInput], seconds: float, device,
               trace: bool) -> tuple:
    """Fits back to back for ``seconds``; returns (records, window seconds,
    the profiler or None).  With ``trace`` on a card, the first fit runs
    under the profiler (host ops with their shapes, and the card's
    activity), and at least one more runs without it for the spans; the
    profiler is reduced once the window has closed."""
    import torch

    from perfbench import trace as trace_mod
    from repro_torch import obs

    cuda = device.type == "cuda"
    profile = trace and cuda

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    cfg = trainer_config(settings(cell))
    obs.tracer.clear()
    obs.tracer.enabled = trace
    records, prof = [], None
    sync()
    t_start = time.perf_counter()
    i = 0
    while (not records or (profile and len(records) < 2)
           or time.perf_counter() - t_start < seconds):
        i += 1
        if i >= len(inputs):
            raise PoolExhausted(f"the window used all {len(inputs) - 1} "
                                f"training sets")
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        if profile and not records:
            out, prof, wall = trace_mod.capture(
                lambda: fit_once(cfg, inputs[i], device))
        else:
            t0 = time.perf_counter()
            out = fit_once(cfg, inputs[i], device)
            sync()
            wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        records.append(FitRecord(rows=inputs[i].x.shape[0], wall_s=wall,
                                 peak_bytes=int(peak),
                                 spans=_spans() if trace else [],
                                 train=out[0], select=out[1], dec=out[2]))
    window_s = time.perf_counter() - t_start
    obs.tracer.enabled = False
    return records, window_s, prof


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({name for name in list(sys.modules)
                   if name.split(".")[0] in FORBIDDEN})


def make_case(cell: Cell, inp: FitInput, rec: FitRecord):
    """The judge's view of one fit."""
    from perfbench.reference.judge import Case
    tr, sel = rec.train, rec.select
    return Case(
        x=inp.x, y=inp.y, x_held=inp.x_held, settings=settings(cell),
        indices=tr.plan.indices, mask=tr.plan.mask, centers=tr.plan.centers,
        order=np.asarray(tr.packed.order),
        slot_of_cell=np.asarray(tr.packed.slot_of_cell),
        x_cells=tr.x_cells, mask_cells=tr.mask_cells, y_cells=tr.y_cells,
        tmask_cells=tr.tmask_cells, gammas_cells=tr.gammas_cells,
        lambdas=tr.lambdas, surface=tr.surf_loss, gamma=sel.gamma,
        lam=sel.lam, val_loss=sel.val_loss, coefs=sel.coefs, dec=rec.dec)


def fit_stats(cell: Cell, rec: FitRecord, inp: FitInput) -> Dict:
    """Sizes and counts of one fit, as the readers and the yardstick take
    them."""
    tr = rec.train
    live = tr.mask_cells.sum(-1)
    xs = tr.scaler.transform(inp.x_held)
    d2 = ((xs[:, None, :] - tr.plan.centers[None]) ** 2).sum(-1)
    slot = np.asarray(tr.packed.slot_of_cell)[d2.argmin(1)]
    held = np.bincount(slot, minlength=live.shape[0])
    t_cnt, l_cnt = tr.tasks.n_tasks, tr.lambdas.shape[0]
    sub = tr.gamma.shape[-1]
    return {"rows": rec.rows, "wall_s": rec.wall_s,
            "peak_bytes": rec.peak_bytes, "spans": rec.spans,
            "live": live, "held": held, "d": tr.x_cells.shape[-1],
            "k": tr.x_cells.shape[1], "G": tr.gammas_cells.shape[1],
            "F": tr.cv_cfg.n_folds, "P": t_cnt * l_cnt * sub,
            "Pt": t_cnt * sub, "cd_polish": tr.cv_cfg.cd_polish,
            "solver": tr.cv_cfg.solver, "iters": tr.iters,
            "slots_per_wave": tr.config.n_slots_per_wave or live.shape[0]}


@dataclasses.dataclass
class Context:
    """What a per-layer reader reads: ``fits`` (``fit_stats`` of each fit
    of the window), ``profiled`` (indices of the fits under the profiler),
    ``trace`` (the ``perfbench.trace.Trace`` of the first of them, or
    None)."""
    fits: List[Dict]
    profiled: List[int]
    trace: object

    def span_fits(self) -> List[Dict]:
        """The fits whose spans and wall times a reader should take: those
        not under the profiler, or all where every fit was."""
        rest = [f for i, f in enumerate(self.fits) if i not in self.profiled]
        return rest or self.fits

    def ms_per_wave(self, names) -> Optional[float]:
        """Device milliseconds of the spans ``names`` per ``train.wave``
        (over :meth:`span_fits`), or None without waves."""
        ms, waves = 0.0, 0
        for f in self.span_fits():
            for s in f["spans"]:
                if s["name"] == "train.wave":
                    waves += 1
                elif s["name"] in names and s["device_ms"] is not None:
                    ms += s["device_ms"]
        return ms / waves if waves else None


def power_limit() -> Optional[str]:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip() or None


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_process: float, workdir: Path) -> Dict:
    """One run of a cell: the result line's object (see the module
    docstring)."""
    import torch

    from perfbench.reference import judge

    cuda = device.type == "cuda"
    inputs = make_inputs(cell, seed)
    warm_up(cell, inputs, device)
    if cuda:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_process

    records, window_s, prof = run_window(cell, inputs, seconds, device,
                                         trace)
    rows = sum(r.rows for r in records)
    mem_peak = max(r.peak_bytes for r in records)

    pick = int(np.random.default_rng([seed, 2]).integers(len(records)))
    case = make_case(cell, inputs[pick + 1], records[pick])
    stats = [fit_stats(cell, r, inputs[i + 1]) for i, r in enumerate(records)]
    del records
    if cuda:
        torch.cuda.empty_cache()
    slots = judge.sample_slots(case, seed)
    readings, _ = judge.program_readings(case, slots, device)
    correct, checks = judge.compare(readings, cell.limits)

    dev_trace = None
    if prof is not None:
        from perfbench import trace as trace_mod
        dev_trace = trace_mod.reduce(prof, str(workdir))
        del prof
    if trace:
        ctx = Context(fits=stats, profiled=[0] if dev_trace else [],
                      trace=dev_trace)
        metrics = {}
        for name, mod in cell.per_layer.items():
            v = mod.read(ctx)
            if v is not None:
                metrics[name] = {"value": float(v), "unit": mod.UNIT}
    else:
        metrics = {"train_rows_per_s": {"value": rows / window_s,
                                        "unit": "rows/s"},
                   "setup_s": {"value": setup_s, "unit": "s"}}
        metrics = {m["name"]: metrics[m["name"]] for m in cell.end_to_end}
    dev_info = {"platform": "gpu" if cuda else "cpu",
                "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                "count": 1, "memory_peak_bytes": int(mem_peak),
                "power_limit": power_limit() if cuda else None}
    out = {"correct": bool(correct), "attempted": len(stats),
           "failed": 0 if correct else 1, "metrics": metrics,
           "device": dev_info,
           "window": {"fits": len(stats), "rows": rows, "seconds": window_s,
                      "setup_s": setup_s, "checked_fit": pick,
                      "cells_k": [[int(f["live"].shape[0]), int(f["k"])]
                                  for f in stats],
                      "checked_slots": [int(v) for v in slots]}}
    if trace and dev_trace is not None:
        dev_info["busy_s"] = dev_trace.busy_s
        dev_info["window_s"] = dev_trace.window_s
        out["breakdown"] = breakdown(dev_trace)
    out["checks"] = checks
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"the run loaded {', '.join(found)}")
    return out


def breakdown(tr) -> Dict:
    """The device ops that took most time and the longest idle stretches by
    what the host was doing, ten of each."""
    ops: Dict[str, float] = {}
    for name, _, sec in tr.kernels:
        ops[name] = ops.get(name, 0.0) + sec
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(tr.gaps.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v] for k, v in top],
            "idle_gaps": [[k, v] for k, v in gaps]}
