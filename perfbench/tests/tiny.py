"""A tiny cell for the benchmark's CPU tests, written as new files into a
scratch directory, and a harness run of it on the CPU."""
from __future__ import annotations

import json
import shutil
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

TINY_CONFIG = {
    "name": "tiny",
    "source": "https://archive.ics.uci.edu/dataset/31/covertype",
    "rows": 500, "heldout_rows": 200,
    "data": {"generator": "covtype_like", "features": 6, "classes": 3,
             "n_modes": 2, "label_noise": 0.08, "mixture_rows": 2000,
             "mixture_seed": 0, "rows_seed": 1,
             "class_counts": [50, 35, 15], "sets": [0, 1, 2, 3]},
    "settings": {"scenario": "ova", "solver": "hinge",
                 "cell_method": "recursive", "cell_size": 200, "n_folds": 3,
                 "grid_choice": 0, "weights": [1.0], "tol": 0.001,
                 "max_iters": 100, "cd_polish": 2, "n_slots_per_wave": 4,
                 "seed": 0},
}
TINY_TRAFFIC = {"overrides": {}}
# set from CPU readings of this tiny cell, seeds 1-6: the program's numbers
# read at most 1.7e-6 / 1.6e-6 (cv, decisions), the control's at least
# 8.8e-3 / 5.0e-4; with the least-squares solver at most 2.7e-6 / 5.1e-7
# (program) and at least 6.7e-4 / 2.9e-4 (control)
TINY_LIMITS = {"stage_faults": 0, "select_faults": 0, "cv_gap": 1e-4,
               "decision_gap": 3e-5}
TINY_LIMITS_LS = dict(TINY_LIMITS, cv_gap=3e-5)


def write_cell(base: Path, name: str = "tiny", traffic: str = "fit",
               config: dict = None, limits: dict = None) -> dict:
    """Write a cell's files under ``base`` (configs/, traffic/, limits/,
    metrics/ with the benchmark's readers) and return its spec."""
    for sub in ("configs", "traffic", "limits", "metrics"):
        (base / sub).mkdir(parents=True, exist_ok=True)
    cfg = dict(config or TINY_CONFIG, name=name)
    (base / "configs" / f"{name}.json").write_text(json.dumps(cfg))
    (base / "traffic" / f"{traffic}.json").write_text(json.dumps(TINY_TRAFFIC))
    workload = f"{name}.{traffic}"
    if limits is None:
        limits = (TINY_LIMITS_LS if cfg["settings"]["solver"] == "ls"
                  else TINY_LIMITS)
    (base / "limits" / f"{workload}.json").write_text(json.dumps(limits))
    for f in (ROOT / "perfbench" / "metrics").glob("*.py"):
        shutil.copy(f, base / "metrics" / f.name)
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["configs"] = [{"name": name, "source": cfg["source"],
                        "file": str(base / "configs" / f"{name}.json"),
                        "reduced": ["rows"], "why": "tiny"}]
    spec["workloads"] = [{"name": workload, "config": name,
                          "traffic": traffic, "chips": 1, "why": "tiny"}]
    for m in spec["per_layer"]:
        m.pop("workloads", None)
    return spec



def run(cell, seed: int = 123456789012, trace: bool = False,
        tmp: Path = Path(".")):
    """One harness run of ``cell`` on the CPU with a near-zero window."""
    import torch

    from perfbench import harness
    return harness.run_cell(cell, seed, 0.05, trace, torch.device("cpu"),
                            time.perf_counter(), tmp)
