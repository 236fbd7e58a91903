"""Run one cell of the benchmark and print its result line.

    python3 -m perfbench.run --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  Exits non-zero, printing no result, without
a CUDA card (or with fewer cards than the cell asks for), when the program
cannot be imported, when a run loads JAX or the JAX package, or when any
step fails.  The numbers the check compared, each beside its limit, are the
last lines on standard error; the result is the last line on standard
output (``perfbench.harness.run_cell``).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path

T_PROCESS = time.perf_counter()
ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    # one process, few host threads; caches at fixed paths of the checkout
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "4"
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "extensions")
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import repro_torch  # noqa: F401  (the system under test)
    except ImportError as e:
        print(f"the program is not in this checkout: {e}", file=sys.stderr)
        return 1

    from perfbench import harness
    with open(ROOT / "BENCHMARK.json") as f:
        spec = json.load(f)
    cell = harness.load_cell(args.workload, spec)
    chips = {w["name"]: w["chips"] for w in spec["workloads"]}[args.workload]

    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 1
    torch.set_num_threads(4)
    out = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           torch.device("cuda", 0), T_PROCESS,
                           Path(tempfile.gettempdir()) / "perfbench")
    for name, row in out["checks"].items():
        print(f"{name} {row['value']!r} limit {row['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
