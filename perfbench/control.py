"""The readings the limits are set from: the program's numbers over many
seeds and the control's (the reference in TF32 in the program's place).

    python3 -m perfbench.control --workload <name> --seeds 1 2 3 [--control]

For each seed: the cell's inputs and warm-up as a run makes them, one fit
of the window's first training set through the timed path, the program's
numbers, and with ``--control`` the control's numbers on the same inputs.
One JSON line per seed on standard output.  The benchmark's runs never run
the control.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(cell, seed: int, device, control: bool) -> dict:
    """{"seed", "program": {...}, "control": {...}?, "fit_s", "ref_s"}."""
    from perfbench import harness
    from perfbench.reference import judge

    inputs = harness.make_inputs(cell, seed)
    harness.warm_up(cell, inputs, device)
    t0 = time.perf_counter()
    tr, sel, dec = harness.fit_once(
        harness.trainer_config(harness.settings(cell)), inputs[1], device)
    fit_s = time.perf_counter() - t0
    rec = harness.FitRecord(rows=inputs[1].x.shape[0], wall_s=fit_s,
                            peak_bytes=0, spans=[], train=tr, select=sel,
                            dec=dec)
    case = harness.make_case(cell, inputs[1], rec)
    del rec, tr, sel
    slots = judge.sample_slots(case, seed)
    t0 = time.perf_counter()
    prog, ref = judge.program_readings(case, slots, device)
    out = {"seed": seed, "fit_s": fit_s, "ref_s": time.perf_counter() - t0,
           "slots": [int(v) for v in slots], "program": prog}
    if control:
        out["control"] = judge.control_readings(case, slots, device, ref)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", action="store_true")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))

    import torch

    from perfbench import harness
    cell = harness.load_cell(args.workload)
    device = torch.device("cuda")
    for seed in args.seeds:
        print(json.dumps(readings(cell, seed, device, args.control)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
