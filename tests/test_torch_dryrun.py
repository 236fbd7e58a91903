"""The port's production-mesh dry run (``repro_torch.launch.dryrun``),
in subprocesses: each joins a fake process group of 256 ranks (the
single-pod (16, 16) mesh), which must not meet the test process's.

* one full-config cell through the command line: stablelm-1.6b
  ``decode_32k`` (the fastest cell, ~5 s of tracing on one core), with the
  reference's result keys less those without a counterpart (the XLA
  ``*_body_once`` counts, ``memory_analysis``'s temp and code bytes,
  ``lower_s``/``compile_s``: ``trace_s`` instead);
* ``--variant kv8`` reads fewer bytes than the baseline on that cell,
  and neither gathers a cache leaf (flash-decoding: the same gathers for
  both cache dtypes, fewer bytes than one layer's k cache gathered);
* ``dryrun_svm`` at (16, 16), at a short solve: rank 0's FLOPs equal the
  one-device cost of its two slots, and its gathers move the wave's
  outputs (every rank's blocks, along 'model' and then 'data');
* gemma3-4b ``prefill_32k`` through ``scripts/dryrun_breakdown.py``
  (~8 s of tracing): its 8 heads over the 16 'model' ranks run by head
  group (8 groups of 2 ranks, each rank one head on one of its group's 2
  rows), with no ``run_on_rows``, no collective of DTensor's
  redistributions and under 1e14 FLOPs a device (6.9e14 when every rank
  ran every head on its rows).
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("torch.distributed")

ROOT = Path(__file__).resolve().parents[1]
ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")

# the reference's result keys, less the compiled program's
KEYS = {"arch", "shape", "mesh", "kind", "variant", "n_devices", "flops",
        "bytes_accessed", "collective_bytes", "collective_counts", "memory",
        "trace_s"}
COLLECTIVES = {"all_gather_into_tensor", "reduce_scatter_tensor",
               "all_reduce", "all_to_all_single"}


def _python(args, timeout=300):
    out = subprocess.run([sys.executable] + args, env=ENV, cwd=ROOT,
                         capture_output=True, text=True, timeout=timeout)
    assert out.returncode == 0, out.stderr[-4000:]
    return out.stdout


@pytest.fixture(scope="module")
def decode_cells(tmp_path_factory):
    path = tmp_path_factory.mktemp("dryrun") / "cells.jsonl"
    logs = {}
    for variant in ("baseline", "kv8"):
        logs[variant] = _python(
            ["-m", "repro_torch.launch.dryrun", "--arch", "stablelm-1.6b",
             "--shape", "decode_32k", "--mesh", "single", "--variant",
             variant, "--out", str(path)])
    rows = [json.loads(line) for line in path.read_text().splitlines()]
    return {r["variant"]: r for r in rows}, logs


def test_full_config_cell(decode_cells):
    rows, logs = decode_cells
    r = rows["baseline"]
    assert "1 cells OK, 0 failed" in logs["baseline"]
    assert set(r) == KEYS
    assert (r["arch"], r["shape"], r["mesh"], r["kind"]) == (
        "stablelm-1.6b", "decode_32k", "single_pod_16x16", "decode")
    assert r["n_devices"] == 256
    assert set(r["memory"]) == {"argument_bytes", "output_bytes"}
    # the arguments are charged once among the bytes
    assert 0 < r["memory"]["argument_bytes"] < r["bytes_accessed"]
    assert r["flops"] > 0
    assert set(r["collective_bytes"]) == set(r["collective_counts"])
    assert set(r["collective_bytes"]) <= COLLECTIVES
    # the new token's q, k, v of every head gathered over 'model' (the
    # cache split over the sequence stays where it is: flash-decoding)
    assert r["collective_bytes"]["all_gather_into_tensor"] > 0


def test_kv8_reads_fewer_bytes(decode_cells):
    rows, _ = decode_cells
    base, kv8 = rows["baseline"], rows["kv8"]
    assert kv8["variant"] == "kv8"
    assert kv8["bytes_accessed"] < base["bytes_accessed"]
    # no cache leaf is gathered, in either dtype: the gathers do not
    # depend on the cache's, and move fewer bytes than one layer's k
    # cache of a rank's 8 rows gathered over the sequence (32768 x 32
    # heads x 64, bf16)
    gathered = "all_gather_into_tensor"
    assert (kv8["collective_bytes"][gathered]
            == base["collective_bytes"][gathered])
    assert base["collective_bytes"][gathered] < 8 * 32768 * 32 * 64 * 2


SVM_SCRIPT = r"""
import json
from repro_torch.launch import dryrun
from repro_torch.launch.op_cost import run_counted
K, D, IT, PER = 96, 8, 20, 2
name, mesh = dryrun.production_mesh("single")
r = dryrun.dryrun_svm(mesh, name, slots_per_dev=PER, k=K, d=D,
                      max_iters=IT, verbose=False)
fn, args, cfg = dryrun.svm_wave(PER, K, D, None, IT)
out, cm = run_counted(fn, *args, while_trips=IT)
per_slot = sum(o.numel() * o.element_size() for o in out) / PER
print(json.dumps({"mesh": r, "one_flops": cm.cost.flops,
                  "one_guessed": cm.cost.guessed_whiles,
                  "per_slot_bytes": per_slot, "n_outputs": len(out)}))
"""


def test_dryrun_svm_rank0_is_its_slots():
    got = json.loads(_python(["-c", SVM_SCRIPT]).strip().splitlines()[-1])
    r = got["mesh"]
    assert r["n_devices"] == 256 and r["kind"] == "svm_train"
    assert r["guessed_whiles"] >= 1 == got["one_guessed"]
    # rank 0 solves its two slots exactly as one device does
    assert r["flops"] == got["one_flops"]
    # each output gathered along 'model' (16 blocks of 2 slots) and then
    # 'data' (16 blocks of 32): 32 + 512 slots moved per output
    moved = got["per_slot_bytes"] * (2 * 16 + 2 * 16 * 16)
    assert r["collective_bytes"] == {"all_gather_into_tensor": moved}
    assert r["collective_counts"] == {
        "all_gather_into_tensor": 2 * got["n_outputs"]}


def test_uneven_heads_prefill_by_head_group():
    out = _python(["scripts/dryrun_breakdown.py", "--arch", "gemma3-4b",
                   "--shape", "prefill_32k"])
    r = json.loads(out.strip().splitlines()[-1])
    regions = {name: info for name, info in r["regions"]}
    assert regions["attention"] == {"heads": 1, "kv_heads": 1, "rows": 1}
    assert "run_on_rows" not in regions
    assert not any(k.startswith("dtensor:redistribute")
                   for k in r["collective_bytes_by_issuer"])
    assert r["flops"] < 1.0e14
