"""The harness on the CPU: cells, mixes and metrics found by name as new
files, the result line, the import guard and the CLI's refusal without a
card."""
from __future__ import annotations

import json
import sys
import types

import numpy as np
import pytest

from perfbench import harness
from perfbench.tests.tiny import ROOT, TINY_CONFIG, run, write_cell


def test_benchmark_json_names_existing_files():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in spec["workloads"]:
        cell = harness.load_cell(w["name"], spec)
        assert cell.per_layer and cell.end_to_end
        for m in spec["per_layer"]:
            mod = harness.load_metric(m["name"])
            assert (mod.UNIT, mod.LAYER, mod.SOURCE, mod.MOVES) == (
                m["unit"], m["layer"], m["source"], m["moves"])


def test_new_config_mix_and_metric_as_files_alone(tmp_path):
    """A configuration, a traffic mix and a per-layer metric dropped in as
    new files run with no other file edited."""
    spec = write_cell(tmp_path, name="tiny2", traffic="fit2",
                      config=dict(TINY_CONFIG, rows=400))
    (tmp_path / "metrics" / "fits_in_window.py").write_text(
        'UNIT = "count"\nLAYER = "whole fit"\nSOURCE = "program_counter"\n'
        'MOVES = "train_rows_per_s"\n\n\ndef read(ctx):\n'
        '    return len(ctx.fits)\n')
    spec["per_layer"].append({"name": "fits_in_window", "unit": "count",
                              "better": "higher", "source": "program_counter",
                              "layer": "whole fit",
                              "moves": "train_rows_per_s"})
    cell = harness.load_cell("tiny2.fit2", spec, tmp_path)
    out = run(cell, trace=True, tmp=tmp_path)
    assert out["correct"], out["checks"]
    assert out["metrics"]["fits_in_window"]["value"] == out["attempted"] >= 1
    assert out["window"]["rows"] == 400 * out["attempted"]


def test_result_line(tiny_cell, tmp_path):
    out = run(tiny_cell, tmp=tmp_path)
    assert list(out)[-1] == "checks"
    assert set(out["metrics"]) == {"train_rows_per_s", "setup_s"}
    assert out["metrics"]["train_rows_per_s"]["value"] > 0
    assert out["correct"] and out["failed"] == 0, out["checks"]
    for row in out["checks"].values():
        assert set(row) == {"value", "limit"}
    json.dumps(out)


def test_window_fails_when_sets_run_out(tiny_cell, tmp_path):
    import time

    import torch
    tiny_cell.config["data"]["sets"] = [0]
    with pytest.raises(harness.PoolExhausted):
        harness.run_cell(tiny_cell, 5, 60.0, False, torch.device("cpu"),
                         time.perf_counter(), tmp_path)


def test_inputs_from_seed(tiny_cell):
    a = harness.make_inputs(tiny_cell, 2 ** 33 + 7)
    b = harness.make_inputs(tiny_cell, 2 ** 33 + 7)
    c = harness.make_inputs(tiny_cell, 2 ** 33 + 8)
    assert all((p.x == q.x).all() and (p.y == q.y).all()
               and (p.x_held == q.x_held).all() for p, q in zip(a, b))
    assert len(a) == len(tiny_cell.config["data"]["sets"]) + 1
    # another seed: other labels, held-out rows and warm-up rows, the same
    # training sets in another order
    assert not (a[0].x == c[0].x).all()
    assert not (a[1].x_held == c[1].x_held).all()
    rows = [{r.tobytes() for r in f.x} for f in a[1:]]
    assert sorted(map(sorted, rows)) == sorted(
        sorted({r.tobytes() for r in f.x}) for f in c[1:])
    # no fit sees rows another fit saw
    for i, first in enumerate(rows):
        assert not any(first & other for other in rows[i + 1:])


def test_class_sizes_follow_the_published_counts():
    from perfbench.data import covtype_like
    counts = [211840, 283301, 35754, 2747, 9493, 17367, 20510]
    sizes = covtype_like.class_sizes(17000, counts)
    assert sizes.sum() == 17000
    np.testing.assert_allclose(sizes / 17000, np.array(counts) / 581012,
                               atol=1 / 17000)
    draw = covtype_like.make_draw(dict(TINY_CONFIG["data"],
                                       class_counts=[50, 35, 15],
                                       label_noise=0.0))
    _, y = draw(200, np.random.default_rng(1), np.random.default_rng(2))
    assert np.bincount(y).tolist() == [100, 70, 30]


def test_import_guard_compares_whole_top_level_names(monkeypatch):
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro_torch_extra",
                        types.ModuleType("repro_torch_extra"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.core",
                        types.ModuleType("repro.core"))
    monkeypatch.setitem(sys.modules, "jax.numpy",
                        types.ModuleType("jax.numpy"))
    assert harness.forbidden_modules() == ["jax.numpy", "repro.core"]


def test_a_run_that_loads_jax_fails(tiny_cell, tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    with pytest.raises(RuntimeError, match="jax"):
        run(tiny_cell, tmp=tmp_path)


def test_run_refuses_without_a_card(capsys, monkeypatch):
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    from perfbench import run as cli
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS",
                "TRITON_CACHE_DIR", "TORCH_EXTENSIONS_DIR"):
        monkeypatch.setenv(var, "1")
    monkeypatch.setattr(sys, "path", list(sys.path))
    assert cli.main(["--workload", "covtype-ova.fit", "--seed", "1",
                     "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""
