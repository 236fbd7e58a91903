"""The port's examples (``examples/torch_*.py``) run end to end on the CPU.

Each example runs in a subprocess with ``--device cpu`` at its smallest
setting (one intra-op thread) and prints one JSON object as its last line;
the test holds what it reports: held-out errors under a stated bound,
every submitted request served, losses finite and falling.  Without a
card and without ``--device cpu`` each example raises (it runs on the card
by default and never falls back).  No example imports JAX or the JAX
package; the reference scripts (``examples/*.py`` without the prefix) are
not run here (``quickstart.py`` alone took 111 s on one core).
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent
EXAMPLES = ROOT / "examples"

# example -> its smallest setting on the CPU
SMALL = {
    "torch_quickstart": ("--scale", "0.2", "--max-iters", "150"),
    "torch_serve_svm": ("--n", "600", "--max-iters", "150"),
    "torch_bigdata_train": ("--n", "3000", "--cell-size", "500", "--wave",
                            "4", "--queries", "500"),
    "torch_svm_cells_distributed": ("--n", "1500", "--max-iters", "150"),
    "torch_lm_svm_head": ("--n-per-class", "150", "--max-iters", "400"),
    "torch_serve_lm": ("--new", "8"),
    "torch_serve_lm --svm-head": ("--svm-head", "--arch", "stablelm-1.6b",
                                  "--n-per-class", "100"),
    "torch_train_lm_e2e": ("--preset", "tiny", "--steps", "30"),
}


def _env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + [p for p in env.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    env["OMP_NUM_THREADS"] = "1"
    return env


def _start(name: str, *args: str) -> subprocess.Popen:
    script = EXAMPLES / (name.split()[0] + ".py")
    return subprocess.Popen([sys.executable, str(script), *args],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=_env(), cwd=str(ROOT))


def _run_all(runs: dict, timeout: float) -> dict:
    """name -> (exit code, stdout, stderr) of every run of ``runs`` (name
    -> arguments), started side by side, one thread each."""
    procs = {name: _start(name, *args) for name, args in runs.items()}
    out = {}
    try:
        for name, p in procs.items():
            stdout, stderr = p.communicate(timeout=timeout)
            out[name] = (p.returncode, stdout, stderr)
    finally:
        for p in procs.values():
            p.kill()
    return out


@pytest.fixture(scope="module")
def reports():
    """Each example's last line at its smallest setting on the CPU."""
    out = {}
    for name, (rc, stdout, stderr) in _run_all(
            {name: ("--device", "cpu", *args)
             for name, args in SMALL.items()}, 600).items():
        assert rc == 0, (name, stdout[-2000:], stderr[-4000:])
        out[name] = json.loads(stdout.strip().splitlines()[-1])
        assert out[name]["device"] == "cpu"
    return out


@pytest.fixture(scope="module")
def no_card_runs():
    """Each example without ``--device cpu`` (skipped where a card is
    present: it would run on it)."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the examples would run on it")
    return _run_all({n.split()[0]: () for n in SMALL}, 120)


def test_every_example_has_a_case():
    names = sorted(p.stem for p in EXAMPLES.glob("torch_*.py"))
    assert names == sorted({n.split()[0] for n in SMALL})
    assert len(names) == 7


@pytest.mark.parametrize("name", sorted({n.split()[0] for n in SMALL}))
def test_imports_only_the_port(name):
    """An example imports ``repro_torch``, numpy and the standard library;
    nothing of JAX or the JAX package."""
    import ast
    tree = ast.parse((EXAMPLES / f"{name}.py").read_text())
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods.add(node.module.split(".")[0])
    allowed = {"repro_torch", "numpy", "torch_lm_svm_head"}
    assert all(m in allowed or m in sys.stdlib_module_names for m in mods), mods


@pytest.mark.parametrize("name", sorted({n.split()[0] for n in SMALL}))
def test_raises_without_a_card(no_card_runs, name):
    """Without ``--device cpu`` an example runs on the card, and with no
    card it raises before any work."""
    rc, _, err = no_card_runs[name]
    assert rc != 0
    assert "no CUDA device" in err, err[-2000:]


def test_quickstart(reports):
    r = reports["torch_quickstart"]
    assert r["mc_error"] < 0.4                 # 4 classes: chance 0.75
    lo, mid, hi = r["qt_coverage"]
    assert lo < mid < hi and lo <= 0.25 and hi >= 0.75
    assert r["npl_test_fa_at_0.01"] <= 0.1
    assert r["npl_detection_at_0.01"] >= 0.5
    assert r["bank_cells"] >= 2


def test_serve_svm(reports):
    r = reports["torch_serve_svm"]
    n = r["submitted"]
    assert r["served"] == r["async_served"] == r["swap_served"] == n
    assert r["served_v0"] + r["served_v1"] == n and r["served_v1"] > 0
    assert r["accuracy"] > 0.8 and r["async_accuracy"] == r["accuracy"]
    assert r["drifted"] and r["refreshed_version"] >= 1


def test_bigdata_train(reports):
    r = reports["torch_bigdata_train"]
    assert r["served"] == r["queries"] == 500
    assert r["error"] < 0.1
    assert r["waves"] >= 2 and r["cells"] >= 4
    assert r["owner_flips"] <= r["n"] // 1000


def test_svm_cells_distributed(reports):
    r = reports["torch_svm_cells_distributed"]
    assert r["ranks"] == 8 and r["ranks_equal"]
    assert r["local_error"] < 0.2
    assert abs(r["mesh_error"] - r["local_error"]) < 0.02


def test_lm_svm_head(reports):
    r = reports["torch_lm_svm_head"]
    assert r["error"] < 0.34                   # 3 classes: chance 0.67
    assert r["embed_dim"] == 64


def test_serve_lm(reports):
    r = reports["torch_serve_lm"]
    assert r["shape"] == [4, 24 + 8]
    assert r["prompt_kept"] and r["in_vocab"]
    h = reports["torch_serve_lm --svm-head"]
    assert h["served"] == h["submitted"] == 64


def test_train_lm_e2e(reports):
    r = reports["torch_train_lm_e2e"]
    assert math.isfinite(r["loss_first"]) and math.isfinite(r["loss_last"])
    assert r["loss_last"] < r["loss_first"]
