"""The plain reference against the program's CPU path at a tiny size, its
control, and the faults a run must catch.  (Comparing with the program is
the tests' business: the reference itself imports nothing of it.)"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from perfbench import harness
from perfbench.control import readings
from perfbench.reference import fit, judge, prng
from perfbench.tests.tiny import TINY_CONFIG, run, write_cell


def test_reference_imports_nothing_of_the_program():
    import ast
    from pathlib import Path
    for f in (Path(fit.__file__).parent).glob("*.py"):
        tree = ast.parse(f.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for n in names:
                assert n.split(".")[0] not in ("repro", "repro_torch", "jax"), \
                    (f.name, n)


def test_prng_copy_matches_the_program():
    from repro_torch.core import prng as program
    key = prng.PRNGKey(2 ** 31 + 5)
    assert (prng.split(key, 7) == program.split(key, 7)).all()
    keys = prng.split(key, 3)
    assert (prng.uniform(keys, 11) == program.uniform(keys, 11)).all()
    assert (prng.normal(key, 9) == program.normal(key, 9)).all()


def test_folds_and_grids_match_the_program():
    from repro_torch.core import cv, grids
    keys = prng.split(prng.PRNGKey(0), 2)
    mask = torch.zeros(2, 40)
    mask[0, :33], mask[1, :40] = 1, 1
    got = cv.make_fold_masks(keys, mask, 5).numpy()
    for s, n_live in enumerate((33, 40)):
        assert (fit.fold_masks(keys[s], n_live, 40, 5) == got[s]).all()
    g = grids.liquid_grid(n=1234, dim=54, median_dist=3.7, grid_choice=0,
                          cell_size=2000)
    np.testing.assert_allclose(fit.gamma_grid(1234, 54, 3.7, 0, 2000),
                               g.gammas.numpy(), rtol=1e-6)
    g = grids.liquid_grid(n=1900, dim=54, median_dist=1.0, grid_choice=0,
                          cell_size=2000)
    np.testing.assert_allclose(fit.lambda_grid(1900, 0), g.lambdas.numpy(),
                               rtol=1e-6)


@pytest.mark.parametrize("solver", ["hinge", "ls"])
def test_reference_agrees_and_control_fails(tmp_path, solver):
    """The program's numbers within the tiny cell's limits on three seeds;
    the control (the reference in TF32) fails one of them on each."""
    config = dict(TINY_CONFIG, settings=dict(TINY_CONFIG["settings"],
                                             solver=solver))
    cell = harness.load_cell("tiny.fit", write_cell(tmp_path, config=config),
                             tmp_path)
    for seed in (1, 2, 3):
        r = readings(cell, seed, torch.device("cpu"), control=True)
        ok, rows = judge.compare(r["program"], cell.limits)
        assert ok, rows
        ok, rows = judge.compare(r["control"], cell.limits)
        assert not ok, rows


def _state_unchanged(monkeypatch):
    from repro_torch.core.solvers import base, least_squares

    def box_qp(k, y, lo, hi, c0=None, **kw):
        c = torch.clamp(torch.zeros_like(y) if c0 is None else c0, lo, hi)
        s, f = y.shape[:2]
        zero = torch.zeros((s, f), dtype=torch.int64)
        return base.BoxQPResult(c=c, kkt=torch.zeros(y.shape[:2] + y.shape[3:]),
                                iters=zero, l_est=torch.ones(s))
    monkeypatch.setattr(base, "box_qp_batched", box_qp)
    monkeypatch.setattr(least_squares, "krr_eigh_path",
                        lambda k, y, lam_n, tm: torch.zeros_like(y))


def _half_the_slots(monkeypatch):
    """The later half of each wave's slots left unsolved: their gamma step
    (box QP and polish, or the eigh path) returns its start.  The check's
    sampled slot is kept in the solved half, so that only the check of
    every slot at its first gamma can see the fault."""
    from repro_torch.core import cv
    solve = cv._solve_columns
    monkeypatch.setattr(judge, "sample_slots",
                        lambda case, seed: np.array([0]))

    def half_solve(k_full, y_cols, train_cols, lam_c, sub_c, n_eff_cols,
                   cfg, c0, l_est):
        c, iters = solve(k_full, y_cols, train_cols, lam_c, sub_c,
                         n_eff_cols, cfg, c0, l_est)
        start = torch.zeros_like(c) if c0 is None else c0.to(c)
        keep = c.shape[0] - c.shape[0] // 2
        return torch.cat([c[:keep], start[keep:]]), iters
    monkeypatch.setattr(cv, "_solve_columns", half_solve)


def _half_the_folds(monkeypatch):
    from repro_torch.core import select

    def combine(fold_coefs, how="average", dim=0):
        keep = fold_coefs.shape[dim] - fold_coefs.shape[dim] // 2
        return fold_coefs.narrow(dim, 0, keep).mean(dim=dim)
    monkeypatch.setattr(select, "combine_fold_models", combine)


def _answer_altered(monkeypatch):
    from repro_torch.api.session import SelectResult
    plain = SelectResult.decision_function

    def altered(self, x_test):
        out = plain(self, x_test)
        out[0, 0, 0] += 1.0
        return out
    monkeypatch.setattr(SelectResult, "decision_function", altered)


@pytest.mark.parametrize("solver", ["hinge", "ls"])
@pytest.mark.parametrize("fault", [_state_unchanged, _half_the_slots,
                                   _half_the_folds, _answer_altered])
def test_a_broken_timed_path_is_not_correct(tmp_path, monkeypatch, solver,
                                            fault):
    """A run with the timed path broken underneath reads ``correct``
    false: a solve that returns its state unchanged, half of the batch (a
    wave's slots) left unsolved, half of the folds left out of the mean, a
    decision altered where it is produced.  (One card:
    no exchange between chips to leave out.)"""
    config = dict(TINY_CONFIG, settings=dict(TINY_CONFIG["settings"],
                                             solver=solver))
    cell = harness.load_cell("tiny.fit", write_cell(tmp_path, config=config),
                             tmp_path)
    assert run(cell, tmp=tmp_path)["correct"]
    fault(monkeypatch)
    out = run(cell, tmp=tmp_path)
    assert not out["correct"] and out["failed"] == 1, out["checks"]


@pytest.mark.parametrize("wrong", ["sound", "other_seed", "random",
                                   "centers"])
def test_plan_replay_agrees_and_catches_wrong_plans(wrong):
    """The replayed recursive plan reads 0 faults on the program's plan
    and many on another seed's plan, on random cells and on shifted
    centers."""
    from repro_torch.data.scaling import Scaler
    from repro_torch.pipeline.cell_stream import build_cells_stream

    from perfbench.data import covtype_like
    from perfbench.reference import staging
    draw = covtype_like.make_draw(dict(TINY_CONFIG["data"], features=8))
    x, _ = draw(3000, np.random.default_rng(7), np.random.default_rng(8))
    xs32 = Scaler.fit(x).transform(x)
    plan = build_cells_stream(
        xs32, cell_size=200, method="random" if wrong == "random"
        else "recursive", seed=3 if wrong == "other_seed" else 0)
    centers = plan.centers + (0.01 if wrong == "centers" else 0.0)
    xs = staging.scale(x)[0]
    replay, tie = staging.recursive_plan_faults(xs, plan.indices, plan.mask,
                                                200, 0)
    faults = replay + staging.center_faults(xs, plan.indices, plan.mask,
                                            centers)
    if wrong == "sound":
        assert faults == 0 and tie <= staging.SPLIT_TIE
    else:
        assert faults > 10
