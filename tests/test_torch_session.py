"""The port's staged session against the JAX package's, on the CPU.

The counterparts of ``test_staged_api.py``: selection rules over one
retained surface, the re-solve of moved winners, stage artifacts, the
string-key config layer, the scenario front ends and the CLI.  Each
comparison hands both packages the same numpy inputs.

Tolerances: the selection rules are numpy in both packages over the same
surface, so winning indices and extras must be equal bitwise.  A re-solve
runs FISTA to the KKT tolerance ``tol`` in both packages with f32 products
in another order (``test_torch_train.py``): re-solved coefficients within
5e-3 of the box width, decisions within 5e-3 of the largest decision.
The ``stats`` counts (moved winners, columns, calls) must be equal; the
iteration counts may differ by the checks where the two stop.
"""
from __future__ import annotations

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.api import SVM as JSVM  # noqa: E402
from repro.core import select as j_select  # noqa: E402
from repro.train.svm_trainer import SVMTrainerConfig as JConfig  # noqa: E402
from repro_torch import cli  # noqa: E402
from repro_torch.api import (SVM, ConfigError, lsSVM, mcSVM,  # noqa: E402
                             nplSVM, qtSVM, rocSVM)
from repro_torch.api.config import (apply_keys, parse_keys,  # noqa: E402
                                    weight_grid)
from repro_torch.api.session import SelectResult, TrainResult  # noqa: E402
from repro_torch.core import cv as t_cv  # noqa: E402
from repro_torch.core import select as t_select  # noqa: E402
from repro.data.synthetic import train_test_split  # noqa: E402
from repro_torch.data.synthetic import (banana_mc, covtype_like,  # noqa: E402
                                        regression_1d)
from repro_torch.serve.model_bank import ModelBank  # noqa: E402
from repro_torch.serve.svm_engine import SVMEngine  # noqa: E402
from repro_torch.train.svm_trainer import LiquidSVM  # noqa: E402
from repro_torch.train.svm_trainer import SVMTrainerConfig  # noqa: E402

CPU = "cpu"
EPS = float(np.finfo(np.float32).eps)


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """Small shapes: one intra-op thread runs them as fast as eight on an
    idle machine, and many times faster when test workers share the cores
    (``test_torch_train.py``).  The ridge path runs here too since its
    fold-masked eigh is well posed at one thread (ROADMAP C9)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


WEIGHTED = dict(scenario="weighted", weights=(0.5, 1.0, 2.0), n_folds=2,
                max_iters=150, adaptivity_control=1)


def _binary_data(n=400, seed=0):
    x, y = covtype_like(n=n, d=4, seed=seed, label_noise=0.05, n_modes=3)
    return train_test_split(x, np.where(y == 0, -1, 1), 0.25, seed)


@pytest.fixture(scope="module")
def weighted():
    """One weighted-scenario train per package, shared by the
    re-selection tests."""
    xtr, ytr, xte, yte = _binary_data(n=500, seed=0)
    jsess = JSVM(xtr, ytr, config=JConfig(**WEIGHTED))
    jsess.train()
    sess = SVM(xtr, ytr, config=SVMTrainerConfig(**WEIGHTED), device=CPU)
    sess.train()
    return jsess, sess, (xtr, ytr, xte, yte)


# ------------------------------------------------------ selection rules
def _surfaces(seed: int, ties: bool):
    """One random surface as numpy, and both packages' Surface over it.
    ``ties``: counts on a coarse grid, so rates tie and columns with no
    point under alpha occur."""
    rng = np.random.default_rng(seed)
    c, g, t, l, s = 4, 5, 2, 6, 3
    neg = rng.integers(0, 40, (c, t)).astype(np.float32)
    pos = rng.integers(0, 40, (c, t)).astype(np.float32)
    step = 4.0 if ties else 1.0
    fa = np.floor(rng.uniform(0, 1, (c, g, t, l, s))
                  * neg[:, None, :, None, None] / step) * step
    det = np.floor(rng.uniform(0, 1, (c, g, t, l, s))
                   * pos[:, None, :, None, None] / step) * step
    loss = np.round(rng.uniform(0, 1, (c, g, t, l, s)),
                    1 if ties else 6).astype(np.float32)
    arrs = dict(loss=loss, fa=fa.astype(np.float32),
                det=det.astype(np.float32), neg=neg, pos=pos,
                gammas=rng.uniform(0.5, 2, (c, g)).astype(np.float32),
                lambdas=np.geomspace(1, 1e-3, l).astype(np.float32))
    return (j_select.Surface(**arrs), t_select.Surface(**arrs))


@pytest.mark.parametrize("rule,alpha,npl_class",
                         [("npl", 0.05, -1), ("npl", 0.2, -1),
                          ("npl", 0.0, 1), ("npl", 0.3, 1), ("roc", 0.05, -1),
                          ("roc", 0.05, 1), ("argmin", 0.05, -1)])
@pytest.mark.parametrize("seed,ties", [(0, False), (1, True), (2, True)])
def test_rules_equal_reference_on_one_surface(rule, alpha, npl_class, seed,
                                              ties):
    js, ts = _surfaces(seed, ties)
    jctx = j_select.SelectContext(scenario="weighted", alpha=alpha,
                                  npl_class=npl_class)
    tctx = t_select.SelectContext(scenario="weighted", alpha=alpha,
                                  npl_class=npl_class)
    a = j_select.get_rule(rule)(js, jctx)
    b = t_select.get_rule(rule)(ts, tctx)
    assert np.array_equal(np.asarray(a.g_idx), b.g_idx)
    assert np.array_equal(np.asarray(a.l_idx), b.l_idx)
    assert sorted(a.extras) == sorted(b.extras)
    for k in a.extras:
        want, got = np.asarray(a.extras[k]), np.asarray(b.extras[k])
        assert want.dtype == got.dtype and np.array_equal(want, got), k


def test_np_select_weight_first_index_and_fallback():
    fa = np.asarray([0.2, 0.01, 0.03, 0.01], np.float32)
    det = np.asarray([0.9, 0.5, 0.5, 0.7], np.float32)
    for alpha, want in ((0.05, 3), (0.02, 3), (0.001, 1), (0.5, 0)):
        assert t_select.np_select_weight(fa, det, alpha) == want
        assert int(j_select.np_select_weight(fa, det, alpha)) == want


# -------------------------------------------- re-selection, both packages
def _box_width(tr, sel) -> np.ndarray:
    """Each selected column's box width, hi - lo = w / (2 lambda n_eff),
    at the smallest fold training set a cell can have: (C, 1, T, S)."""
    f = tr.cv_cfg.n_folds
    live = tr.mask_cells.sum(-1)
    n_eff = np.maximum(np.floor(live * (f - 1) / f) - 1, 1.0)
    w = np.maximum(np.asarray(tr.config.weights, np.float32), 1.0)
    width = w[None, None, :] / (2.0 * sel.lam * n_eff[:, None, None])
    return width[:, None]


@pytest.mark.parametrize("rule,kw", [("npl", dict(alpha=0.02)),
                                     ("npl", dict(alpha=0.1, npl_class=1)),
                                     ("roc", {}), ("argmin", {})])
def test_reselection_matches_reference(weighted, rule, kw):
    jsess, sess, (_, _, xte, _) = weighted
    a, b = jsess.select(rule, **kw), sess.select(rule, **kw)
    for k in ("rule", "grid_columns", "winners_moved", "columns_resolved",
              "resolve_calls"):
        assert a.stats[k] == b.stats[k], k
    for k in a.extras:
        assert np.array_equal(np.asarray(a.extras[k]),
                              np.asarray(b.extras[k])), k
    # the per-cell gamma grids agree to a few ulps (test_torch_train.py)
    np.testing.assert_allclose(b.gamma, a.gamma, rtol=8 * EPS, atol=0)
    assert np.array_equal(a.lam, b.lam)
    box = _box_width(sess.train_result, b)                  # (C, 1, T, S)
    assert (np.abs(a.coefs - b.coefs) <= 5e-3 * box).all()
    da, db = a.decision_function(xte), b.decision_function(xte)
    assert np.abs(da - db).max() <= 5e-3 * max(1.0, np.abs(da).max())
    print(f"{rule} {kw}: stats {b.stats}; reference iters "
          f"{a.stats['solver_iters']}")


def test_npl_moves_winners_with_few_solves(weighted):
    _, sess, _ = weighted
    sel_arg = sess.select("argmin")
    sel_npl = sess.select("npl", alpha=0.02)
    st = sel_npl.stats
    assert st["winners_moved"] > 0
    assert st["columns_resolved"] == st["winners_moved"]
    assert st["columns_resolved"] <= 0.1 * st["grid_columns"]
    moved = (sel_npl.gamma != sel_arg.gamma) | (sel_npl.lam != sel_arg.lam)
    same = ~moved
    np.testing.assert_array_equal(np.moveaxis(sel_npl.coefs, 1, -1)[same],
                                  np.moveaxis(sel_arg.coefs, 1, -1)[same])
    assert moved.sum() == st["winners_moved"]


def test_npl_rates_come_from_validation_surface(weighted):
    _, sess, _ = weighted
    tr = sess.train_result
    sel = sess.select("npl", alpha=0.02)
    fa, det = sel.extras["np_fa"], sel.extras["np_det"]
    assert fa.shape == det.shape == tr.gamma.shape[1:]
    assert ((0 <= fa) & (fa <= 1)).all() and ((0 <= det) & (det <= 1)).all()
    neg, pos = tr.class_counts()
    assert (tr.surf_fa <= neg[:, None, :, None, None] + 1e-6).all()
    assert (tr.surf_det <= pos[:, None, :, None, None] + 1e-6).all()
    widx = int(sel.extras["np_weight_idx"][0])
    if (fa[0] <= 0.02).any():
        assert fa[0, widx] <= 0.02
    else:
        assert widx == int(fa[0].argmin())


def test_roc_front_without_solves(weighted):
    _, sess, _ = weighted
    sel = sess.select("roc")
    assert sel.stats["columns_resolved"] == 0
    front = np.asarray(sel.extras["roc_front"])
    t, s = sel.gamma.shape[1:]
    assert front.shape == (t, s, 2)
    assert (np.diff(front[0, :, 0]) >= 0).all()
    assert ((0 <= front) & (front <= 1)).all()


def test_argmin_returns_to_cache_bitwise(weighted):
    _, sess, _ = weighted
    sess.select("npl", alpha=0.02)
    sel = sess.select("argmin")
    assert sel.stats["columns_resolved"] == 0
    np.testing.assert_array_equal(sel.coefs, sess.train_result.coefs)
    np.testing.assert_array_equal(sel.val_loss, sess.train_result.val_loss)


def test_batched_resolve_one_call_per_gamma_group(weighted, monkeypatch):
    """Moved cells sharing a gamma-grid index re-solve in ONE batched
    call: resolve_calls is the number of distinct winning gamma indices,
    and so is the number of ``solve_columns_batched`` calls."""
    _, sess, _ = weighted
    tr = sess.train_result
    sel_arg = sess.select("argmin")
    calls = []
    real = t_cv.solve_columns_batched

    def counted(x, *args, **kw):
        calls.append(x.shape[0])
        return real(x, *args, **kw)

    monkeypatch.setattr(t_cv, "solve_columns_batched", counted)
    sel_npl = sess.select("npl", alpha=0.02)
    st = sel_npl.stats
    moved = (sel_npl.gamma != sel_arg.gamma) | (sel_npl.lam != sel_arg.lam)
    groups = set()
    for c, t, s in np.argwhere(moved):
        g_idx = np.flatnonzero(tr.gammas_cells[c] == sel_npl.gamma[c, t, s])
        assert g_idx.size >= 1
        groups.add(int(g_idx[0]))
    assert st["resolve_calls"] == len(groups) == len(calls)
    assert st["solver_iters"] > 0


def test_resolve_needs_hinge_for_npl_and_roc():
    xtr, ytr, _, _ = _binary_data(n=120, seed=3)
    sess = SVM(xtr, ytr.astype(np.float32),
               config=SVMTrainerConfig(scenario="ls", n_folds=2,
                                       adaptivity_control=2), device=CPU)
    sess.train()
    for rule in ("npl", "roc"):
        with pytest.raises(ValueError, match="hinge"):
            sess.select(rule)


def test_iteration_counts_drop(weighted):
    """Per-fold warm starts from a previous solve of the same columns cut
    the re-solve to a KKT check."""
    _, sess, _ = weighted
    tr = sess.train_result
    c = int(np.flatnonzero(tr.mask_cells.sum(-1) > 0)[0])
    gv = tr.gamma[c, 0, 0]
    ts = np.argwhere(tr.gamma[c] == gv)
    sub_grid = np.asarray(tr.config.weights, np.float32)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32))
    args = (t(tr.x_cells[c]), t(tr.y_cells[c]), t(tr.tmask_cells[c]),
            t(tr.mask_cells[c]), np.float32(gv),
            t(tr.lam[c, ts[:, 0], ts[:, 1]]), t(sub_grid[ts[:, 1]]),
            torch.as_tensor(ts[:, 0]), tr.fold_keys[c])
    cold_mean, it_cold, fold_coefs = t_cv.solve_columns_at(*args, tr.cv_cfg)
    warm_mean, it_warm, _ = t_cv.solve_columns_at(*args, tr.cv_cfg,
                                                  c0=fold_coefs)
    it_cold, it_warm = int(it_cold), int(it_warm)
    assert it_cold > 0
    assert it_warm <= it_cold // 2
    np.testing.assert_allclose(warm_mean.numpy(), cold_mean.numpy(),
                               atol=1e-2)


@pytest.mark.parametrize("shared_lipschitz", [True, False])
@pytest.mark.parametrize("warm", [False, True])
def test_solve_columns_at_matches_reference(weighted, shared_lipschitz,
                                            warm):
    """One cell's re-solve in both packages on the same staged arrays:
    a cold start or the cached argmin model as the shared warm start, one
    Lipschitz estimate per cell or one per fold."""
    import dataclasses
    import jax.numpy as jnp
    from repro.core import cv as j_cv
    _, sess, _ = weighted
    tr = sess.train_result
    c = int(np.argmax(tr.mask_cells.sum(-1)))
    cfg = dataclasses.replace(tr.cv_cfg, shared_lipschitz=shared_lipschitz)
    j_cfg = j_cv.CVConfig(**dataclasses.asdict(cfg))
    g = int(len(tr.gammas_cells[c]) // 2)
    ts = np.argwhere(np.ones(tr.gamma.shape[1:], bool))        # every column
    lam = tr.lambdas[np.arange(len(ts)) % len(tr.lambdas)]
    sub = np.asarray(tr.config.weights, np.float32)[ts[:, 1]]
    c0 = tr.coefs[c][:, ts[:, 0], ts[:, 1]] if warm else None
    arrays = (tr.x_cells[c], tr.y_cells[c], tr.tmask_cells[c],
              tr.mask_cells[c])
    want, it_j, _ = j_cv.solve_columns_at(
        *[jnp.asarray(a) for a in arrays],
        jnp.float32(tr.gammas_cells[c, g]), jnp.asarray(lam),
        jnp.asarray(sub), jnp.asarray(ts[:, 0], jnp.int32),
        jnp.asarray(tr.fold_keys[c]), j_cfg,
        c0=None if c0 is None else jnp.asarray(c0))
    got, it_t, _ = t_cv.solve_columns_at(
        *[torch.as_tensor(np.asarray(a, np.float32)) for a in arrays],
        np.float32(tr.gammas_cells[c, g]), torch.as_tensor(lam),
        torch.as_tensor(sub), torch.as_tensor(ts[:, 0]), tr.fold_keys[c],
        cfg, c0=None if c0 is None else torch.as_tensor(c0))
    f = cfg.n_folds
    n_eff = max(np.floor(tr.mask_cells[c].sum() * (f - 1) / f) - 1, 1.0)
    box = np.maximum(sub, 1.0) / (2.0 * lam * n_eff)
    assert (np.abs(np.asarray(want) - got.numpy()) <= 5e-3 * box).all()
    print(f"iterations: reference {int(it_j)}, port {int(it_t)}")
    assert abs(int(it_j) - int(it_t)) <= 10 * f


def test_val_loss_is_surface_min(weighted):
    _, sess, _ = weighted
    tr = sess.train_result
    np.testing.assert_array_equal(tr.val_loss, tr.surf_loss.min(axis=(1, 3)))


# ---------------------------------------------------------- persistence
def test_train_result_roundtrip_reselect(weighted, tmp_path):
    _, sess, _ = weighted
    tr = sess.train_result
    tr.save(str(tmp_path / "train"))
    tr2 = TrainResult.load(str(tmp_path / "train"), device=CPU)
    np.testing.assert_array_equal(tr2.iters, tr.iters)
    a = tr.select("npl", alpha=0.02)
    b = tr2.select("npl", alpha=0.02)
    np.testing.assert_array_equal(a.coefs, b.coefs)
    np.testing.assert_array_equal(a.gamma, b.gamma)
    assert a.stats == b.stats


def test_select_result_roundtrip_and_bank(weighted, tmp_path):
    _, sess, (_, _, xte, _) = weighted
    sel = sess.select("npl", alpha=0.02)
    sel.save(str(tmp_path / "select"))
    sel2 = SelectResult.load(str(tmp_path / "select"), device=CPU)
    np.testing.assert_array_equal(sel2.decision_function(xte),
                                  sel.decision_function(xte))
    assert sel2.default_sub == sel.default_sub
    assert sel2.stats == sel.stats
    eng = SVMEngine(sel2.to_bank(), device=CPU)
    np.testing.assert_array_equal(eng.predict_label(xte), sel.predict(xte))


def test_stage_artifacts_cross_load(weighted, tmp_path):
    """A TrainResult / SelectResult either package saved is loaded by the
    other, with the same selections and decisions."""
    from repro.api.session import SelectResult as JSelect
    from repro.api.session import TrainResult as JTrain
    jsess, sess, (_, _, xte, _) = weighted
    jsess.train_result.save(str(tmp_path / "j_train"))
    sess.train_result.save(str(tmp_path / "t_train"))
    port_of_ref = TrainResult.load(str(tmp_path / "j_train"), device=CPU)
    ref_of_port = JTrain.load(str(tmp_path / "t_train"))
    assert port_of_ref.iters is None
    for k in TrainResult._ARRAYS:
        np.testing.assert_array_equal(getattr(port_of_ref, k),
                                      np.asarray(getattr(jsess.train_result,
                                                         k)))
        np.testing.assert_array_equal(np.asarray(getattr(ref_of_port, k)),
                                      getattr(sess.train_result, k))
    a = port_of_ref.select("npl", alpha=0.02)
    b = ref_of_port.select("npl", alpha=0.02)
    assert {k: a.stats[k] for k in ("winners_moved", "columns_resolved",
                                    "resolve_calls")} == \
        {k: b.stats[k] for k in ("winners_moved", "columns_resolved",
                                 "resolve_calls")}
    jsel = jsess.select("npl", alpha=0.02)
    jsel.save(str(tmp_path / "j_select"), train_ref="../j_train")
    tsel = sess.select("npl", alpha=0.02)
    tsel.save(str(tmp_path / "t_select"))
    got = SelectResult.load(str(tmp_path / "j_select"), device=CPU)
    np.testing.assert_array_equal(got.coefs, jsel.coefs)
    assert got.default_sub == jsel.default_sub and got.rule == "npl"
    back = JSelect.load(str(tmp_path / "t_select"))
    np.testing.assert_array_equal(np.asarray(back.coefs), tsel.coefs)
    d_ref, d_port = back.decision_function(xte), tsel.decision_function(xte)
    assert np.abs(d_ref - d_port).max() <= 1e-5 * max(1.0,
                                                       np.abs(d_ref).max())


def test_streamed_test_matches_in_memory(weighted, tmp_path):
    _, sess, (_, _, xte, yte) = weighted
    sel = sess.select("argmin")
    ref = sel.test(xte, yte)
    np.save(tmp_path / "xte.npy", xte)
    via_mmap = sel.test(str(tmp_path / "xte.npy"), yte)
    chunked = sel.test(xte, yte, chunk_size=32)
    assert via_mmap.error == ref.error == chunked.error
    assert via_mmap.n == ref.n == len(xte)
    assert set(ref.details) == {"false_alarm", "detection"}


# ------------------------------------------------------------------ CLI
def _cli(capsys, argv):
    assert cli.main(argv + ["--device", CPU]) == 0
    return json.loads(capsys.readouterr().out)


class TestCLI:
    def test_cycle_cold_starts_engine(self, tmp_path, capsys):
        xtr, ytr, xte, yte = _binary_data(n=300, seed=4)
        for name, arr in [("xtr", xtr), ("ytr", ytr), ("xte", xte),
                          ("yte", yte)]:
            np.save(tmp_path / f"{name}.npy", arr)
        md = str(tmp_path / "model")
        common = ["-S", "FOLDS=2", "-S", "MAX_ITERATIONS=150",
                  "-S", "ADAPTIVITY_CONTROL=1"]
        out = _cli(capsys, ["train", "--data", str(tmp_path / "xtr.npy"),
                            "--labels", str(tmp_path / "ytr.npy"),
                            "--model-dir", md, "--scenario", "npl",
                            "-S", "WEIGHTS=0.5 1.0 2.0"] + common)
        assert out["stage"] == "train" and out["slots"] >= 1
        out = _cli(capsys, ["select", "--model-dir", md,
                            "-S", "NPL_CONSTRAINT=0.05"])
        assert out["rule"] == "npl"
        assert out["stats"]["columns_resolved"] \
            <= out["stats"]["grid_columns"]
        with open(f"{md}/select/step_00000000/manifest.json") as f:
            assert "x_cells" not in " ".join(json.load(f)["paths"])
        out = _cli(capsys, ["test", "--data", str(tmp_path / "xte.npy"),
                            "--labels", str(tmp_path / "yte.npy"),
                            "--model-dir", md])
        assert out["n"] == len(xte) and out["error"] < 0.25
        out = _cli(capsys, ["select", "--model-dir", md, "--rule", "roc"])
        assert out["stats"]["columns_resolved"] == 0 and "roc_front" in out
        sel = SelectResult.load(f"{md}/select", device=CPU)
        eng = SVMEngine(ModelBank.load(f"{md}/bank"), device=CPU)
        np.testing.assert_array_equal(eng.predict_label(xte),
                                      sel.predict(xte))
        # serve from bank/ alone, then close the drift -> refresh loop
        out = _cli(capsys, ["serve", "--data", str(tmp_path / "xte.npy"),
                            "--model-dir", md, "--out",
                            str(tmp_path / "pred.npy"),
                            "-S", "SLO_P99_MS=1000"])
        assert out["n"] == len(xte) and out["health"]["bank_version"] == 0
        np.testing.assert_array_equal(np.load(tmp_path / "pred.npy"),
                                      sel.predict(xte))
        out = _cli(capsys, ["serve", "--data", str(tmp_path / "xte.npy"),
                            "--model-dir", md, "--wave", "8",
                            "--swap-watch", "-S", "SWAP_POLL_MS=0",
                            "--feedback-data", str(tmp_path / "xte.npy"),
                            "--feedback-labels", str(tmp_path / "yte.npy"),
                            "-S", "DRIFT_REFRESH_THRESHOLD=0"])
        trig = [t for t in out["drift_triggers"] if "version" in t]
        assert trig and out["swaps"] >= 1
        assert out["bank_version"] == trig[-1]["version"]

    def test_weight_sweep_scenarios_get_default_grids(self, tmp_path,
                                                      capsys):
        xtr, ytr, _, _ = _binary_data(n=200, seed=9)
        np.save(tmp_path / "x.npy", xtr)
        np.save(tmp_path / "y.npy", ytr)
        out = _cli(capsys, ["train", "--data", str(tmp_path / "x.npy"),
                            "--labels", str(tmp_path / "y.npy"),
                            "--model-dir", str(tmp_path / "m"),
                            "--scenario", "roc", "-S", "FOLDS=2",
                            "-S", "MAX_ITERATIONS=100",
                            "-S", "ADAPTIVITY_CONTROL=2"])
        assert out["grid"]["sub"] == 9

    def test_embed_stage_feeds_train_and_token_serving(self, tmp_path,
                                                       capsys):
        """``embed`` writes the embed/ cache; ``train --data <md>/embed``
        streams its shards; ``serve --tokens`` rebuilds the recorded
        extractor and embeds in-process."""
        rng = np.random.default_rng(0)
        tok = rng.integers(0, 200, (96, 16)).astype(np.int32)
        y = np.where(tok[:, 0] % 2 == 0, 1.0, -1.0).astype(np.float32)
        np.save(tmp_path / "tok.npy", tok)
        np.save(tmp_path / "y.npy", y)
        md = str(tmp_path / "m")
        out = _cli(capsys, ["embed", "--tokens", str(tmp_path / "tok.npy"),
                            "--model-dir", md,
                            "-S", "EMBED_ARCH=stablelm-1.6b:smoke",
                            "-S", "EMBED_BATCH=32"])
        assert out["n"] == 96 and out["shards"] == 3
        assert not out["cache_hit"]
        out = _cli(capsys, ["train", "--data", f"{md}/embed", "--labels",
                            str(tmp_path / "y.npy"), "--model-dir", md,
                            "-S", "FOLDS=2", "-S", "MAX_ITERATIONS=50",
                            "-S", "ADAPTIVITY_CONTROL=2"])
        assert out["n"] == 96 and out["d"] == 64
        _cli(capsys, ["select", "--model-dir", md])
        out = _cli(capsys, ["serve", "--tokens", str(tmp_path / "tok.npy"),
                            "--model-dir", md, "--wave", "32"])
        assert out["n"] == 96 and out["waves"] >= 3
        out = _cli(capsys, ["embed", "--tokens", str(tmp_path / "tok.npy"),
                            "--model-dir", md,
                            "-S", "EMBED_ARCH=stablelm-1.6b:smoke",
                            "-S", "EMBED_BATCH=32"])
        assert out["cache_hit"]

    def test_no_card_without_device_exits_2(self, monkeypatch, capsys):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(SystemExit) as e:
            cli.main(["select", "--model-dir", "unused"])
        assert e.value.code == 2
        assert "--device cpu" in capsys.readouterr().err

    def test_missing_artifact_exits_2(self, tmp_path, capsys):
        with pytest.raises(SystemExit) as e:
            cli.main(["select", "--model-dir", str(tmp_path / "none"),
                      "--device", CPU])
        assert e.value.code == 2
        assert "missing 'train/' artifact" in capsys.readouterr().err


# ---------------------------------------------------------- config keys
class TestConfigKeys:
    def test_coercion_and_mapping(self):
        cfg, sel = apply_keys(SVMTrainerConfig(), {
            "folds": "3", "Kernel": "gauss_rbf", "VORONOI": "6",
            "cell_size": "250", "NPL_CONSTRAINT": "0.01", "npl_class": "1",
            "max_iterations": 200, "THREADS": 8})
        assert cfg.n_folds == 3 and cfg.cell_method == "recursive"
        assert cfg.cell_size == 250 and cfg.max_iters == 200
        assert sel == {"alpha": 0.01, "npl_class": 1}

    def test_weight_grid_keys(self):
        cfg, _ = apply_keys(SVMTrainerConfig(), {
            "MIN_WEIGHT": 0.5, "MAX_WEIGHT": 2.0, "WEIGHT_STEPS": 3})
        np.testing.assert_allclose(cfg.weights, (0.5, 1.0, 2.0))
        assert weight_grid(1.0, 1.0, 1) == (1.0,)

    def test_validation_errors(self):
        with pytest.raises(ConfigError, match="unknown config key"):
            parse_keys({"FOLDZ": 3})
        with pytest.raises(ConfigError, match="below minimum"):
            parse_keys({"FOLDS": 1})
        with pytest.raises(ConfigError, match="not in"):
            parse_keys({"FOLD_SCHEME": "sorted"})
        with pytest.raises(ConfigError, match="cannot parse"):
            parse_keys({"FOLDS": "three"})
        with pytest.raises(ConfigError, match="KERNEL"):
            apply_keys(SVMTrainerConfig(), {"KERNEL": "cubic"})

    def test_session_accepts_string_keys(self):
        sess = SVM(np.zeros((4, 2), np.float32), np.ones(4), FOLDS=3,
                   NPL_CONSTRAINT=0.1, DEADLINE_MS=5, SLO_P99_MS=20,
                   device=CPU)
        assert sess.config.n_folds == 3
        assert sess.select_kwargs == {"alpha": 0.1}
        assert sess.serve_kwargs == {"deadline_ms": 5.0}
        assert sess.monitor_kwargs == {"slo_p99_ms": 20.0}

    def test_keys_match_reference(self):
        from repro.api import config as j_config
        from repro_torch.api import config as t_config
        assert t_config.available_keys() == j_config.available_keys()
        pairs = {"FOLDS": "4", "VORONOI": "overlap", "WEIGHT_STEPS": 4,
                 "NPL_CLASS": "-1", "TAUS": "0.1, 0.9", "SCALE": "off"}
        jc, js = j_config.apply_keys(JConfig(), pairs)
        tc, ts = t_config.apply_keys(SVMTrainerConfig(), pairs)
        import dataclasses
        assert dataclasses.asdict(jc) == dataclasses.asdict(tc) and js == ts


# ---------------------------------------------------- scenario front ends
class TestScenarioFrontEnds:
    def test_mcSVM_cycle(self):
        x, y = banana_mc(n=400, n_classes=3, seed=5)
        xtr, ytr, xte, yte = train_test_split(x, y, 0.25, 5)
        sess = mcSVM(xtr, ytr, FOLDS=2, MAX_ITERATIONS=200,
                     ADAPTIVITY_CONTROL=1, device=CPU)
        sess.train()
        assert sess.test(xte, yte).error < 0.25

    def test_qtSVM_cycle(self):
        x, y = regression_1d(n=250, seed=6)
        xtr, ytr, xte, yte = train_test_split(x, y, 0.25, 6)
        sess = qtSVM(xtr, ytr, taus=(0.1, 0.9), FOLDS=2,
                     MAX_ITERATIONS=600, ADAPTIVITY_CONTROL=1, device=CPU)
        sess.train()
        sel = sess.select()
        assert sel.rule == "quantile"
        cover = (yte[:, None] <= sel.predict(xte)).mean(0)
        assert cover[0] < cover[1]

    def test_lsSVM_cycle(self):
        x, y = regression_1d(n=250, seed=8)
        xtr, ytr, xte, yte = train_test_split(x, y, 0.25, 8)
        sess = lsSVM(xtr, ytr, FOLDS=2, ADAPTIVITY_CONTROL=1, device=CPU)
        sess.train()
        res = sess.test(xte, yte)
        assert res.error < 2.0 * float(np.var(yte))
        assert sess.select_result.predict(xte).shape == (len(xte),)

    def test_rocSVM_front(self):
        xtr, ytr, _, _ = _binary_data(n=300, seed=7)
        sess = rocSVM(xtr, ytr, weight_steps=3, FOLDS=2,
                      MAX_ITERATIONS=150, ADAPTIVITY_CONTROL=1, device=CPU)
        sess.train()
        sel = sess.select()
        assert sel.rule == "roc"
        front = np.asarray(sel.extras["roc_front"])
        assert front.shape == (1, 3, 2)
        assert (np.diff(front[0, :, 0]) >= 0).all()

    def test_nplSVM_and_liquid_svm_npsvm(self):
        xtr, ytr, xte, yte = _binary_data(n=300, seed=10)
        sess = nplSVM(xtr, ytr, constraint=0.05, FOLDS=2,
                      MAX_ITERATIONS=150, ADAPTIVITY_CONTROL=1, device=CPU)
        assert sess.config.weights == weight_grid(0.25, 4.0, 5)
        sess.train()
        sel = sess.select()
        assert sel.rule == "npl"
        assert sel.extras["alpha"] == np.float32(0.05)
        res = sess.test(xte, yte)
        assert 0.0 <= res.details["false_alarm"] <= 1.0
        cfg = dataclasses_replace(sess.config)
        fit = LiquidSVM(cfg, device=CPU).fit(xtr, ytr)
        np.testing.assert_array_equal(fit.coefs, sel.coefs)
        assert fit.np_weight_idx == sel.default_sub
        np.testing.assert_array_equal(fit.np_fa, sel.extras["np_fa"][0])


def dataclasses_replace(cfg):
    import dataclasses
    return dataclasses.replace(cfg)


def test_quickstart_errors():
    """The quickstart's first two parts through the port, on its data,
    in recursive cells of 300 (the quickstart fits one cell; cells keep
    this test's CPU time down): the banana multiclass error near the
    quickstart's 15 % and quantile coverage near .1/.5/.9."""
    x, y = banana_mc(n=1600, n_classes=4, seed=0)
    xtr, ytr, xte, yte = train_test_split(x, y, 0.25, 0)
    mc = mcSVM(xtr, ytr, FOLDS=3, MAX_ITERATIONS=400, VORONOI="recursive",
               CELL_SIZE=300, device=CPU)
    mc.train()
    err = mc.test(xte, yte).error
    xq, yq = regression_1d(n=900, seed=1)
    xtr, ytr, xte, yte = train_test_split(xq, yq, 0.25, 1)
    qt = qtSVM(xtr, ytr, taus=(0.1, 0.5, 0.9), FOLDS=3,
               MAX_ITERATIONS=1500, VORONOI="recursive", CELL_SIZE=300,
               device=CPU)
    qt.train()
    cover = (yte[:, None] <= qt.select().predict(xte)).mean(0)
    print(f"banana-mc error {err:.4f}; coverage {cover}")
    assert 0.10 <= err <= 0.20
    assert np.all(np.abs(cover - np.asarray([0.1, 0.5, 0.9])) <= 0.06)
