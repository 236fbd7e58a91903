"""The port's serving health loop and checkpoints, on the CPU.

The counterparts of ``test_monitor.py`` (SLO burn rates, drift windows,
monitor keys, breakdown eviction and the closed drift -> refresh -> swap
loop), of ``test_faults.py``'s refresh cases and crash-safe checkpoint
cases, and the checkpoint bridge between the packages: a tree, a model
bank (f32 and bf16) and stage artifacts saved by either package restore in
the other, a bf16 bank without ``ml_dtypes`` on the port's side.

Everything time-dependent runs against an injected clock shared by the
engine and the monitor, so burn rates, rotations and drift scores are
exact assertions.
"""
from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.obs import MetricsRegistry, Tracer  # noqa: E402
from repro_torch.obs.slo import SLOSpec, SLOTracker  # noqa: E402
from repro_torch.serve.model_bank import ModelBank  # noqa: E402
from repro_torch.serve.monitor import HealthMonitor  # noqa: E402
from repro_torch.serve.svm_engine import SVMEngine  # noqa: E402
from repro_torch.testing import faults  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """The shapes here are small: one intra-op thread runs them as fast as
    eight on an idle machine, and when the test workers (or other jobs)
    share the cores, eight threads a process spin against each other and
    run many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CPU = "cpu"
SRC = os.path.join(os.path.dirname(__file__), "..", "src")


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.reset()
    yield
    faults.reset()


def _bank(seed=0, n_cells=3, k=16, d=4):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_cells, d)).astype(np.float32) * 4.0
    sv = (centers[:, None, :]
          + rng.normal(size=(n_cells, k, d))).astype(np.float32)
    coefs = rng.normal(size=(n_cells, k, 2, 1)).astype(np.float32)
    gamma = rng.uniform(0.5, 3.0, size=(n_cells, 2, 1)).astype(np.float32)
    mask = np.ones((n_cells, k), np.float32)
    bank = ModelBank.from_cells(sv, mask, coefs, gamma, centers)
    pool = (centers[rng.integers(0, n_cells, 64)]
            + rng.normal(size=(64, d)) * 1.0).astype(np.float32)
    return bank, pool


def _fake_engine(bank, clk, **kw):
    return SVMEngine(bank, device=CPU, fused=False, clock=lambda: clk[0],
                     metrics=MetricsRegistry(), tracer=Tracer(), **kw)


def _drain(eng: SVMEngine) -> dict:
    out: dict = {}
    while eng.pending or eng.in_flight:
        out.update(eng.step())
    return out


# -------------------------------------------------------------- SLO tracker
class TestSLOTracker:
    def test_burn_rate_is_bad_fraction_over_budget(self):
        clk = [100.0]
        t = SLOTracker(SLOSpec(threshold_ms=20.0, percentile=0.99,
                               window_s=60.0), clock=lambda: clk[0])
        for _ in range(98):
            t.record(5.0)
        t.record(25.0)
        t.record(30.0)
        assert t.window_counts() == (98, 2)
        assert t.bad_fraction() == pytest.approx(0.02)
        assert t.burn_rate() == pytest.approx(2.0)
        assert not t.ok()

    def test_window_evicts_old_buckets(self):
        clk = [0.0]
        t = SLOTracker(SLOSpec(threshold_ms=10.0, window_s=12.0),
                       clock=lambda: clk[0], n_buckets=12)
        t.record(99.0)
        assert t.window_counts() == (0, 1)
        clk[0] = 6.0
        t.record(1.0)
        assert t.window_counts() == (1, 1)
        clk[0] = 13.0
        assert t.window_counts() == (1, 0)
        assert t.burn_rate() == 0.0
        assert t.total_bad == 1

    def test_breach_and_recover_are_edge_triggered(self):
        clk = [0.0]
        t = SLOTracker(SLOSpec(threshold_ms=10.0, percentile=0.9,
                               window_s=10.0), clock=lambda: clk[0])
        for _ in range(8):
            t.record(1.0)
        t.record(50.0)
        t.record(50.0)
        assert [e["kind"] for e in t.poll()] == ["slo_breach"]
        assert t.poll() == []
        clk[0] = 11.0
        assert [e["kind"] for e in t.poll()] == ["slo_recover"]
        assert t.poll() == []
        assert [e["kind"] for e in t.events] == ["slo_breach", "slo_recover"]

    def test_percentile_zero_degenerates_to_miss_ratio(self):
        clk = [0.0]
        t = SLOTracker(SLOSpec(threshold_ms=2.0, percentile=0.0,
                               window_s=5.0), clock=lambda: clk[0])
        for ms in (1.0, 3.0, 3.0, 3.0):
            t.record(ms)
        assert t.bad_fraction() == pytest.approx(0.75)
        assert t.burn_rate() == pytest.approx(0.75)

    def test_spec_validation(self):
        with pytest.raises(ValueError):
            SLOSpec(threshold_ms=5.0, percentile=1.0)
        with pytest.raises(ValueError):
            SLOSpec(threshold_ms=5.0, window_s=0.0)


# ------------------------------------------------------------ drift windows
class TestHealthMonitor:
    def test_in_distribution_traffic_scores_near_zero(self):
        bank, pool = _bank()
        clk = [0.0]
        eng = _fake_engine(bank, clk)
        mon = HealthMonitor(eng, drift_window_s=1.0, min_window_count=4,
                            metrics=MetricsRegistry())
        for lo in range(0, 64, 8):
            eng.submit(pool[lo:lo + 8])
            eng.step()
            clk[0] += 0.01
        scores = mon.drift_scores()
        assert scores
        assert max(abs(s) for s in scores.values()) < 3.0
        assert mon.drifted_cells() == []
        h = mon.health()
        assert h["status"] == "ok" and h["drift"]["baseline"]

    def test_shifted_cell_crosses_threshold_alone(self):
        bank, pool = _bank()
        clk = [0.0]
        eng = _fake_engine(bank, clk)
        mon = HealthMonitor(eng, drift_window_s=1.0, drift_threshold=3.0,
                            min_window_count=4, metrics=MetricsRegistry())
        xs = (pool - bank.feat_mean) / bank.feat_std
        owner = eng.route(xs)
        target = int(np.bincount(owner).argmax())
        sel_rows = xs[owner == target]
        shifted_s = bank.centers[target] + (sel_rows
                                            - bank.centers[target]) * 5.0
        still = eng.route(shifted_s.astype(np.float32)) == target
        shifted_s = shifted_s[still]
        assert shifted_s.shape[0] >= 4
        shifted = (shifted_s * bank.feat_std
                   + bank.feat_mean).astype(np.float32)
        for lo in range(0, 64, 8):
            eng.submit(pool[lo:lo + 8])
            eng.submit(shifted)
            eng.step()
            clk[0] += 0.01
        assert mon.drifted_cells() == [target]
        assert mon.health()["status"] == "degraded"

    def test_window_rotation_is_clock_deterministic(self):
        def run():
            bank, pool = _bank(1)
            clk = [0.0]
            eng = _fake_engine(bank, clk)
            mon = HealthMonitor(eng, drift_window_s=0.05,
                                min_window_count=2,
                                metrics=MetricsRegistry())
            for lo in range(0, 64, 8):
                eng.submit(pool[lo:lo + 8])
                eng.step()
                clk[0] += 0.02
            return mon.drift_scores(), mon._windows_rotated

        s1, r1 = run()
        s2, r2 = run()
        assert s1 == s2 and r1 == r2 and r1 > 0

    def test_no_baseline_disables_drift(self):
        bank, pool = _bank()
        bare = dataclasses.replace(bank, route_baseline=None)
        clk = [0.0]
        eng = _fake_engine(bare, clk)
        mon = HealthMonitor(eng, metrics=MetricsRegistry())
        eng.submit(pool[:16])
        eng.step()
        assert mon.drift_scores() == {}
        h = mon.health()
        assert h["drift"]["baseline"] is False and h["status"] == "ok"

    def test_reset_cells_clears_windows(self):
        bank, pool = _bank()
        clk = [0.0]
        eng = _fake_engine(bank, clk)
        mon = HealthMonitor(eng, min_window_count=1,
                            metrics=MetricsRegistry())
        eng.submit(pool[:32])
        eng.step()
        cells = list(mon.drift_scores())
        assert cells
        mon.reset_cells(cells)
        assert mon.drift_scores() == {}

    def test_slo_and_deadline_threaded_through_health(self):
        bank, pool = _bank()
        clk = [0.0]
        eng = _fake_engine(bank, clk, deadline_ms=5.0)
        mon = HealthMonitor(eng, slo_p99_ms=1e-6, metrics=MetricsRegistry())
        eng.submit(pool[:16])
        clk[0] += 0.01
        eng.step()
        h = mon.health()
        assert h["slo"]["breached"] and h["status"] == "breaching"
        assert h["deadline_miss_ratio"] == pytest.approx(1.0)
        assert mon._metrics.counter("serve.slo_breaches").value >= 1

    def test_constructor_validation(self):
        bank, _ = _bank()
        eng = _fake_engine(bank, [0.0])
        with pytest.raises(ValueError):
            HealthMonitor(eng, slo_p99_ms=5.0, slo=SLOSpec(threshold_ms=5.0),
                          metrics=MetricsRegistry())
        with pytest.raises(ValueError):
            HealthMonitor(eng, drift_window_s=0.0, metrics=MetricsRegistry())

    def test_scores_match_reference_monitor(self):
        """The same traffic through both packages' engine and monitor
        gives the same drift scores and verdict."""
        from repro.obs import MetricsRegistry as JMetrics
        from repro.obs import Tracer as JTracer
        from repro.serve.model_bank import ModelBank as JBank
        from repro.serve.monitor import HealthMonitor as JMonitor
        from repro.serve.svm_engine import SVMEngine as JEngine
        bank, pool = _bank(3)
        jb = JBank(**{f.name: getattr(bank, f.name)
                      for f in dataclasses.fields(bank)})
        out = []
        for eng_cls, mon_cls, reg, tr, kw in (
                (SVMEngine, HealthMonitor, MetricsRegistry, Tracer,
                 {"device": CPU, "bank": bank}),
                (JEngine, JMonitor, JMetrics, JTracer, {"bank": jb})):
            clk = [0.0]
            eng = eng_cls(fused=False, clock=lambda: clk[0],
                          metrics=reg(), tracer=tr(), **kw)
            mon = mon_cls(eng, drift_window_s=1.0, min_window_count=4,
                          metrics=reg())
            for lo in range(0, 64, 8):
                eng.submit(pool[lo:lo + 8] * (1.0 + lo / 16.0))
                eng.step()
                clk[0] += 0.01
            h = mon.health()
            out.append((mon.drift_scores(), h["status"],
                        h["drift"]["drifted_cells"]))
        assert out[0][0].keys() == out[1][0].keys()
        for c in out[0][0]:
            assert out[0][0][c] == pytest.approx(out[1][0][c], rel=1e-5)
        assert out[0][1:] == out[1][1:]


# ------------------------------------------------------------- config keys
class TestMonitorKeys:
    def test_apply_keys_rejects_monitor_keys(self):
        from repro_torch.api.config import ConfigError, apply_keys
        from repro_torch.train.svm_trainer import SVMTrainerConfig
        for key in ("SLO_P99_MS", "DRIFT_WINDOW", "DRIFT_REFRESH_THRESHOLD"):
            with pytest.raises(ConfigError, match="health-monitor key"):
                apply_keys(SVMTrainerConfig(), {key: 5.0})

    def test_split_monitor_keys_maps_and_coerces(self):
        from repro_torch.api.config import ConfigError, split_monitor_keys
        rest, mon = split_monitor_keys(
            {"SLO_P99_MS": "20", "DRIFT_WINDOW": "2.5",
             "DRIFT_REFRESH_THRESHOLD": "4", "FOLDS": "3"})
        assert mon == {"slo_p99_ms": 20.0, "drift_window_s": 2.5,
                       "drift_threshold": 4.0}
        assert rest == {"FOLDS": "3"}
        with pytest.raises(ConfigError):
            split_monitor_keys({"SLO_P99_MS": "-1"})


# ------------------------------------------- breakdown eviction (regression)
class TestBreakdownEviction:
    def test_evicted_vs_never_seen_are_distinguishable(self, monkeypatch):
        from repro_torch.serve import svm_engine as se
        monkeypatch.setattr(se, "_SERVED_VERSION_CAP", 4)
        bank, pool = _bank()
        clk = [0.0]
        eng = _fake_engine(bank, clk)
        served = []
        for lo in range(0, 12, 2):
            eng.submit(pool[lo:lo + 2])
            served.extend(eng.step())
            clk[0] += 0.001
        assert len(served) == 12
        assert eng.breakdown(10 ** 9) is None
        assert eng.stats()["breakdown_evicted"] == 8
        assert eng.breakdown(min(served)) is None
        assert eng.breakdown(max(served))["total_ms"] >= 0.0
        eng2 = _fake_engine(bank, clk)
        eng2.submit(pool[:2])
        eng2.step()
        assert eng2.breakdown(10 ** 9) is None
        assert eng2.stats()["breakdown_evicted"] == 0


# ------------------------------------------------------------- closed loop
@pytest.fixture(scope="module")
def fit():
    """The reference tests' voronoi fit (n=600), in the port."""
    from repro_torch.api import SVM
    from repro_torch.data.synthetic import covtype_like
    from repro_torch.train.svm_trainer import SVMTrainerConfig
    x, y = covtype_like(n=600, d=4, seed=3, label_noise=0.02, n_modes=3)
    y = np.where(y == 0, -1.0, 1.0)
    cfg = SVMTrainerConfig(n_folds=2, max_iters=150, cell_method="voronoi",
                           cell_size=120)
    sess = SVM(x, y, config=cfg, device=CPU)
    sess.train()
    sel = sess.select("argmin")
    return sess, sel, x, y


class TestClosedLoop:
    def _shifted_traffic(self, bank, eng, x, factor=6.0):
        xs = (np.asarray(x, np.float32) - bank.feat_mean) / bank.feat_std
        owner = eng.route(xs)
        target = int(np.bincount(owner, minlength=bank.n_cells).argmax())
        rows = xs[owner == target]
        shifted_s = bank.centers[target] + (rows
                                            - bank.centers[target]) * factor
        keep = eng.route(shifted_s.astype(np.float32)) == target
        shifted = (shifted_s[keep] * bank.feat_std
                   + bank.feat_mean).astype(np.float32)
        return target, shifted

    def test_drift_refresh_swap_end_to_end(self, fit):
        from repro_torch.serve.refresh import refresh_drifted
        sess, sel, x, _ = fit
        tr = sess.train_result
        bank0 = sel.to_bank()
        assert bank0.route_baseline is not None
        assert bank0.stats()["drift_baseline"]
        clk = [0.0]
        eng = _fake_engine(bank0, clk)
        mon = sess.monitor(eng, drift_window_s=1.0, drift_threshold=3.0,
                           min_window_count=4, metrics=MetricsRegistry())
        for lo in range(0, 200, 20):
            eng.submit(x[lo:lo + 20].astype(np.float32))
            eng.step()
            clk[0] += 0.01
        assert mon.drifted_cells() == []
        target, shifted = self._shifted_traffic(bank0, eng, x)
        assert shifted.shape[0] >= 4
        for _ in range(4):
            eng.submit(shifted)
            eng.step()
            clk[0] += 0.01
        drifted = mon.drifted_cells()
        assert target in drifted
        assert set(drifted) < set(range(bank0.n_cells))
        rng = np.random.default_rng(0)
        y_feed = rng.choice([-1.0, 1.0], size=shifted.shape[0])
        bank1, info = refresh_drifted(tr, sel, shifted, y_feed, drifted,
                                      base_version=eng.bank.version)
        assert bank1 is not None and bank1.version == bank0.version + 1
        n_cols = sel.gamma.shape[1] * sel.gamma.shape[2]
        assert info["drifted_slots"] <= len(drifted)
        assert info["columns_resolved"] <= len(drifted) * n_cols
        assert info["feedback_used"] == shifted.shape[0]
        full_columns = (tr.packed.n_slots * n_cols
                        * tr.gammas_cells.shape[1] * tr.lambdas.shape[0])
        assert info["columns_resolved"] * 20 < full_columns
        # every slot the refresh did not touch keeps its live rows bitwise
        # (the padded row count follows the largest cell)
        for c in range(bank0.n_cells):
            if c not in drifted:
                k = int(bank0.sv_count[c])
                assert int(bank1.sv_count[c]) == k
                assert np.array_equal(bank0.sv[c, :k], bank1.sv[c, :k])
                assert np.array_equal(bank0.coefs[c, :k],
                                      bank1.coefs[c, :k])
        xq = x[300:340].astype(np.float32)
        xs = (xq - bank0.feat_mean) / bank0.feat_std
        keep = ~np.isin(eng.route(xs), drifted)
        if keep.any():
            e0 = SVMEngine(bank0, device=CPU, fused=False)
            e1 = SVMEngine(bank1, device=CPU, fused=False)
            np.testing.assert_array_equal(e0.predict(xq[keep]),
                                          e1.predict(xq[keep]))
        submitted = eng.counters["submitted"]
        served = eng.counters["served"]
        eng.submit(x[400:420].astype(np.float32))
        eng.begin_step()
        eng.swap_bank(bank1)
        eng.submit(x[420:440].astype(np.float32))
        eng.finish_step()
        eng.step()
        clk[0] += 0.01
        assert eng.bank.version == bank1.version
        assert eng.counters["submitted"] - submitted == 40
        assert eng.counters["served"] - served == 40
        assert eng.counters["shed_rows"] == 0
        mon.reset_cells(drifted)
        assert mon._baseline_arrays() is not None
        assert mon._baseline_version == bank1.version

    def test_latency_sketch_matches_pooled_breakdowns(self, fit):
        _, sel, x, _ = fit
        clk = [0.0]
        eng = _fake_engine(sel.to_bank(), clk)
        rng = np.random.default_rng(5)
        rids = []
        for lo in range(0, 400, 16):
            eng.submit(x[lo:lo + 16].astype(np.float32))
            clk[0] += float(rng.uniform(0.0, 0.01))
            rids.extend(eng.step())
            clk[0] += float(rng.uniform(0.0, 0.005))
        pooled = np.asarray([eng.breakdown(r)["total_ms"] for r in rids])
        q = eng.stats()["request_ms_q"]
        assert q["count"] == pooled.size
        assert eng._m_request_q.exact
        for name, qq in (("p50", 0.5), ("p90", 0.9), ("p99", 0.99)):
            assert q[name] == np.quantile(pooled, qq, method="lower")


# ---------------------------------------------------- incremental refresh
class TestRefresh:
    def test_refresh_touches_only_drifted_cells_and_bumps_version(self, fit):
        from repro_torch.serve.refresh import refresh_bank
        sess, sel, x, _ = fit
        tr = sess.train_result
        bank0 = sel.to_bank()
        assert bank0.version == 0
        x_new = np.repeat(x[:1], 3, axis=0)
        y_new = np.asarray([1.0, -1.0, 1.0])
        bank1, info = refresh_bank(tr, sel, x_new, y_new)
        assert bank1.version == 1
        assert info["drifted_slots"] == 1 and info["rows_added"] == 3
        assert info["resolve_calls"] >= 1
        np.testing.assert_array_equal(bank1.centers, bank0.centers)
        drifted = int(np.asarray(tr.packed.slot_of_cell)[
            tr.plan.route(tr.scaler.transform(x_new))[0]])
        eng0 = SVMEngine(bank0, device=CPU, fused=False)
        eng1 = SVMEngine(bank1, device=CPU, fused=False)
        xq = x[50:90].astype(np.float32)
        xs = (xq - bank0.feat_mean) / bank0.feat_std
        keep = eng0.route(xs) != drifted
        assert keep.any()
        np.testing.assert_array_equal(eng0.predict(xq[keep]),
                                      eng1.predict(xq[keep]))

    def test_refreshed_bank_hot_swaps(self, fit):
        from repro_torch.serve.refresh import refresh_bank
        sess, sel, x, _ = fit
        bank0 = sel.to_bank()
        bank1, _ = refresh_bank(sess.train_result, sel, x[:2],
                                np.asarray([1.0, -1.0]))
        eng = SVMEngine(bank0, device=CPU, fused=False)
        eng.submit(x[10:16].astype(np.float32))
        out = eng.swap_bank(bank1)
        assert out["version"] == 1 and out["requeued"] == 6
        served = _drain(eng)
        assert len(served) == 6
        assert all(eng.served_version[r] == 1 for r in served)
        assert eng.stats()["bank_version"] == 1

    def test_refresh_matches_reference(self, fit, tmp_path):
        """The reference's refresh of the same fit and feedback (the port's
        TrainResult and SelectResult handed over through their
        checkpoints): the same slots and counts, the same untouched
        tables, re-solved coefficients within the re-solve tolerance of
        ``test_torch_session.py``."""
        from repro.api.session import SelectResult as JSelect
        from repro.api.session import TrainResult as JTrain
        from repro.serve.refresh import refresh_bank as j_refresh
        from repro_torch.serve.refresh import refresh_bank
        sess, sel, x, _ = fit
        tr = sess.train_result
        tr.save(str(tmp_path / "train"))
        sel.save(str(tmp_path / "select"))
        jtr = JTrain.load(str(tmp_path / "train"))
        jsel = JSelect.load(str(tmp_path / "select"))
        x_new = x[100:112].astype(np.float32)
        y_new = np.where(np.arange(12) % 2 == 0, 1.0, -1.0)
        jb, jinfo = j_refresh(jtr, jsel, x_new, y_new)
        tb, tinfo = refresh_bank(tr, sel, x_new, y_new)
        assert jinfo == tinfo
        assert jb.version == tb.version == 1
        np.testing.assert_array_equal(np.asarray(jb.sv_count), tb.sv_count)
        np.testing.assert_array_equal(np.asarray(jb.sv), tb.sv)
        scale = float(np.abs(np.asarray(jb.coefs)).max())
        assert np.abs(np.asarray(jb.coefs) - tb.coefs).max() <= 5e-3 * scale


# ---------------------------------------------------- crash-safe checkpoints
def _tree(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(7, 3)).astype(np.float32),
            "b": rng.normal(size=(3,)).astype(np.float32),
            "step": np.int32(seed)}


def _save(d: str, step: int, **kw) -> str:
    return ckpt.save_checkpoint(d, step, _tree(step), extra={"s": step}, **kw)


def _assert_restores(d: str, step: int, expect_seed: int) -> None:
    tree, extra = ckpt.restore_self_describing(d, step=step)
    want = _tree(expect_seed)
    assert extra == {"s": expect_seed}
    for k in want:
        np.testing.assert_array_equal(tree[k], want[k])


def _corrupt_leaf(step_dir: str, leaf: str = "leaf_0") -> None:
    """Flip one payload byte, keeping the npz a valid zip."""
    shard = os.path.join(step_dir, "shard_0.npz")
    with np.load(shard) as z:
        arrays = {k: z[k].copy() for k in z.files}
    arrays[leaf][0] ^= 0xFF
    np.savez(shard, **arrays)


class TestCrashSafeCheckpoint:
    @pytest.mark.parametrize("site", ["checkpoint.save.pre_shard",
                                      "checkpoint.save.post_shard",
                                      "checkpoint.save.pre_rename"])
    def test_kill_before_visibility_keeps_last_good_step(self, tmp_path,
                                                         site):
        d = os.fspath(tmp_path)
        _save(d, 0)
        with pytest.raises(faults.InjectedFault):
            with faults.armed(site):
                _save(d, 1)
        assert ckpt.list_steps(d) == [0] and ckpt.latest_step(d) == 0
        _assert_restores(d, 0, 0)
        assert any(n.startswith(".tmp_step_1") for n in os.listdir(d))
        _save(d, 1)
        assert not any(n.startswith(".tmp_step_") for n in os.listdir(d))
        _assert_restores(d, 1, 1)

    def test_kill_after_rename_step_is_durable(self, tmp_path):
        d = os.fspath(tmp_path)
        _save(d, 0)
        with pytest.raises(faults.InjectedFault):
            with faults.armed("checkpoint.save.post_rename"):
                _save(d, 1)
        assert ckpt.list_steps(d) == [0, 1]
        assert ckpt.restore_self_describing(d)[1] == {"s": 1}

    def test_torn_manifest_detected(self, tmp_path):
        d = os.fspath(tmp_path)
        _save(d, 0)
        _save(d, 1)
        man = os.path.join(d, "step_00000001", "manifest.json")
        raw = open(man, "rb").read()
        with open(man, "wb") as f:
            f.write(raw[: len(raw) // 2])
        assert ckpt.list_steps(d) == [0] and ckpt.latest_step(d) == 0
        _assert_restores(d, 0, 0)

    def test_payload_bitflip_raises_corrupt_and_falls_back(self, tmp_path):
        d = os.fspath(tmp_path)
        _save(d, 0)
        _save(d, 1)
        _corrupt_leaf(os.path.join(d, "step_00000001"))
        assert ckpt.latest_step(d) == 1
        assert ckpt.verify_step(d, 1) is False
        assert ckpt.verify_step(d, 0) is True
        assert ckpt.restore_self_describing(d)[1] == {"s": 0}
        assert (os.path.abspath(d), 1) in [
            (os.path.abspath(p), s) for p, s in ckpt.fallback_log()]
        with pytest.raises(ckpt.CheckpointCorruptError, match="checksum"):
            ckpt.restore_self_describing(d, step=1)

    def test_truncated_shard_raises_corrupt(self, tmp_path):
        d = os.fspath(tmp_path)
        _save(d, 0)
        _save(d, 1)
        shard = os.path.join(d, "step_00000001", "shard_0.npz")
        raw = open(shard, "rb").read()
        with open(shard, "wb") as f:
            f.write(raw[: len(raw) // 2])
        with pytest.raises(ckpt.CheckpointCorruptError):
            ckpt.restore_self_describing(d, step=1)
        assert ckpt.restore_self_describing(d)[1] == {"s": 0}

    def test_only_step_torn_raises_corrupt(self, tmp_path):
        d = os.fspath(tmp_path)
        _save(d, 0)
        _corrupt_leaf(os.path.join(d, "step_00000000"), "leaf_1")
        with pytest.raises(ckpt.CheckpointCorruptError,
                           match="no step survived"):
            ckpt.restore_self_describing(d)

    def test_legacy_v1_manifest_without_checksums_restores(self, tmp_path):
        import json
        d = os.fspath(tmp_path)
        _save(d, 0)
        man = os.path.join(d, "step_00000000", "manifest.json")
        with open(man) as f:
            m = json.load(f)
        del m["checksums"]
        m["manifest_version"] = 1
        with open(man, "w") as f:
            json.dump(m, f)
        _assert_restores(d, 0, 0)
        assert ckpt.verify_step(d, 0) is True

    def test_torn_latest_pointer_falls_back_to_listing(self, tmp_path):
        d = os.fspath(tmp_path)
        _save(d, 0)
        _save(d, 1)
        with open(os.path.join(d, "latest"), "w") as f:
            f.write("step_garb")
        assert ckpt.latest_step(d) == 1

    def test_structure_mismatch_raises_not_falls_back(self, tmp_path):
        d = os.fspath(tmp_path)
        _save(d, 0)
        with pytest.raises(ValueError, match="structure mismatch"):
            ckpt.restore_checkpoint(d, {"other": 0, "keys": 0})
        tree, step, extra = ckpt.restore_checkpoint(
            d, {"b": 0, "step": 0, "w": 0})
        assert step == 0 and extra == {"s": 0}
        np.testing.assert_array_equal(tree["w"], _tree(0)["w"])

    def test_gc_guards(self, tmp_path):
        d = os.fspath(tmp_path)
        _save(d, 0)
        for s in (1, 2):                                # torn: no files
            os.makedirs(os.path.join(d, f"step_{s:08d}"))
        ckpt._gc(d, keep_last=2)
        assert ckpt.list_steps(d) == [0]
        d2 = os.fspath(tmp_path / "b")
        for s in range(4):
            _save(d2, s, keep_last=0)
        faults.arm("checkpoint.restore.mid",
                   action=lambda **ctx: _save(d2, 4, keep_last=1))
        assert ckpt.restore_self_describing(d2, step=0)[1] == {"s": 0}
        assert ckpt.list_steps(d2) == [0, 4]


# ------------------------------------------ the bridge between the packages
def _nested() -> dict:
    rng = np.random.default_rng(7)
    return {"layer": {"w": rng.normal(size=(3, 2)).astype(np.float32),
                      "idx": np.arange(5, dtype=np.int32)},
            "list": [np.float32(1.5), np.ones((2,), np.uint8)],
            "a": np.zeros((0, 4), np.float32)}


def test_tree_paths_and_bytes_equal_reference(tmp_path):
    """The same tree saved by both packages: the same manifest (paths,
    shapes, dtypes, checksums) and restores that agree both ways."""
    from repro.train import checkpoint as j_ckpt
    j_dir, t_dir = str(tmp_path / "j"), str(tmp_path / "t")
    j_ckpt.save_checkpoint(j_dir, 3, _nested(), extra={"k": 1})
    ckpt.save_checkpoint(t_dir, 3, _nested(), extra={"k": 1})
    mj, mt = j_ckpt.peek_manifest(j_dir), ckpt.peek_manifest(t_dir)
    for k in ("paths", "shapes", "dtypes", "checksums", "n_leaves",
              "manifest_version", "extra", "step"):
        assert mj[k] == mt[k], k
    want = _nested()
    for restore, d in ((ckpt.restore_checkpoint, j_dir),
                       (j_ckpt.restore_checkpoint, t_dir)):
        tree, step, extra = restore(d, _nested())
        assert step == 3 and extra == {"k": 1}
        np.testing.assert_array_equal(np.asarray(tree["layer"]["w"]),
                                      want["layer"]["w"])
        np.testing.assert_array_equal(np.asarray(tree["list"][1]),
                                      want["list"][1])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_bank_cross_load(tmp_path, dtype):
    """A bank either package saved is served by the other's loader with
    the same tables, bit for bit."""
    from repro.serve.model_bank import ModelBank as JBank
    _, pool = _bank(11)
    t_bank = ModelBank.from_cells(
        *_cells(11), dtype=dtype, version=4, routing="overlap")
    j_bank = JBank.from_cells(*_cells(11), dtype=dtype, version=4,
                              routing="overlap")
    t_bank.save(str(tmp_path / "t"))
    j_bank.save(str(tmp_path / "j"))
    back_j = JBank.load(str(tmp_path / "t"))
    back_t = ModelBank.load(str(tmp_path / "j"))
    for a, b in ((back_t, j_bank), (t_bank, back_j)):
        for f in ("sv", "coefs"):
            ta, tb = getattr(a, f), getattr(b, f)
            ba = (ta.view(torch.int16).numpy() if isinstance(ta, torch.Tensor)
                  else np.asarray(ta).view(np.int16 if dtype == "bf16"
                                           else np.int32))
            bb = np.asarray(tb).view(ba.dtype)
            assert np.array_equal(ba, bb), f
        for f in ("gammas", "sv_count", "centers", "feat_mean", "pairs"):
            np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                          np.asarray(getattr(b, f)))
        assert a.version == b.version == 4 and a.routing == "overlap"
        assert a.route_baseline == b.route_baseline
    eng = SVMEngine(back_t, device=CPU, fused=False)
    dec = eng.predict(pool[:8])
    assert dec.shape == (8, 2, 1) and np.isfinite(dec).all()


def _cells(seed):
    rng = np.random.default_rng(seed)
    c, k, d = 3, 16, 4
    centers = rng.normal(size=(c, d)).astype(np.float32) * 4.0
    sv = (centers[:, None, :] + rng.normal(size=(c, k, d))).astype(
        np.float32)
    coefs = rng.normal(size=(c, k, 2, 1)).astype(np.float32)
    gamma = rng.uniform(0.5, 3.0, size=(c, 2, 1)).astype(np.float32)
    return sv, np.ones((c, k), np.float32), coefs, gamma, centers


def test_bank_from_trained_and_cell_model():
    """A one-cell bank from a working-set model equals the reference's,
    and each cell of a bank, seen as a model again, decides as the engine
    does."""
    from repro.core.svm import TrainedSVM as JTrained
    from repro.serve.model_bank import ModelBank as JBank
    from repro_torch.core.svm import TrainedSVM
    sv, mask, coefs, gamma, _ = _cells(13)
    mask[0, -3:] = 0.0
    coefs[0, 2] = 0.0
    parts = dict(sv_x=sv[0], sv_mask=mask[0], coefs=coefs[0],
                 gamma=gamma[0], lam=gamma[0], tau=gamma[0],
                 val_loss=gamma[0])
    t_bank = ModelBank.from_trained(TrainedSVM(
        **{k: torch.as_tensor(v) for k, v in parts.items()}))
    j_bank = JBank.from_trained(JTrained(**parts))
    for f in ("sv", "coefs", "gammas", "sv_count", "centers", "pairs"):
        np.testing.assert_array_equal(np.asarray(getattr(t_bank, f)),
                                      np.asarray(getattr(j_bank, f)))
    assert t_bank.route_baseline == j_bank.route_baseline
    bank = ModelBank.from_cells(*_cells(14))
    eng = SVMEngine(bank, device=CPU, fused=False)
    x = _cells(15)[0].reshape(-1, 4)[:40]
    cells = eng.route((x - bank.feat_mean) / bank.feat_std)
    dec = eng.predict(x)
    for c in np.unique(cells):
        rows = cells == c
        got = bank.cell_model(int(c)).decision_function(x[rows]).numpy()
        np.testing.assert_allclose(got, dec[rows], rtol=1e-5, atol=1e-5)


def test_bf16_bank_loads_without_ml_dtypes(tmp_path):
    """A bf16 bank saved by the reference restores in the port in a
    process where ``ml_dtypes`` cannot be imported (as on a machine
    without it): the tables come back as ``torch.bfloat16`` bits."""
    from repro.serve.model_bank import ModelBank as JBank
    j_bank = JBank.from_cells(*_cells(12), dtype="bf16")
    j_bank.save(str(tmp_path / "bank"))
    want = np.asarray(j_bank.sv).view(np.int16)
    np.save(tmp_path / "want.npy", want)
    code = textwrap.dedent(f"""
        import sys
        sys.modules["ml_dtypes"] = None          # any import now fails
        sys.path.insert(0, {os.path.abspath(SRC)!r})
        import numpy as np, torch
        from repro_torch.serve.model_bank import ModelBank
        from repro_torch.serve.svm_engine import SVMEngine
        b = ModelBank.load({str(tmp_path / "bank")!r})
        assert b.sv.dtype == torch.bfloat16, b.sv.dtype
        want = np.load({str(tmp_path / "want.npy")!r})
        assert np.array_equal(b.sv.view(torch.int16).numpy(), want)
        dec = SVMEngine(b, device="cpu").predict(
            np.zeros((3, 4), np.float32))
        assert np.isfinite(dec).all()
        assert "ml_dtypes" not in [m for m in sys.modules
                                   if sys.modules[m] is not None]
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
