"""The port's serving slice against the JAX package, on the CPU.

Two kinds of test:

  * **parity** — the same numpy cell batch goes through ``repro`` and
    ``repro_torch``.  Host-side integer and table results must be EQUAL:
    compaction (``sv``/``coefs``/``sv_count``/``route_baseline``, bf16
    bits included), ``plan_wave``, ``route`` and ``route_top2``.  Decisions
    must agree within ``DEC_TOL``: on these banks the port (fused or not)
    differs from the reference engine by at most 1.3e-5 on decisions up to
    ~4.3 (GEMM-form D² in f32, summed in another order), and the
    reference's own fused-vs-cached gap on the same banks is the same
    1.3e-5 (see also ROADMAP C2).  ``DEC_TOL`` = 1e-5 relative to the
    largest decision (~4.3e-5 here).
  * **promises** — the reference's own serving guarantees, re-proved inside
    the port (adapted from ``tests/test_serve_async.py``): async drain ==
    sync drain bitwise; blend weights exactly (0.5, 0.5) and (1, 0);
    every request served exactly once under deadlines and a mid-run
    ``swap_bank``; the per-stage breakdown sums to ``total_ms``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.distributed.planner import plan_wave as j_plan_wave  # noqa: E402
from repro.pipeline.assign import nearest_top2_dists as j_top2  # noqa: E402
from repro.serve.model_bank import ModelBank as JBank  # noqa: E402
from repro.serve.model_bank import _dedup_rows as j_dedup  # noqa: E402
from repro.serve.svm_engine import SVMEngine as JEngine  # noqa: E402
from repro.tasks.builder import combine_decisions as j_combine  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.distributed.planner import plan_wave  # noqa: E402
from repro_torch.pipeline.assign import _top2_chunk, nearest_top2_dists  # noqa: E402
from repro_torch.serve import (ModelBank, OverloadError, SVMEngine,  # noqa: E402
                               bank_from_reference, blend_weights)
from repro_torch.serve.model_bank import _dedup_rows  # noqa: E402
from repro_torch.tasks.builder import combine_decisions  # noqa: E402
from repro_torch.testing import faults  # noqa: E402

DEC_TOL = 1e-5
CPU = "cpu"


def _cells(seed=0, n_cells=4, k=40, d=6, t_count=2, s_count=3, zero_frac=0.4):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_cells, d)).astype(np.float32) * 4
    sv = (centers[:, None, :] + rng.normal(size=(n_cells, k, d))).astype(np.float32)
    sv[:, 5] = sv[:, 2]                                 # duplicate SV rows
    coefs = rng.normal(size=(n_cells, k, t_count, s_count)).astype(np.float32)
    coefs[rng.random((n_cells, k)) < zero_frac] = 0.0
    gamma = rng.uniform(0.5, 3.0,
                        size=(n_cells, t_count, s_count)).astype(np.float32)
    mask = np.ones((n_cells, k), np.float32)
    mask[:, -3:] = 0.0                                  # padded raw rows
    queries = (centers[rng.integers(0, n_cells, 30)]
               + rng.normal(size=(30, d)) * 1.5).astype(np.float32)
    return (sv, mask, coefs, gamma, centers), queries


def _tol(want):
    return DEC_TOL * max(1.0, float(np.abs(want).max()))


def _ref_arrays(bank):
    return {f.name: getattr(bank, f.name) for f in dataclasses.fields(bank)
            if f.name not in bank._META_KEYS}


# ------------------------------------------------------------------ parity
class TestBankParity:
    @pytest.mark.parametrize("kw", [
        {}, {"drop_tol": None, "dedup": False}, {"drop_tol": 0.5},
        {"routing": "overlap", "pad_multiple": 16}])
    def test_from_cells_tables_equal(self, kw):
        cells, _ = _cells(seed=1)
        tb = ModelBank.from_cells(*cells, **kw)
        jb = JBank.from_cells(*cells, **kw)
        for f in ("sv", "coefs", "gammas", "sv_count", "centers", "feat_mean",
                  "feat_std", "classes", "pairs"):
            np.testing.assert_array_equal(np.asarray(getattr(tb, f)),
                                          np.asarray(getattr(jb, f)))
        assert tb.route_baseline == jb.route_baseline
        assert tb.stats() == jb.stats()
        assert tb.with_version(3).version == 3

    def test_bf16_tables_equal_bits(self):
        cells, _ = _cells(seed=2)
        tb = ModelBank.from_cells(*cells, dtype="bf16")
        jb = JBank.from_cells(*cells, dtype="bf16")
        for f in ("sv", "coefs"):
            got = getattr(tb, f)
            assert got.dtype == torch.bfloat16
            np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                          np.asarray(getattr(jb, f)).view(np.int16))
        assert tb.stats() == jb.stats()
        assert tb.nbytes == jb.nbytes

    def test_dedup_rows_equal(self):
        rng = np.random.default_rng(3)
        sv = rng.normal(size=(9, 4)).astype(np.float32)
        sv[[4, 7]] = sv[1]
        sv[8] = sv[0]
        co = rng.normal(size=(9, 3)).astype(np.float32)
        for a, b in zip(_dedup_rows(sv, co), j_dedup(sv, co)):
            np.testing.assert_array_equal(a, b)

    def test_bank_from_reference_serves_the_same_decisions(self):
        cells, q = _cells(seed=4)
        for dtype in ("f32", "bf16"):
            jb = JBank.from_cells(*cells, dtype=dtype, routing="overlap",
                                  version=5)
            conv = bank_from_reference(
                _ref_arrays(jb), {k: getattr(jb, k) for k in jb._META_KEYS})
            native = ModelBank.from_cells(*cells, dtype=dtype,
                                          routing="overlap", version=5)
            assert conv.stats() == native.stats()
            a = SVMEngine(conv, device=CPU).predict(q)
            b = SVMEngine(native, device=CPU).predict(q)
            np.testing.assert_array_equal(a, b)
            want = JEngine(jb, fused=False).predict(q)
            np.testing.assert_allclose(a, want, atol=_tol(want))


class TestRoutingAndPlanParity:
    @pytest.mark.parametrize("seed", range(4))
    def test_plan_wave_equal(self, seed):
        rng = np.random.default_rng(seed)
        counts = rng.poisson(4.0, size=50)
        counts[rng.integers(0, 50)] = 300                   # one viral cell
        for kw in ({}, {"m_pad": 8}, {"row_bucket": 16, "slot_bucket": 8}):
            a, b = plan_wave(counts, **kw), j_plan_wave(counts, **kw)
            for f in ("slot_cell", "slot_off", "slot_take"):
                np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
            assert a.m_pad == b.m_pad

    def test_route_and_route_top2_equal(self):
        cells, q = _cells(seed=5, n_cells=7)
        tb = ModelBank.from_cells(*cells)
        jb = JBank.from_cells(*cells)
        te, je = SVMEngine(tb, device=CPU), JEngine(jb, fused=False)
        np.testing.assert_array_equal(te.route(q), je.route(q))
        for a, b in zip(te.route_top2(q), je.route_top2(q)):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(nearest_top2_dists(q, tb.centers, chunk_size=7),
                        j_top2(q, jb.centers)):
            np.testing.assert_array_equal(a, b)

    @pytest.mark.parametrize("scenario", ["binary", "ova", "ava", "quantile",
                                          "ls"])
    def test_combine_decisions_equal(self, scenario):
        rng = np.random.default_rng(6)
        dec = rng.normal(size=(11, 3, 2)).astype(np.float32)
        kw = {"classes": np.array([2.0, 5.0, 7.0], np.float32),
              "pairs": np.array([[0, 1], [0, 2], [1, 2]], np.int32)}
        np.testing.assert_array_equal(
            combine_decisions(dec, scenario, sub=1, **kw),
            j_combine(dec, scenario, sub=1, **kw))


class TestEngineParity:
    @pytest.mark.parametrize("routing", ["nearest", "overlap"])
    @pytest.mark.parametrize("fused", [False, True])
    def test_predict_matches_reference(self, routing, fused):
        cells, q = _cells(seed=7)
        tb = ModelBank.from_cells(*cells, routing=routing)
        jb = JBank.from_cells(*cells, routing=routing)
        got = SVMEngine(tb, device=CPU, fused=fused).predict(q)
        want = JEngine(jb, fused=False).predict(q)
        assert got.shape == want.shape == (30, 2, 3)
        np.testing.assert_allclose(got, want, atol=_tol(want))

    def test_sweep_gammas_matches_reference(self):
        cells, q = _cells(seed=8)
        tb = ModelBank.from_cells(*cells)
        jb = JBank.from_cells(*cells)
        te, je = SVMEngine(tb, device=CPU), JEngine(jb, fused=False)
        te.predict(q)
        je.predict(q)
        g = np.asarray([0.5, 1.0, 2.0], np.float32)
        got = te.sweep_gammas(g)
        want = np.asarray(je.sweep_gammas(g))
        assert isinstance(got, torch.Tensor) and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, atol=_tol(want))
        assert te.counters["d2_misses"] == 1                 # no new cross term

    def test_fused_sweep_builds_d2_once_and_agrees(self):
        cells, q = _cells(seed=9)
        bank = ModelBank.from_cells(*cells)
        fused = SVMEngine(bank, device=CPU, fused=True)
        cached = SVMEngine(bank, device=CPU, fused=False)
        np.testing.assert_allclose(fused.predict(q), cached.predict(q),
                                   atol=_tol(cached.predict(q)))
        g = np.asarray([0.7, 1.4], np.float32)
        np.testing.assert_allclose(fused.sweep_gammas(g).numpy(),
                                   cached.sweep_gammas(g).numpy(), atol=1e-6)
        assert fused.counters["d2_misses"] == 1

    def test_bf16_cache_bounds_error_and_halves_bytes(self):
        cells, q = _cells(seed=10)
        bank = ModelBank.from_cells(*cells)
        e32 = SVMEngine(bank, device=CPU, fused=False, cache_dtype="f32")
        e16 = SVMEngine(bank, device=CPU, fused=False, cache_dtype="bf16")
        d32, d16 = e32.predict(q), e16.predict(q)
        assert e16.stats()["cached_d2_bytes"] * 2 == \
            e32.stats()["cached_d2_bytes"]
        amp = np.abs(bank.coefs).sum(1).max()
        assert np.abs(d16 - d32).max() <= np.exp(-1.0) * 2.0 ** -8 * amp * 1.05
        jd16 = JEngine(JBank.from_cells(*cells), fused=False,
                       cache_dtype="bf16").predict(q)
        np.testing.assert_allclose(d16, jd16, atol=_tol(jd16) + 2.0 ** -8)

    def test_repeat_wave_hits_d2_cache(self):
        cells, q = _cells(seed=11)
        eng = SVMEngine(ModelBank.from_cells(*cells), device=CPU, fused=False)
        first, second = eng.predict(q), eng.predict(q)
        assert eng.counters["d2_misses"] == 1 and eng.counters["d2_hits"] == 1
        np.testing.assert_array_equal(first, second)

    @pytest.mark.parametrize("fused", [False, True])
    def test_ava_bank_wider_than_64_columns_matches_reference(self, fused):
        """All-vs-all over 12 classes: 66 pair columns, more than one of the
        fused kernel's 64-column blocks.  The port serves it (both paths)
        with the reference engine's decisions and labels."""
        cells, q = _cells(seed=18, t_count=66, s_count=1)
        pairs = np.array([(i, j) for i in range(12) for j in range(i + 1, 12)],
                         np.int32)
        kw = {"scenario": "ava", "pairs": pairs,
              "classes": np.arange(12, dtype=np.float32)}
        eng = SVMEngine(ModelBank.from_cells(*cells, **kw), device=CPU,
                        fused=fused)
        jeng = JEngine(JBank.from_cells(*cells, **kw), fused=False)
        got, want = eng.predict(q), jeng.predict(q)
        assert got.shape == want.shape == (30, 66, 1)
        np.testing.assert_allclose(got, want, atol=_tol(want))
        np.testing.assert_array_equal(eng.predict_label(q),
                                      jeng.predict_label(q))

    def test_wave_d2_cache_is_lru_bounded(self):
        cells, q = _cells(seed=19)
        eng = SVMEngine(ModelBank.from_cells(*cells), device=CPU, fused=False,
                        max_cached_d2=2)
        first = eng.predict(q[:10])
        eng.predict(q[10:20])
        eng.predict(q[20:])
        assert eng.stats()["cached_d2_waves"] == 2
        np.testing.assert_array_equal(eng.predict(q[:10]), first)
        assert eng.counters["d2_misses"] == 4         # the first was evicted
        eng.predict(q[20:])
        assert eng.counters["d2_hits"] == 1

    def test_predict_label_matches_reference(self):
        cells, q = _cells(seed=12, t_count=3, s_count=1)
        kw = {"scenario": "ova",
              "classes": np.array([1.0, 2.0, 3.0], np.float32)}
        got = SVMEngine(ModelBank.from_cells(*cells, **kw),
                        device=CPU).predict_label(q)
        want = JEngine(JBank.from_cells(*cells, **kw),
                       fused=False).predict_label(q)
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------- promises
_BANKS: dict = {}


def _bank(seed, n_cells=3, routing="overlap"):
    key = (seed, n_cells, routing)
    if key not in _BANKS:
        k, d, t_count = 16, 4, 2
        rng = np.random.default_rng(seed)
        centers = rng.normal(size=(n_cells, d)).astype(np.float32) * 4.0
        sv = (centers[:, None, :]
              + rng.normal(size=(n_cells, k, d))).astype(np.float32)
        coefs = rng.normal(size=(n_cells, k, t_count, 1)).astype(np.float32)
        gamma = rng.uniform(0.5, 3.0, size=(n_cells, t_count, 1)).astype(np.float32)
        bank = ModelBank.from_cells(sv, np.ones((n_cells, k), np.float32),
                                    coefs, gamma, centers, routing=routing)
        pool = (centers[rng.integers(0, n_cells, 64)]
                + rng.normal(size=(64, d)) * 1.5).astype(np.float32)
        _BANKS[key] = (bank, pool)
    return _BANKS[key]


def _batches(rng, pool, n_batches):
    return [pool[rng.integers(0, pool.shape[0], int(rng.integers(1, 13)))]
            for _ in range(n_batches)]


def _engine(bank, **kw):
    return SVMEngine(bank, device=CPU, metrics=obs.MetricsRegistry(), **kw)


class TestAsyncConformance:
    @pytest.mark.parametrize("seed", range(6))
    @pytest.mark.parametrize("fused", [False, True])
    def test_async_bitwise_equals_sync_drain(self, seed, fused):
        bank, pool = _bank(seed % 3)
        rng = np.random.default_rng(seed)
        batches = _batches(rng, pool, int(rng.integers(2, 5)))
        overlap = bool(seed % 2)
        sync_eng = _engine(bank, fused=fused, overlap=overlap)
        sync = {}
        for b in batches:
            sync_eng.submit(b)
            sync.update(sync_eng.step())
        eng = _engine(bank, fused=fused, overlap=overlap)
        got = {}
        for i, b in enumerate(batches):
            eng.submit(b)
            if i > 0:
                got.update(eng.finish_step())      # collect wave i-1 ...
            eng.begin_step()                       # ... dispatch wave i
        got.update(eng.finish_step())
        assert sorted(got) == sorted(sync)
        for rid in sync:
            np.testing.assert_array_equal(got[rid], sync[rid])

    def test_submit_while_in_flight_lands_in_next_wave(self):
        bank, pool = _bank(1)
        rng = np.random.default_rng(1)
        b0, b1 = _batches(rng, pool, 2)
        eng = _engine(bank)
        ids0 = eng.submit(b0)
        eng.begin_step()
        ids1 = eng.submit(b1)
        assert set(eng.finish_step()) == set(map(int, ids0))
        assert set(eng.step()) == set(map(int, ids1))


class TestOverlapBlending:
    def test_equal_weights_exact(self):
        """Duplicated centers: every query is exactly equidistant, weights
        are exactly (0.5, 0.5), and the blend is BITWISE 0.5*(a + b) of the
        single-cell decisions at the same padded launch shapes."""
        rng = np.random.default_rng(7)
        k, d, p = 16, 4, 2
        center = rng.normal(size=(1, d)).astype(np.float32)
        centers = np.repeat(center, 2, axis=0)
        sv = rng.normal(size=(2, k, d)).astype(np.float32) + center
        coefs = rng.normal(size=(2, k, p, 1)).astype(np.float32)
        gamma = rng.uniform(0.5, 2.0, size=(2, p, 1)).astype(np.float32)
        mask = np.ones((2, k), np.float32)
        bank = ModelBank.from_cells(sv, mask, coefs, gamma, centers,
                                    routing="overlap")
        q = (center + rng.normal(size=(8, d))).astype(np.float32)
        eng = _engine(bank, fused=False, row_bucket=8)
        dec = eng.predict(q)
        assert eng.counters["steps"] == 1              # both parts, one wave
        c1, c2, d1, d2 = nearest_top2_dists(q, centers)
        assert (d1 == d2).all() and (c1 == 0).all() and (c2 == 1).all()
        w1, w2 = blend_weights(d1, d2)
        assert (w1 == np.float32(0.5)).all() and (w2 == np.float32(0.5)).all()
        single = []
        for c in (0, 1):                              # one-cell bank per cell
            one = ModelBank.from_cells(sv[c:c + 1], mask[c:c + 1],
                                       coefs[c:c + 1], gamma[c:c + 1],
                                       centers[c:c + 1])
            single.append(_engine(one, fused=False, row_bucket=8).predict(q))
        want = np.float32(0.5) * single[0] + np.float32(0.5) * single[1]
        np.testing.assert_array_equal(dec, want)

    def test_far_second_cell_weights_exactly_one_zero(self):
        w1, w2 = blend_weights(np.float32([1.0, 3.0]), np.float32([500.0, 3.0]))
        assert w1[0] == np.float32(1.0) and w2[0] == np.float32(0.0)
        assert w1[1] == np.float32(0.5) and w2[1] == np.float32(0.5)
        bank, _ = _bank(2)
        c = bank.centers
        q = (c[:1] + 0.01).astype(np.float32)          # deep inside cell 0
        eng = _engine(bank)
        eng.submit(q)
        assert eng.pending == 1                        # a single part

    def test_nearest_bank_serves_exact_1nn(self):
        bank_o, _ = _bank(5)
        bank_n = dataclasses.replace(bank_o, routing="nearest")
        rng = np.random.default_rng(5)
        c = bank_o.centers
        q = (np.concatenate([(c[[0]] + c[[1]]) / 2, (c[[1]] + c[[2]]) / 2])
             + rng.normal(size=(2, c.shape[1])) * 0.05).astype(np.float32)
        eng = _engine(bank_n)
        assert not eng.overlap
        dec = eng.predict(q)
        ref = _engine(bank_o, overlap=False).predict(q)
        np.testing.assert_array_equal(dec, ref)
        assert np.abs(_engine(bank_o).predict(q) - dec).max() > 0

    def test_single_cell_bank_falls_back_to_1nn(self):
        bank, pool = _bank(6, n_cells=1, routing="nearest")
        eng = _engine(dataclasses.replace(bank, routing="overlap"))
        assert not eng.overlap
        assert eng.counters["routing_degraded"] == 1
        assert np.isfinite(eng.predict(pool[:4])).all()

    def test_top2_tie_break_lowest_index(self):
        rng = np.random.default_rng(11)
        c = rng.normal(size=(1, 3)).astype(np.float32)
        centers = np.concatenate([c, c, c + 10.0])
        x = (c + rng.normal(size=(9, 3))).astype(np.float32)
        nn1, nn2, d1, d2 = _top2_chunk(x.copy(), centers)
        assert (nn1 == 0).all() and (nn2 == 1).all()
        np.testing.assert_array_equal(d1, d2)


class TestConservation:
    @pytest.mark.parametrize("seed", range(4))
    def test_every_request_served_exactly_once(self, seed):
        bank, pool = _bank(seed % 3)
        rng = np.random.default_rng(seed)
        eng = _engine(bank, overlap=bool(seed % 2))
        submitted, served = set(), []
        for _ in range(int(rng.integers(6, 16))):
            op = rng.integers(0, 4)
            if op == 0:
                b = pool[rng.integers(0, 64, int(rng.integers(1, 9)))]
                submitted.update(int(i) for i in eng.submit(b))
            elif op == 1 and not eng.in_flight:
                eng.begin_step()
            elif op == 2:
                served.extend(eng.finish_step())
            else:
                served.extend(eng.step())
        while eng.pending or eng.in_flight:
            served.extend(eng.step())
        assert len(served) == len(set(served))
        assert set(served) == submitted
        assert eng.counters["served"] == eng.counters["submitted"]

    @pytest.mark.parametrize("seed,deadline_ms", [(0, 1.0), (1, 7.5), (2, 50.0)])
    def test_run_conserves_requests_under_deadlines(self, seed, deadline_ms):
        bank, pool = _bank(seed % 3)
        rng = np.random.default_rng(seed)
        clk = [0.0]
        eng = _engine(bank, deadline_ms=deadline_ms, clock=lambda: clk[0])
        expect = 0

        def traffic():
            nonlocal expect
            for _ in range(int(rng.integers(3, 12))):
                clk[0] += float(rng.uniform(0.0, 0.02))
                if rng.random() < 0.7:
                    b = pool[rng.integers(0, 64, int(rng.integers(1, 9)))]
                    expect += b.shape[0]
                    yield b
                else:
                    yield None

        results = eng.run(traffic())
        assert sorted(results) == list(range(expect))
        assert eng.pending == 0 and not eng.in_flight

    @pytest.mark.parametrize("seed", range(3))
    def test_swap_mid_run_serves_every_request_exactly_once(self, seed):
        bank0, pool = _bank(seed % 3)
        banks = {0: bank0,
                 1: dataclasses.replace(bank0, coefs=-bank0.coefs, version=1),
                 2: dataclasses.replace(bank0, coefs=2.0 * bank0.coefs,
                                        version=2)}
        rng = np.random.default_rng(seed)
        eng = _engine(bank0, overlap=bool(seed % 2))
        submitted, served, next_v = {}, {}, 1
        for _ in range(int(rng.integers(8, 20))):
            op = rng.integers(0, 5)
            if op == 0:
                b = pool[rng.integers(0, 64, int(rng.integers(1, 9)))]
                for i, rid in enumerate(map(int, eng.submit(b))):
                    submitted[rid] = b[i]
            elif op == 1 and not eng.in_flight:
                eng.begin_step()
            elif op == 2:
                served.update(eng.finish_step())
            elif op == 3 and next_v <= 2:
                eng.swap_bank(banks[next_v])
                next_v += 1
            else:
                served.update(eng.step())
        while eng.pending or eng.in_flight:
            served.update(eng.step())
        assert set(served) == set(submitted)
        assert sum(eng.counters.get(f"served_v{v}", 0) for v in banks) == \
            len(served)
        by_v: dict = {}
        for rid in served:
            by_v.setdefault(eng.served_version[rid], []).append(rid)
        for v, rids in by_v.items():
            want = _engine(banks[v], overlap=bool(seed % 2)).predict(
                np.stack([submitted[r] for r in rids]))
            for j, r in enumerate(rids):
                np.testing.assert_allclose(served[r], want[j], atol=1e-5)

    def test_swap_rejects_older_version_and_shape_change(self):
        bank, pool = _bank(3)
        eng = _engine(bank)
        with pytest.raises(ValueError):
            eng.swap_bank(bank)                       # not strictly newer
        eng.swap_bank(bank, force=True)
        assert eng.counters["bank_fallbacks"] == 1
        other, _ = _bank(3, n_cells=2)
        with pytest.raises(ValueError):
            eng.swap_bank(dataclasses.replace(
                other, centers=other.centers[:, :2], version=9))

    def test_overload_sheds_whole_batch(self):
        bank, pool = _bank(4, routing="nearest")
        eng = _engine(bank, max_queue=10)
        eng.submit(pool[:8])
        with pytest.raises(OverloadError):
            eng.submit(pool[:8])
        assert eng.pending == 8 and eng.counters["shed_rows"] == 8
        assert len(eng.step()) == 8

    def test_stale_backlog_sheds_new_admissions(self):
        bank, pool = _bank(4, routing="nearest")
        clk = [0.0]
        eng = _engine(bank, shed_ms=10.0, clock=lambda: clk[0])
        eng.submit(pool[:3])
        clk[0] += 0.009
        eng.submit(pool[3:5])                         # 9 ms old: admitted
        clk[0] += 0.002
        with pytest.raises(OverloadError):
            eng.submit(pool[5:9])                     # 11 ms old: shed
        assert eng.counters["shed_stale"] == 1 and eng.pending == 5
        assert len(eng.step()) == 5
        eng.submit(pool[5:9])                         # drained: admitted
        assert eng.pending == 4

    def test_injected_fault_at_swap_leaves_engine_serving(self):
        bank, pool = _bank(4)
        eng = _engine(bank)
        ids = eng.submit(pool[:5])
        with faults.armed("engine.swap"):
            with pytest.raises(faults.InjectedFault):
                eng.swap_bank(bank.with_version(1))
        assert set(eng.step()) == set(map(int, ids))


class TestLatencyAccounting:
    def test_deadline_forces_partial_launch(self):
        bank, pool = _bank(13)
        clk = [0.0]
        eng = _engine(bank, deadline_ms=5.0, clock=lambda: clk[0])

        def traffic():
            yield pool[:3]
            clk[0] += 0.004
            yield None
            assert eng.stats().get("waves", 0) == 0
            clk[0] += 0.002
            yield None

        assert len(eng.run(traffic())) == 3
        stats = eng.stats()
        assert stats["waves"] == 1 and stats["age_ms_max"] >= 5.0
        assert sum(stats["age_hist"]) == eng.counters["served_rows"]

    def test_fill_rows_launches_without_a_deadline(self):
        bank, pool = _bank(13)
        eng = _engine(bank, overlap=False, fill_rows=6)
        eng.submit(pool[:5])
        assert not eng.should_launch()
        eng.submit(pool[5:6])
        assert eng.should_launch()
        default = _engine(bank)
        assert default.fill_rows == default.row_bucket * default.slot_bucket

    def test_every_served_response_has_an_exact_breakdown(self):
        bank, pool = _bank(13)
        eng = _engine(bank)
        ids = eng.submit(pool[:10])
        results = eng.step()
        assert set(results) == set(int(i) for i in ids)
        for rid in results:
            b = eng.breakdown(rid)
            parts = (b["queue_ms"] + b["pack_ms"] + b["dispatch_ms"]
                     + b["device_ms"] + b["collect_ms"])
            assert parts == pytest.approx(b["total_ms"], abs=1e-6)
        assert eng.breakdown(10 ** 9) is None
        (w,) = eng.wave_stats
        assert w["n_rows"] == sum(w["age_hist"]) and w["wave"] == 0
        assert set(eng.stats()["per_stage"]) == {"queue", "pack", "dispatch",
                                                 "device", "collect"}


class TestObsParity:
    """The copied instruments write what the JAX package's readers accept."""

    def test_engine_metrics_and_trace_validate_against_both_schemas(
            self, tmp_path):
        from repro.obs.metrics import validate_jsonl as j_validate
        from repro.obs.trace import validate_trace_jsonl as j_validate_trace
        bank, pool = _bank(14)
        reg = obs.MetricsRegistry()
        tracer = obs.Tracer(enabled=True)
        eng = SVMEngine(bank, device=CPU, metrics=reg, tracer=tracer)
        eng.predict(pool[:20])
        reg.write_jsonl(str(tmp_path / "m.jsonl"))
        tracer.write_jsonl(str(tmp_path / "t.jsonl"))
        for validate in (obs.validate_jsonl, j_validate):
            assert validate(str(tmp_path / "m.jsonl")) == []
        for validate in (obs.validate_trace_jsonl, j_validate_trace):
            assert validate(str(tmp_path / "t.jsonl")) == []
        assert reg.counter("serve.served").value == 20
        assert {"serve.route", "serve.pack", "serve.device"} <= set(
            tracer.summary())

    def test_quantile_sketch_state_equals_reference(self):
        from repro.obs.sketch import QuantileSketch as JSketch
        vals = np.random.default_rng(15).lognormal(size=5000)
        a = obs.QuantileSketch("x", exact_cap=256, level_cap=64)
        b = JSketch("x", exact_cap=256, level_cap=64)
        a.observe_many(vals)
        b.observe_many(vals)
        assert a.to_json() == b.to_json()

    def test_profiler_hooks_are_noops_unless_configured(self, tmp_path):
        from repro_torch.obs import profiler
        assert not profiler.start()
        with profiler.step("serve_wave", 0):
            pass
        obs.configure(profile_dir=str(tmp_path))
        try:
            assert profiler.start() and profiler.active()
            with profiler.step("serve_wave", 1):
                torch.ones(4).sum()
            assert profiler.stop() and not profiler.active()
            assert list(tmp_path.glob("trace_*.json"))
        finally:
            obs.reset()


def test_attach_monitor_hook_feeds_routing_and_latency():
    """The monitor stays a hook: an attached object sees every routed row's
    primary-center distance and every completed request's latency;
    detaching with ``None`` stops both."""
    class Recorder:
        def __init__(self):
            self.rows, self.requests = 0, 0

        def observe_routing(self, cells, d2, now):
            assert cells.shape == d2.shape and (d2 >= 0).all()
            self.rows += cells.shape[0]

        def observe_requests(self, totals, now):
            self.requests += len(totals)

    bank, pool = _bank(16)
    eng = _engine(bank)
    rec = Recorder()
    eng.attach_monitor(rec)
    eng.predict(pool[:12])
    assert (rec.rows, rec.requests) == (12, 12)
    eng.attach_monitor(None)
    eng.predict(pool[:5])
    assert (rec.rows, rec.requests) == (12, 12)
