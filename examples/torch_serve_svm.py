"""Cell-routed SVM serving on the PyTorch/CUDA port: train -> bank ->
cold-start -> serve.

    PYTHONPATH=src python examples/torch_serve_svm.py           # the card
    PYTHONPATH=src python examples/torch_serve_svm.py --device cpu --n 600

The twin of ``examples/serve_svm.py`` through ``repro_torch``: a 3-class
OvA model with Voronoi cells, compacted into a ``ModelBank``, checkpointed
and cold-started into an ``SVMEngine`` that serves micro-batched traffic
(on the card one launch of the fused predict kernel a wave), a gamma
sweep over the cached wave D², the latency-bounded async stepper
(``engine.run(deadline_ms=...)``), the observability layer's per-stage
breakdown, a hot swap under live traffic, and the closed loop: a
``HealthMonitor`` sees a covariate shift on one cell and
``refresh_drifted`` re-solves only that cell before swapping it in.

It runs on the card unless ``--device cpu`` is given, and raises without
one.  The last line is one JSON object: requests submitted and served in
each act, and the accuracies.
"""
import argparse
import json
import tempfile
import time

import numpy as np

from repro_torch import obs
from repro_torch.data.synthetic import banana_mc, train_test_split
from repro_torch.kernels import runtime
from repro_torch.serve import ModelBank, SVMEngine
from repro_torch.tasks.builder import combine_decisions
from repro_torch.train.svm_trainer import LiquidSVM, SVMTrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device (default: the card)")
    ap.add_argument("--max-iters", type=int, default=300)
    ap.add_argument("--n", type=int, default=1200)
    ap.add_argument("--classes", type=int, default=3)
    ap.add_argument("--wave", type=int, default=128)
    ap.add_argument("--deadline-ms", type=float, default=2.0)
    args = ap.parse_args(argv)
    dev = str(runtime.resolve_device(args.device))    # raises without a card
    print(f"device: {dev}")
    summary = {"device": dev}

    obs.configure(trace=True)        # the CLI's -S TRACE=1, programmatically

    x, y = banana_mc(n=args.n, n_classes=args.classes, seed=0)
    xtr, ytr, xte, yte = train_test_split(x, y, 0.25, 0)

    print("== train (OvA, Voronoi cells) ==")
    est = LiquidSVM(SVMTrainerConfig(scenario="ova", n_folds=3,
                                     max_iters=args.max_iters,
                                     cell_method="voronoi", cell_size=300),
                    device=dev).fit(xtr, ytr)

    print("== compact into model bank ==")
    bank = est.to_bank()
    s = bank.stats()
    print(f"cells={s['n_cells']}  SVs {s['sv_raw']} -> {s['sv_live']} "
          f"(compaction {s['compaction']:.2f})  bytes={s['bytes']}")

    with tempfile.TemporaryDirectory() as ckpt:
        bank.save(ckpt)
        print(f"== cold-start engine from checkpoint ({ckpt}) ==")
        eng = SVMEngine(ModelBank.load(ckpt), device=dev)

        t0 = time.time()
        results = {}
        ids_all = []
        for lo in range(0, xte.shape[0], args.wave):
            ids_all.append(eng.submit(xte[lo:lo + args.wave]))
            results.update(eng.step())           # one batched launch per wave
        dt = time.time() - t0
        ids = np.concatenate(ids_all)
        dec = np.stack([results[int(i)] for i in ids])
        pred = combine_decisions(dec, bank.scenario, classes=bank.classes,
                                 pairs=bank.pairs, sub=bank.default_sub)
        acc = float((pred == yte).mean())
        print(f"served {len(ids)} requests in {dt * 1e3:.1f} ms "
              f"({len(ids) / dt:.0f} req/s)  accuracy={acc:.3f}")
        print("engine stats:", eng.stats())
        summary.update(submitted=int(xte.shape[0]), served=len(ids),
                       accuracy=acc)

        print("== gamma sweep over the cached wave D² (epilogue-only) ==")
        t0 = time.time()
        sweep = eng.sweep_gammas(np.logspace(0.5, -0.3, 8).astype(np.float32))
        print(f"8-gamma sweep of the last wave: {(time.time() - t0) * 1e3:.1f} ms "
              f"(shape {tuple(sweep.shape)})")

        print(f"== deadline-driven async loop (deadline={args.deadline_ms} ms) ==")
        # bursty arrivals: small ragged batches with idle gaps — fills are
        # rare, so most launches are forced by the latency bound while the
        # NEXT burst is admitted against the in-flight wave
        eng2 = SVMEngine(ModelBank.load(ckpt), device=dev,
                         deadline_ms=args.deadline_ms)
        rng = np.random.default_rng(0)

        def bursty():
            lo = 0
            while lo < xte.shape[0]:
                m = int(rng.integers(1, 16))
                yield xte[lo:lo + m]
                lo += m
                if rng.random() < 0.3:
                    time.sleep(args.deadline_ms * 1.5e-3)  # idle gap
                    yield None         # tick: lets the deadline fire
        t0 = time.time()
        results = eng2.run(bursty())
        dt = time.time() - t0
        stats = eng2.stats()
        dec2 = np.stack([results[i] for i in sorted(results)])
        pred2 = combine_decisions(dec2, bank.scenario, classes=bank.classes,
                                  pairs=bank.pairs, sub=bank.default_sub)
        print(f"served {len(results)} requests in {dt * 1e3:.1f} ms over "
              f"{stats['waves']} waves  accuracy={(pred2 == yte).mean():.3f}")
        summary.update(async_served=len(results),
                       async_accuracy=float((pred2 == yte).mean()))
        print(f"occupancy_mean={stats['occupancy_mean']:.2f}  "
              f"oldest_age_ms={stats['age_ms_max']:.2f}  "
              f"age_hist={stats['age_hist']}")

        print("== observability: where did the latency go? ==")
        # per-stage attribution for the whole run: queue (waiting for a
        # wave) / pack (plan + fill) / dispatch (device launch) / device
        # (the card's compute) / collect (blend + deliver)
        for stage, v in stats["per_stage"].items():
            print(f"  {stage:9s} total={v['total_ms']:8.2f} ms  "
                  f"mean={v['mean_ms']:6.3f} ms  n={v['count']}")
        # ... and for ONE request: every served response is attributable
        rid = sorted(results)[0]
        b = eng2.breakdown(rid)
        print(f"request {rid}: total={b['total_ms']:.3f} ms = "
              f"queue {b['queue_ms']:.3f} + pack {b['pack_ms']:.3f} + "
              f"dispatch {b['dispatch_ms']:.3f} + device {b['device_ms']:.3f} "
              f"+ collect {b['collect_ms']:.3f}  (wave {b['wave']})")
        # the tracer aggregated every instrumented site across the demo
        print("trace summary (per site):")
        for site, agg in obs.tracer.summary().items():
            print(f"  {site:24s} n={agg['count']:4d}  "
                  f"mean={agg['mean_s'] * 1e3:7.3f} ms  "
                  f"max={agg['max_s'] * 1e3:7.3f} ms")
        # both surfaces export as JSONL for offline tooling
        obs.tracer.write_jsonl(f"{ckpt}/trace.jsonl")
        obs.metrics.write_jsonl(f"{ckpt}/metrics.jsonl")
        assert obs.validate_jsonl(f"{ckpt}/metrics.jsonl") == []
        print(f"dumped trace.jsonl ({len(obs.tracer.spans)} spans) and "
              f"metrics.jsonl ({len(obs.metrics.names())} metrics)")

        print("== hot swap under traffic (versioned banks) ==")
        # v1: same fit, tighter compaction — a stand-in for any refreshed
        # bank (repro_torch.serve.refresh warm-starts only drifted cells).  The
        # swap is legal mid-flight: the in-flight wave finishes on v0, all
        # still-queued requests are re-routed against v1, and every
        # response is attributed to the version that served it.
        bank_v1 = est.to_bank(drop_tol=1e-2).with_version(1)
        eng3 = SVMEngine(ModelBank.load(ckpt), device=dev)
        results3 = {}
        batches = [xte[lo:lo + 16] for lo in range(0, xte.shape[0], 16)]
        for i, b in enumerate(batches):
            eng3.submit(b)
            if i == len(batches) // 2:
                info = eng3.swap_bank(bank_v1)       # mid-traffic, no drain
                print(f"swapped to v{info['version']} with "
                      f"{info['requeued']} queued requests re-routed")
            results3.update(eng3.step())
        while eng3.pending or eng3.in_flight:
            results3.update(eng3.step())
        st3 = eng3.stats()
        dec3 = np.stack([results3[i] for i in sorted(results3)])
        pred3 = combine_decisions(dec3, bank.scenario, classes=bank.classes,
                                  pairs=bank.pairs, sub=bank.default_sub)
        summary.update(swap_served=len(results3),
                       served_v0=st3.get("served_v0", 0),
                       served_v1=st3.get("served_v1", 0))
        print(f"served {len(results3)}/{xte.shape[0]} across the swap: "
              f"{st3.get('served_v0', 0)} on v0, "
              f"{st3.get('served_v1', 0)} on v1 — none dropped, "
              f"accuracy={(pred3 == yte).mean():.3f}")

        print("== closed loop: monitor -> drift -> refresh -> swap ==")
        # The health monitor watches two things the engine already
        # computes: per-request latency (SLO burn rate against
        # SLO_P99_MS) and per-cell routing distance, compared against the
        # train-time baseline every bank records at to_bank() time.  In
        # production the same loop runs as
        #   python -m repro_torch.cli serve --swap-watch \
        #       --feedback-data f.npy --feedback-labels fy.npy \
        #       -S SLO_P99_MS=20 -S DRIFT_REFRESH_THRESHOLD=3
        from repro_torch.serve import HealthMonitor, refresh_drifted
        tr, sel = est.train_result, est.select_result
        bank4 = sel.to_bank()
        eng4 = SVMEngine(bank4, device=dev)
        # SLO generous enough that first-wave kernel builds don't drown
        # the drift story (production serves warmed shapes; a demo does
        # not)
        mon = HealthMonitor(eng4, slo_p99_ms=500.0, drift_window_s=2.0,
                            drift_threshold=3.0, min_window_count=4)
        for lo in range(0, xte.shape[0], 32):      # in-distribution traffic
            eng4.submit(xte[lo:lo + 32])
            eng4.step()
        h = mon.health()
        print(f"in-dist verdict: status={h['status']}  "
              f"max_drift={h['drift']['max_score']:.2f}  "
              f"burn_rate={h['slo']['burn_rate']:.2f}")

        # inject covariate shift on ONE cell: push its queries outward from
        # the owning center to a squared distance 5 baseline-spreads past
        # the training median (they still route there, but land where only
        # the training tail did) — by the drift-score formula that pins
        # the score at ~5.0, past the 3.0 refresh threshold
        xs = (xte - bank4.feat_mean) / bank4.feat_std
        owner = eng4.route(xs)
        target = int(np.bincount(owner, minlength=bank4.n_cells).argmax())
        q50, q90, _n = bank4.route_baseline_arrays()
        d2_shift = q50[target] + 5.0 * max(q90[target] - q50[target],
                                           0.05 * q50[target])
        u = xs[owner == target] - bank4.centers[target]
        u /= np.maximum(np.linalg.norm(u, axis=1, keepdims=True), 1e-12)
        far_s = (bank4.centers[target] +
                 u * np.sqrt(d2_shift)).astype(np.float32)
        far_s = far_s[eng4.route(far_s) == target]
        far = (far_s * bank4.feat_std + bank4.feat_mean).astype(np.float32)
        for _ in range(3):
            eng4.submit(far)
            eng4.step()
        drifted = mon.drifted_cells()
        scores = mon.drift_scores()
        print(f"after shift on cell {target}: drifted={drifted}  "
              f"scores={ {c: round(s, 1) for c, s in scores.items()} }")

        # targeted refresh: feedback rows route back through the fit's own
        # plan, ONLY the drifted cells' columns re-solve (warm-started, at
        # the already-selected hyper-parameters), version bumps, hot swap
        y_feed = np.ones(far.shape[0], np.float32)
        bank5, info = refresh_drifted(tr, sel, far, y_feed, drifted,
                                      base_version=eng4.bank.version)
        print(f"refresh: {info['columns_resolved']} columns re-solved on "
              f"{info['drifted_slots']} cell(s) "
              f"({info['feedback_used']}/{info['feedback_rows']} feedback "
              f"rows routed there) -> bank v{bank5.version}")
        eng4.swap_bank(bank5)
        mon.reset_cells(drifted)                   # measure POST-refresh
        for lo in range(0, xte.shape[0], 32):      # traffic returns in-dist
            eng4.submit(xte[lo:lo + 32])
            eng4.step()
        h = mon.health()
        print(f"post-refresh verdict: status={h['status']}  "
              f"bank_version={h['bank_version']}  "
              f"max_drift={h['drift']['max_score']:.2f}")
        summary.update(drifted=[int(c) for c in drifted],
                       refreshed_version=int(bank5.version))
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
