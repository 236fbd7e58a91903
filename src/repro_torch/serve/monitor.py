"""Serving health monitor: drift scores, SLO burn rate, health verdicts
(the JAX package's ``serve/monitor.py``).

The consumer layer over the engine's raw signals (serving spans, counters
and per-stage breakdowns): it turns them into the three questions an
operator (or the closed loop in ``repro_torch.cli serve``) actually asks:

  1. **Is latency within SLO?** — an
     :class:`~repro_torch.obs.slo.SLOTracker`
     over per-request latency (``SLO_P99_MS``), plus a deadline-miss
     tracker against the engine's own ``deadline_ms``;
  2. **Has traffic drifted away from the training data?** — per-cell
     :class:`~repro_torch.obs.sketch.QuantileSketch` windows over the squared
     routing distance (query -> assigned center), compared against the
     train-time baseline the bank recorded at ``to_bank()`` time
     (``ModelBank.route_baseline``).  The score is a scale-free shift:

         score(cell) = (live_p50 - base_p50) / max(base_p90 - base_p50, eps)

     ~0 for in-distribution traffic, ~1 when the median live query sits
     where only the training tail did, and grows without bound as queries
     leave the cell's support — ``DRIFT_REFRESH_THRESHOLD`` (default 3)
     picks the refresh trigger point;
  3. **Is the engine shedding or overloaded?** — shed/served rates read
     from ``SVMEngine.stats()``.

Windows rotate on time (``DRIFT_WINDOW`` seconds, current + previous pane
— scores read the current pane once it has ``min_window_count``
observations, else the previous), and the monitor shares the ENGINE's
injectable clock by default, so the fake-clock test idiom drives both
deterministically.

Hook cost: the engine calls :meth:`observe_routing` once per admitted
batch and :meth:`observe_requests` once per collected wave — both
vectorized over rows — and a detached monitor costs the engine one
``is not None`` test per batch.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from repro_torch import obs
from repro_torch.obs.sketch import QuantileSketch
from repro_torch.obs.slo import SLOSpec, SLOTracker

# per-cell window sketches: small — drift reads p50 of a window, not p99
_CELL_EXACT_CAP = 512
_CELL_LEVEL_CAP = 64

# relative-scale floor for the drift denominator: a cell whose baseline
# spread collapsed (q90 ~= q50) must not turn measurement noise into
# unbounded scores
_SCALE_FLOOR_FRAC = 0.05


class HealthMonitor:
    """Attachable closed-loop health view over one :class:`SVMEngine`.

    Constructing the monitor attaches it (``engine.attach_monitor``); the
    engine then feeds routing distances and request latencies through the
    observe hooks.  ``clock=None`` shares the engine's clock.
    """

    def __init__(self, engine, *,
                 slo_p99_ms: Optional[float] = None,
                 slo: Optional[SLOSpec] = None,
                 drift_window_s: float = 10.0,
                 drift_threshold: float = 3.0,
                 min_window_count: int = 8,
                 clock: Optional[Callable[[], float]] = None,
                 metrics: Optional["obs.MetricsRegistry"] = None):
        if slo is not None and slo_p99_ms is not None:
            raise ValueError("pass slo_p99_ms or a full SLOSpec, not both")
        if drift_window_s <= 0:
            raise ValueError(f"drift_window_s must be > 0, "
                             f"got {drift_window_s}")
        self.engine = engine
        self._clock = engine._clock if clock is None else clock
        self._metrics = obs.metrics if metrics is None else metrics
        self.drift_window_s = float(drift_window_s)
        self.drift_threshold = float(drift_threshold)
        self.min_window_count = int(min_window_count)

        if slo_p99_ms is not None:
            slo = SLOSpec(threshold_ms=float(slo_p99_ms), percentile=0.99)
        self.slo: Optional[SLOTracker] = (
            None if slo is None else SLOTracker(slo, clock=self._clock))
        # deadline-miss ratio: percentile 0 -> burn_rate == bad fraction
        dl = engine.deadline_ms
        self.deadline: Optional[SLOTracker] = None
        if dl is not None:
            self.deadline = SLOTracker(
                SLOSpec(threshold_ms=float(dl), percentile=0.0,
                        window_s=self.drift_window_s * 6,
                        name="serve.deadline"),
                clock=self._clock)

        # routing-distance windows: cell -> sketch, current + previous pane
        self._cur: Dict[int, QuantileSketch] = {}
        self._prev: Dict[int, QuantileSketch] = {}
        self._win_start = float(self._clock())
        self._windows_rotated = 0
        # baseline cache keyed by bank version (swaps refresh it)
        self._baseline_version: Optional[int] = None
        self._baseline = None

        self._m_burn = self._metrics.gauge("serve.slo_burn_rate")
        self._m_breaches = self._metrics.counter("serve.slo_breaches")
        self._m_drift_max = self._metrics.gauge("serve.drift_score_max")
        self._m_alerts = self._metrics.counter("serve.drift_alerts")
        engine.attach_monitor(self)

    # ------------------------------------------------------------ observing
    def _rotate(self, now: float) -> None:
        if now - self._win_start >= self.drift_window_s:
            self._prev = self._cur
            self._cur = {}
            self._win_start = now
            self._windows_rotated += 1

    def observe_routing(self, cells: np.ndarray, d2: np.ndarray,
                        now: Optional[float] = None) -> None:
        """Fold one admitted batch's (cell id, squared routing distance)
        pairs into the current window.  Called by the engine under its
        clock; vectorized per distinct cell."""
        now = float(self._clock()) if now is None else float(now)
        self._rotate(now)
        cells = np.asarray(cells)
        for c in np.unique(cells):
            sk = self._cur.get(int(c))
            if sk is None:
                sk = QuantileSketch(f"cell{int(c)}", _CELL_EXACT_CAP,
                                    _CELL_LEVEL_CAP)
                self._cur[int(c)] = sk
            sk.observe_many(d2[cells == c])

    def observe_requests(self, total_ms: Sequence[float],
                         now: Optional[float] = None) -> None:
        """Fold one collected wave's completed-request latencies into the
        SLO and deadline trackers."""
        if self.slo is None and self.deadline is None:
            return
        now = float(self._clock()) if now is None else float(now)
        for ms in total_ms:
            if self.slo is not None:
                self.slo.record(ms, now=now)
            if self.deadline is not None:
                self.deadline.record(ms, now=now)

    # ---------------------------------------------------------------- drift
    def _baseline_arrays(self):
        bank = self.engine.bank
        v = int(bank.version)
        if self._baseline_version != v:
            self._baseline = bank.route_baseline_arrays()
            self._baseline_version = v
        return self._baseline

    def _window_sketch(self, cell: int) -> Optional[QuantileSketch]:
        sk = self._cur.get(cell)
        if sk is not None and sk.count >= self.min_window_count:
            return sk
        prev = self._prev.get(cell)
        if prev is not None and prev.count >= self.min_window_count:
            return prev
        return None

    def drift_scores(self, now: Optional[float] = None) -> Dict[int, float]:
        """Per-cell drift score for every cell with a usable window AND a
        recorded baseline.  Empty when the bank has no baseline (old
        banks): drift detection disables itself rather than guessing."""
        now = float(self._clock()) if now is None else float(now)
        self._rotate(now)
        base = self._baseline_arrays()
        if base is None:
            return {}
        q50, q90, n = base
        scores: Dict[int, float] = {}
        for cell in set(self._cur) | set(self._prev):
            if not 0 <= cell < q50.shape[0] or n[cell] == 0:
                continue
            sk = self._window_sketch(cell)
            if sk is None:
                continue
            b50, b90 = q50[cell], q90[cell]
            scale = max(b90 - b50, _SCALE_FLOOR_FRAC * max(b50, 1e-9), 1e-12)
            scores[cell] = float((sk.quantile(0.5) - b50) / scale)
        return scores

    def drifted_cells(self, now: Optional[float] = None) -> List[int]:
        """Cells whose drift score crosses the refresh threshold."""
        return sorted(c for c, s in self.drift_scores(now).items()
                      if s >= self.drift_threshold)

    def reset_cells(self, cells: Sequence[int]) -> None:
        """Drop the window state of refreshed cells so the next verdict
        measures post-refresh traffic, not the drift that triggered it."""
        for c in cells:
            self._cur.pop(int(c), None)
            self._prev.pop(int(c), None)

    # --------------------------------------------------------------- verdict
    def health(self, now: Optional[float] = None) -> Dict[str, Any]:
        """One structured verdict: ``status`` is "ok", "degraded" (drift
        over threshold or shedding) or "breaching" (SLO burn rate over its
        alert bar).  Updates the drift/SLO gauges and counters as a side
        effect — polling health IS the metrics heartbeat."""
        now = float(self._clock()) if now is None else float(now)
        stats = self.engine.stats()
        scores = self.drift_scores(now)
        drifted = sorted(c for c, s in scores.items()
                         if s >= self.drift_threshold)
        max_drift = max(scores.values()) if scores else 0.0
        self._m_drift_max.set(max_drift)
        if drifted:
            self._m_alerts.inc()

        submitted = stats.get("submitted", 0)
        shed_rows = stats.get("shed_rows", 0)
        shed_rate = shed_rows / max(submitted + shed_rows, 1)

        out: Dict[str, Any] = {
            "bank_version": stats["bank_version"],
            "drift": {"scores": scores, "drifted_cells": drifted,
                      "threshold": self.drift_threshold,
                      "max_score": max_drift,
                      "baseline": self._baseline_arrays() is not None,
                      "window_s": self.drift_window_s,
                      "windows_rotated": self._windows_rotated},
            "shed_rate": shed_rate,
            "served": stats.get("served", 0),
            "pending": stats.get("pending", 0),
        }
        breaching = False
        if self.slo is not None:
            for _ in self.slo.poll(now):
                self._m_breaches.inc()
            st = self.slo.state(now)
            self._m_burn.set(st["burn_rate"])
            out["slo"] = st
            breaching = st["breached"]
        if self.deadline is not None:
            dst = self.deadline.state(now)
            out["deadline_miss_ratio"] = dst["bad_fraction"]
            out["deadline"] = dst
        out["status"] = ("breaching" if breaching
                         else "degraded" if drifted or shed_rate > 0.01
                         else "ok")
        return out
