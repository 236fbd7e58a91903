"""Declarative latency SLOs with rolling-window error-budget burn rates.

An SLO like "99% of requests under 20ms" (``SLO_P99_MS=20``) defines an
error budget: 1% of requests may be slower.  The operational signal is
not the raw miss count but the **burn rate** — the fraction of recent
requests over the threshold divided by the budget:

    burn_rate = bad_fraction(window) / (1 - percentile)

burn_rate 1.0 means the budget is being consumed exactly as provisioned;
3.0 means at this pace the period's budget is gone in a third of the
period (the standard SRE multi-window alerting quantity).

:class:`SLOTracker` keeps the window as coarse time buckets of good/bad
counts (``window_s / n_buckets`` resolution) so memory is O(n_buckets)
regardless of traffic, and the clock is injectable so tests drive it
deterministically (the ``tests/test_serve_async.py`` fake-clock idiom).
``poll()`` emits edge-triggered events — one ``slo_breach`` when the burn
rate crosses ``alert_burn_rate`` upward, one ``slo_recover`` when it
falls back — into a bounded ring, so a flapping service cannot grow
memory by being monitored.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.obs.trace import RingBuffer

_EVENTS_CAP = 256


@dataclasses.dataclass(frozen=True)
class SLOSpec:
    """Target percentile of ``name`` under ``threshold_ms``.

    ``percentile=0.0`` degenerates to "budget = everything": burn_rate
    equals the plain bad fraction — the form the deadline-miss-ratio
    tracker uses.
    """
    threshold_ms: float
    percentile: float = 0.99
    window_s: float = 60.0
    name: str = "serve.request_ms"

    def __post_init__(self):
        if not 0.0 <= self.percentile < 1.0:
            raise ValueError(f"percentile must be in [0, 1), "
                             f"got {self.percentile}")
        if self.threshold_ms < 0 or self.window_s <= 0:
            raise ValueError(f"need threshold_ms >= 0 and window_s > 0, "
                             f"got {self.threshold_ms}, {self.window_s}")

    @property
    def budget(self) -> float:
        """Allowed bad fraction (1 - percentile)."""
        return 1.0 - self.percentile


class SLOTracker:
    """Rolling-window burn-rate tracker for one :class:`SLOSpec`."""

    def __init__(self, spec: SLOSpec, *,
                 clock: Callable[[], float] = time.monotonic,
                 n_buckets: int = 12,
                 alert_burn_rate: float = 1.0):
        if n_buckets < 1:
            raise ValueError(f"n_buckets must be >= 1, got {n_buckets}")
        self.spec = spec
        self._clock = clock
        self._bucket_s = spec.window_s / n_buckets
        self._n_buckets = int(n_buckets)
        self.alert_burn_rate = float(alert_burn_rate)
        # (bucket_index, good, bad), oldest first; bounded by _evict
        self._buckets: List[List[int]] = []
        self.breached = False
        self.events = RingBuffer(_EVENTS_CAP)
        self.total_good = 0
        self.total_bad = 0

    # ------------------------------------------------------------ recording
    def record(self, latency_ms: float, now: Optional[float] = None) -> None:
        now = float(self._clock()) if now is None else float(now)
        idx = int(now // self._bucket_s)
        bad = latency_ms > self.spec.threshold_ms
        if self._buckets and self._buckets[-1][0] == idx:
            b = self._buckets[-1]
        else:
            self._evict(idx)
            self._buckets.append([idx, 0, 0])
            b = self._buckets[-1]
        b[2 if bad else 1] += 1
        if bad:
            self.total_bad += 1
        else:
            self.total_good += 1

    def _evict(self, idx: int) -> None:
        floor = idx - self._n_buckets + 1
        while self._buckets and self._buckets[0][0] < floor:
            self._buckets.pop(0)

    # ------------------------------------------------------------- querying
    def window_counts(self, now: Optional[float] = None) -> Tuple[int, int]:
        """(good, bad) inside the rolling window ending at ``now``."""
        now = float(self._clock()) if now is None else float(now)
        self._evict(int(now // self._bucket_s))
        good = sum(b[1] for b in self._buckets)
        bad = sum(b[2] for b in self._buckets)
        return good, bad

    def bad_fraction(self, now: Optional[float] = None) -> float:
        good, bad = self.window_counts(now)
        return bad / (good + bad) if good + bad else 0.0

    def burn_rate(self, now: Optional[float] = None) -> float:
        """Bad fraction over budget; 0.0 on an empty window."""
        budget = max(self.spec.budget, 1e-9)
        return self.bad_fraction(now) / budget

    def ok(self, now: Optional[float] = None) -> bool:
        return self.burn_rate(now) <= self.alert_burn_rate

    # --------------------------------------------------------------- events
    def poll(self, now: Optional[float] = None) -> List[Dict[str, Any]]:
        """Edge-triggered breach/recover detection; returns NEW events."""
        now = float(self._clock()) if now is None else float(now)
        rate = self.burn_rate(now)
        good, bad = self.window_counts(now)
        fresh: List[Dict[str, Any]] = []
        crossed_up = rate > self.alert_burn_rate and not self.breached
        crossed_down = rate <= self.alert_burn_rate and self.breached
        if crossed_up or crossed_down:
            self.breached = crossed_up
            ev = {"t": now,
                  "kind": "slo_breach" if crossed_up else "slo_recover",
                  "name": self.spec.name, "burn_rate": rate,
                  "threshold_ms": self.spec.threshold_ms,
                  "percentile": self.spec.percentile,
                  "window_good": good, "window_bad": bad}
            self.events.append(ev)
            fresh.append(ev)
        return fresh

    def state(self, now: Optional[float] = None) -> Dict[str, Any]:
        now = float(self._clock()) if now is None else float(now)
        good, bad = self.window_counts(now)
        return {"threshold_ms": self.spec.threshold_ms,
                "percentile": self.spec.percentile,
                "window_s": self.spec.window_s,
                "window_good": good, "window_bad": bad,
                "bad_fraction": bad / (good + bad) if good + bad else 0.0,
                "burn_rate": self.burn_rate(now),
                "breached": self.breached,
                "events_total": self.events.total,
                "total_good": self.total_good, "total_bad": self.total_bad}
