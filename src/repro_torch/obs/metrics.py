"""Typed metrics registry: counters, gauges, fixed-bucket histograms.

The repo's telemetry used to be an ad-hoc scatter — ``collections.Counter``
in the engine, an unbounded ``wave_stats`` list, a module-global fallback
log in ``train/checkpoint`` — with no shared export path.  This registry is
the one place process-wide operational numbers accumulate; the existing
dict surfaces (``SVMEngine.stats()``, ``refresh_bank`` info) stay intact
as views on top of it.

Metric types
  * :class:`Counter`   — monotonically increasing float/int total
  * :class:`Gauge`     — last-written value (e.g. ``checkpoint.save_mbps``)
  * :class:`Histogram` — fixed bucket upper edges, counts per bucket plus
    one overflow bucket, running sum/count (latency distributions; buckets
    are fixed at creation so merged/exported histograms always line up)
  * :class:`QuantileSketch` (``obs.sketch``) — mergeable online quantile
    sketch: exact order statistics below a sample cap, KLL-style
    bounded-rank-error compaction above it, the bound itself tracked and
    exported.  This is where TRUE p50/p95/p99 come from; the fixed-bucket
    histogram stays for bucket-aligned dashboards.

JSONL schema (``repro.obs.metrics.v1``) — what :meth:`MetricsRegistry.
write_jsonl` emits, :func:`validate_jsonl` checks, and the tier-1 CLI
metrics smoke pins:

  line 1:   {"schema": "repro.obs.metrics.v1", "unix_time": <float>}
  counter:  {"name": str, "type": "counter", "value": number}
  gauge:    {"name": str, "type": "gauge", "value": number}
  histogram:{"name": str, "type": "histogram", "buckets": [edges...],
             "counts": [len(edges)+1 ints], "sum": number, "count": int}
  sketch:   {"name": str, "type": "sketch", "count": int, "sum": number,
             "rank_error": int, "exact_cap": int, "level_cap": int,
             "levels": [[number...]...], "q": {...}?}
            (invariant: sum(len(levels[i]) * 2**i) == count)

Names are dot-separated sites mirroring the tracer/faults idiom
(``serve.request_ms``, ``checkpoint.fallback_steps``).  Well-known names
are listed in :data:`WELL_KNOWN` — emitters register there so operators
can grep one table instead of the codebase.
"""
from __future__ import annotations

import bisect
import json
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

from repro_torch.obs.sketch import QuantileSketch

METRICS_SCHEMA = "repro.obs.metrics.v1"

# request-latency histogram upper edges (ms); one overflow bucket follows
LATENCY_MS_BUCKETS = (0.5, 1.0, 2.0, 5.0, 10.0, 20.0, 50.0, 100.0, 200.0,
                      500.0, 1000.0)

# name -> one-line meaning; the documented metric surface
WELL_KNOWN: Dict[str, str] = {
    "serve.request_ms": "histogram: submit -> blended-response latency",
    "serve.request_ms.q": "sketch: true p50/p95/p99 of the same latency "
                          "(exact below cap, bounded rank error above)",
    "serve.served": "counter: requests completed by the engine",
    "serve.shed": "counter: admission batches rejected by overload bounds",
    "serve.waves": "counter: waves dispatched",
    "serve.slo_burn_rate": "gauge: SLO error-budget burn rate over the "
                           "rolling window (>1 = burning budget)",
    "serve.slo_breaches": "counter: burn-rate threshold crossings "
                          "(ok -> breached transitions)",
    "serve.drift_score_max": "gauge: worst per-cell routing-distance drift "
                             "score at the last health() poll",
    "serve.drift_alerts": "counter: health() polls with at least one cell "
                          "over DRIFT_REFRESH_THRESHOLD",
    "serve.drift_refreshes": "counter: drift-triggered refresh_bank + "
                             "hot-swap cycles (the closed loop firing)",
    "train.waves_solved": "counter: training waves solved on device",
    "train.waves_restored": "counter: training waves restored from disk",
    "train.corrupt_waves": "counter: wave checkpoints failing verification "
                           "(re-solved, not loaded)",
    "select.columns_resolved": "counter: select-stage targeted re-solves",
    "checkpoint.saves": "counter: checkpoint steps written",
    "checkpoint.restores": "counter: checkpoint steps restored",
    "checkpoint.fallback_steps": "counter: corrupt/torn steps skipped by "
                                 "restore fallbacks (silent before PR 7)",
    "checkpoint.save_mbps": "gauge: last save throughput, MB/s",
    "checkpoint.restore_mbps": "gauge: last restore throughput, MB/s",
}


class Counter:
    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value: Union[int, float] = 0

    def inc(self, n: Union[int, float] = 1) -> None:
        if n < 0:
            raise ValueError(f"{self.name}: counters only go up (got {n})")
        self.value += n

    def to_json(self) -> Dict[str, Any]:
        return {"name": self.name, "type": "counter", "value": self.value}


class Gauge:
    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value: float = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def to_json(self) -> Dict[str, Any]:
        return {"name": self.name, "type": "gauge", "value": self.value}


class Histogram:
    """Fixed-bucket histogram: ``buckets`` are ascending upper edges; an
    observation lands in the first bucket whose edge is >= value, or the
    trailing overflow bucket.  ``observe`` is one bisect + two adds — cheap
    enough for the per-request serve path."""

    __slots__ = ("name", "buckets", "counts", "sum", "count")

    def __init__(self, name: str, buckets: Sequence[float]):
        edges = tuple(float(b) for b in buckets)
        if not edges or any(b <= a for a, b in zip(edges, edges[1:])):
            raise ValueError(f"{name}: bucket edges must be ascending, "
                             f"got {edges}")
        self.name = name
        self.buckets = edges
        self.counts = [0] * (len(edges) + 1)
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        self.counts[bisect.bisect_left(self.buckets, v)] += 1
        self.sum += v
        self.count += 1

    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def to_json(self) -> Dict[str, Any]:
        return {"name": self.name, "type": "histogram",
                "buckets": list(self.buckets), "counts": list(self.counts),
                "sum": self.sum, "count": self.count}


class MetricsRegistry:
    """Get-or-create home for named metrics.  Re-requesting a name returns
    the SAME object (call sites cache the handle; a histogram re-request
    with different buckets is an error — fixed buckets are the schema)."""

    def __init__(self):
        self._metrics: Dict[str, Union[Counter, Gauge, Histogram,
                                       QuantileSketch]] = {}

    def _get(self, name: str, cls, *args):
        m = self._metrics.get(name)
        if m is None:
            m = cls(name, *args)
            self._metrics[name] = m
            return m
        if not isinstance(m, cls):
            raise TypeError(f"{name} is a {type(m).__name__}, "
                            f"requested {cls.__name__}")
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str,
                  buckets: Sequence[float] = LATENCY_MS_BUCKETS) -> Histogram:
        h = self._get(name, Histogram, buckets)
        if h.buckets != tuple(float(b) for b in buckets):
            raise ValueError(f"{name}: histogram exists with buckets "
                             f"{h.buckets}, requested {tuple(buckets)}")
        return h

    def sketch(self, name: str, exact_cap: int = 2048,
               level_cap: int = 256) -> QuantileSketch:
        sk = self._get(name, QuantileSketch, exact_cap, level_cap)
        if (sk.exact_cap, sk.level_cap) != (int(exact_cap), int(level_cap)):
            raise ValueError(f"{name}: sketch exists with caps "
                             f"({sk.exact_cap}, {sk.level_cap}), requested "
                             f"({exact_cap}, {level_cap})")
        return sk

    def clear(self) -> None:
        self._metrics.clear()

    def names(self) -> List[str]:
        return sorted(self._metrics)

    def summary(self) -> Dict[str, Any]:
        """{name: value | histogram-dict} — the quick human view."""
        out: Dict[str, Any] = {}
        for name in self.names():
            m = self._metrics[name]
            if isinstance(m, Histogram):
                out[name] = {"count": m.count, "sum": m.sum,
                             "mean": m.mean(), "counts": list(m.counts)}
            elif isinstance(m, QuantileSketch):
                out[name] = m.summary()
            else:
                out[name] = m.value
        return out

    # ------------------------------------------------------------- JSONL
    def write_jsonl(self, path: str,
                    extra: Optional[Dict[str, Any]] = None) -> int:
        """Write the documented JSONL schema; returns metric line count."""
        n = 0
        with open(path, "w") as f:
            header = {"schema": METRICS_SCHEMA, "unix_time": time.time()}
            if extra:
                header.update(extra)
            f.write(json.dumps(header) + "\n")
            for name in self.names():
                f.write(json.dumps(self._metrics[name].to_json()) + "\n")
                n += 1
        return n

    @classmethod
    def read_jsonl(cls, path: str) -> Tuple["MetricsRegistry",
                                            Dict[str, Any]]:
        """Round-trip reader: rebuilds a registry from :meth:`write_jsonl`
        output.  Raises ``ValueError`` on schema violations (use
        :func:`validate_jsonl` for a non-throwing error list)."""
        errors = validate_jsonl(path)
        if errors:
            raise ValueError(f"{path}: invalid metrics JSONL: {errors[0]}")
        reg = cls()
        with open(path) as f:
            header = json.loads(f.readline())
            for line in f:
                d = json.loads(line)
                if d["type"] == "counter":
                    reg.counter(d["name"]).inc(d["value"])
                elif d["type"] == "gauge":
                    reg.gauge(d["name"]).set(d["value"])
                elif d["type"] == "sketch":
                    reg._metrics[d["name"]] = QuantileSketch.from_json(d)
                else:
                    h = reg.histogram(d["name"], d["buckets"])
                    h.counts = list(d["counts"])
                    h.sum = float(d["sum"])
                    h.count = int(d["count"])
        return reg, header


def validate_jsonl(path: str) -> List[str]:
    """Check a metrics JSONL file against the documented schema.

    Returns a list of human-readable errors (empty = valid).  This is what
    the tier-1 metrics-schema smoke runs against the CLI's ``METRICS_OUT``
    output — the schema is load-bearing for operators' dashboards, so
    drifting it must fail the gate, not a consumer at 3am.
    """
    errors: List[str] = []
    try:
        with open(path) as f:
            lines = f.readlines()
    except OSError as e:
        return [f"unreadable: {e}"]
    if not lines:
        return ["empty file (expected a schema header line)"]
    try:
        header = json.loads(lines[0])
    except ValueError as e:
        return [f"line 1: not JSON ({e})"]
    if header.get("schema") != METRICS_SCHEMA:
        errors.append(f"line 1: schema={header.get('schema')!r}, "
                      f"expected {METRICS_SCHEMA!r}")
    if not isinstance(header.get("unix_time"), (int, float)):
        errors.append("line 1: missing numeric unix_time")
    seen = set()
    for i, line in enumerate(lines[1:], start=2):
        if not line.strip():
            continue
        try:
            d = json.loads(line)
        except ValueError as e:
            errors.append(f"line {i}: not JSON ({e})")
            continue
        name, typ = d.get("name"), d.get("type")
        if not isinstance(name, str) or not name:
            errors.append(f"line {i}: missing name")
            continue
        if name in seen:
            errors.append(f"line {i}: duplicate metric {name!r}")
        seen.add(name)
        if typ in ("counter", "gauge"):
            if not isinstance(d.get("value"), (int, float)):
                errors.append(f"line {i}: {name}: non-numeric value")
        elif typ == "histogram":
            b, c = d.get("buckets"), d.get("counts")
            if (not isinstance(b, list) or not isinstance(c, list)
                    or len(c) != len(b) + 1):
                errors.append(f"line {i}: {name}: counts must have "
                              f"len(buckets)+1 entries")
            elif any(y <= x for x, y in zip(b, b[1:])):
                errors.append(f"line {i}: {name}: bucket edges not "
                              f"ascending")
            elif (not all(isinstance(v, int) and v >= 0 for v in c)
                  or not isinstance(d.get("sum"), (int, float))
                  or not isinstance(d.get("count"), int)
                  or d["count"] != sum(c)):
                errors.append(f"line {i}: {name}: counts/sum/count "
                              f"inconsistent")
        elif typ == "sketch":
            lv = d.get("levels")
            caps_ok = (isinstance(d.get("exact_cap"), int)
                       and isinstance(d.get("level_cap"), int)
                       and d["exact_cap"] >= 1 and d["level_cap"] >= 2)
            if (not isinstance(lv, list) or not caps_ok
                    or not all(isinstance(l, list) and
                               all(isinstance(v, (int, float)) for v in l)
                               for l in lv)):
                errors.append(f"line {i}: {name}: sketch needs integer "
                              f"caps and numeric levels lists")
            elif (not isinstance(d.get("count"), int)
                  or not isinstance(d.get("sum"), (int, float))
                  or not isinstance(d.get("rank_error"), int)
                  or d["rank_error"] < 0
                  or d["count"] != sum(len(l) << j
                                       for j, l in enumerate(lv))):
                # weight conservation: retained weights must cover count
                errors.append(f"line {i}: {name}: sketch count/sum/"
                              f"rank_error inconsistent with levels")
        else:
            errors.append(f"line {i}: {name}: unknown type {typ!r}")
    return errors
