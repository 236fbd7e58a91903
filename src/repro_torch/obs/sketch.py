"""Mergeable online quantile sketch: exact small, bounded-error large.

Fixed-bucket histograms (``obs.metrics.Histogram``) answer "how many
requests were slower than 20ms" but interpolate percentiles from bucket
edges — a p99 read off 11 latency buckets can be off by the width of a
bucket.  This sketch answers quantile queries with a KNOWN rank error:

  * **exact mode** — below ``exact_cap`` observations the sketch keeps
    every value; quantiles are exact order statistics (and two merged
    exact sketches are exactly the pooled sample);
  * **compactor mode** — past the cap it becomes a deterministic
    KLL-style compactor hierarchy: level ``i`` holds values of weight
    ``2**i``; an over-full level is sorted and every other value is
    promoted to level ``i+1`` (the survivor of each adjacent pair,
    alternating pair parity per level so errors cancel rather than
    accumulate one-sided).  Each compaction of a weight-``w`` level
    shifts any rank by at most ``w`` — the sketch ADDS that to
    :attr:`rank_error`, so the reported bound is analytic, not
    hand-waved, and the property tests assert against it.

Determinism: no RNG anywhere (pair parity alternates deterministically),
so identical observation streams produce identical sketch states —
required for the repo's replay/regression idiom.

``merge`` concatenates levelwise and recompacts; counts, sums and error
bounds add.  Memory is O(level_cap * log2(n / exact_cap)).

Registered as the fourth metric type of ``repro_torch.obs.metrics``
(``MetricsRegistry.sketch``); the JSONL line schema rides the existing
``repro.obs.metrics.v1`` header:

  sketch: {"name": str, "type": "sketch", "count": int, "sum": number,
           "rank_error": int, "exact_cap": int, "level_cap": int,
           "levels": [[level-0 values...], [level-1 ...], ...],
           "q": {"p50": .., "p90": .., "p95": .., "p99": ..}}

(``q`` is a reader convenience; ``levels`` is the authoritative state and
round-trips exactly.)
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, List, Sequence

# quantiles exported in to_json()["q"] / summaries
_SUMMARY_QS = (("p50", 0.50), ("p90", 0.90), ("p95", 0.95), ("p99", 0.99))


class QuantileSketch:
    """Deterministic mergeable quantile sketch (see module docstring).

    ``quantile(q)`` returns the smallest retained value whose cumulative
    weight exceeds ``q * (count - 1)`` — in exact mode this is precisely
    ``np.quantile(values, q, method="lower")``; in compactor mode the
    value's true rank is within :attr:`rank_error` of the target.
    """

    __slots__ = ("name", "exact_cap", "level_cap", "count", "sum",
                 "rank_error", "_levels", "_parity")

    def __init__(self, name: str = "", exact_cap: int = 2048,
                 level_cap: int = 256):
        if exact_cap < 1 or level_cap < 2:
            raise ValueError(f"{name}: need exact_cap >= 1, level_cap >= 2 "
                             f"(got {exact_cap}, {level_cap})")
        self.name = name
        self.exact_cap = int(exact_cap)
        self.level_cap = int(level_cap)
        self.count = 0
        self.sum = 0.0
        self.rank_error = 0          # analytic bound on |est - true| rank
        self._levels: List[List[float]] = [[]]   # level i: weight 2**i
        self._parity: List[int] = [0]            # per-level pair parity

    # ------------------------------------------------------------ observing
    @property
    def exact(self) -> bool:
        """True while every observation is retained individually."""
        return self.rank_error == 0 and len(self._levels) == 1

    def observe(self, v: float) -> None:
        self._levels[0].append(float(v))
        self.count += 1
        self.sum += float(v)
        if self.count > self.exact_cap:
            self._compress()

    def observe_many(self, vs: Iterable[float]) -> None:
        vs = [float(v) for v in vs]
        self._levels[0].extend(vs)
        self.count += len(vs)
        self.sum += sum(vs)
        if self.count > self.exact_cap:
            self._compress()

    # ----------------------------------------------------------- compaction
    def _compress(self) -> None:
        """Restore the per-level bound (level 0 is additionally allowed to
        hold up to ``exact_cap`` values while the sketch is still exact).
        Promotions only move upward, so one bottom-up pass settles."""
        i = 0
        while i < len(self._levels):
            while len(self._levels[i]) > self.level_cap:
                self._compact(i)
            i += 1

    def _compact(self, i: int) -> None:
        buf = sorted(self._levels[i])
        keep: List[float] = []
        if len(buf) % 2:
            # odd element stays at level i (weight conservation is exact)
            keep.append(buf.pop() if self._parity[i] else buf.pop(0))
        take = self._parity[i]       # promote buf[0::2] or buf[1::2]
        self._parity[i] ^= 1
        promoted = buf[take::2]
        self._levels[i] = keep
        if i + 1 == len(self._levels):
            self._levels.append([])
            self._parity.append(0)
        self._levels[i + 1].extend(promoted)
        # collapsing sorted pairs to one survivor each shifts any rank by
        # at most one pair width: the weight of this level
        self.rank_error += 1 << i

    # ------------------------------------------------------------- querying
    def _weighted(self) -> List[tuple]:
        items = []
        for i, lv in enumerate(self._levels):
            w = 1 << i
            items.extend((v, w) for v in lv)
        items.sort()
        return items

    def quantile(self, q: float) -> float:
        return self.quantiles([q])[0]

    def quantiles(self, qs: Sequence[float]) -> List[float]:
        """Batch query over one sort of the retained values."""
        if self.count == 0:
            return [float("nan")] * len(qs)
        items = self._weighted()
        out = []
        for q in qs:
            if not 0.0 <= q <= 1.0:
                raise ValueError(f"quantile {q} outside [0, 1]")
            target = q * (self.count - 1)
            cum = 0
            val = items[-1][0]
            for v, w in items:
                cum += w
                if cum > target:
                    val = v
                    break
            out.append(val)
        return out

    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    # -------------------------------------------------------------- merging
    def merge(self, other: "QuantileSketch") -> "QuantileSketch":
        """Fold ``other`` into self (levelwise concat + recompaction).

        Counts/sums/error bounds add; if both inputs were exact and the
        union fits under ``self.exact_cap`` the result is still exact
        (identical to a pooled sample).  Cap parameters follow self.
        """
        while len(self._levels) < len(other._levels):
            self._levels.append([])
            self._parity.append(0)
        for i, lv in enumerate(other._levels):
            self._levels[i].extend(lv)
        self.count += other.count
        self.sum += other.sum
        self.rank_error += other.rank_error
        if self.count > self.exact_cap or not self.exact:
            self._compress()
        return self

    # ---------------------------------------------------------------- JSONL
    def to_json(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {
            "name": self.name, "type": "sketch", "count": self.count,
            "sum": self.sum, "rank_error": self.rank_error,
            "exact_cap": self.exact_cap, "level_cap": self.level_cap,
            "levels": [list(lv) for lv in self._levels],
        }
        if self.count:
            vals = self.quantiles([q for _, q in _SUMMARY_QS])
            d["q"] = {k: v for (k, _), v in zip(_SUMMARY_QS, vals)}
        return d

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "QuantileSketch":
        sk = cls(d.get("name", ""), int(d["exact_cap"]),
                 int(d["level_cap"]))
        sk.count = int(d["count"])
        sk.sum = float(d["sum"])
        sk.rank_error = int(d["rank_error"])
        sk._levels = [[float(v) for v in lv] for lv in d["levels"]] or [[]]
        sk._parity = [0] * len(sk._levels)
        return sk

    def summary(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"count": self.count, "sum": self.sum,
                               "rank_error": self.rank_error}
        if self.count:
            vals = self.quantiles([q for _, q in _SUMMARY_QS])
            out.update({k: v for (k, _), v in zip(_SUMMARY_QS, vals)})
        return out

    def __repr__(self) -> str:
        return (f"QuantileSketch({self.name!r}, count={self.count}, "
                f"rank_error={self.rank_error}, "
                f"levels={[len(lv) for lv in self._levels]})")
