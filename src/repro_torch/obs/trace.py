"""Monotonic-clock spans: the timing half of the observability layer.

Production code marks its timed sections the way it marks fault points
(``repro_torch.testing.faults``): a named site, fired through one process-global
object, a no-op unless something turned it on.

    from repro_torch import obs

    with obs.tracer.span("serve.pack"):
        plan = plan_wave(...)

Design constraints (these are serve-hot-path sites):

  * **near-zero overhead disabled** — ``Tracer.span`` on a disabled tracer
    is one attribute test and returns a shared singleton
    (:data:`NULL_SPAN`); no object, no dict, no clock read is allocated.
    Code that already holds wall-clock timestamps (the engine times its
    stages unconditionally for ``wave_stats``) uses :meth:`Tracer.record`
    instead, which is a no-op ``if not enabled`` — the clock is read once,
    by the caller, whichever path runs;
  * **nesting** — live spans carry a depth (0 = root) maintained by the
    tracer, so an exported trace reconstructs the call tree without ids;
  * **bounded** — completed spans land in a :class:`RingBuffer`; a
    long-running serve loop cannot grow memory by being observed
    (``dropped`` counts what the ring evicted);
  * **device time** — ``span(name, device)`` with a CUDA device also
    records a CUDA event pair on the current stream, so a span of
    asynchronous launches carries the card's time for them
    (:attr:`Span.elapsed_ms`, :meth:`Tracer.breakdown_ms`); reading it
    synchronizes once.  Two events per span, and only while enabled.

Known sites (grep ``tracer.span\\|tracer.record`` for the authoritative
list): ``serve.route`` ``serve.pack`` ``serve.dispatch`` ``serve.device``
``serve.collect``; the training waves' ``train.wave`` with its stages
``train.stage`` ``train.d2`` ``train.epilogue`` ``train.fista``
``train.polish`` ``train.select`` (device-timed).  The schema id is shared with the JAX package, so one
reader serves traces from both.
"""
from __future__ import annotations

import json
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

TRACE_SCHEMA = "repro.obs.trace.v1"


class RingBuffer:
    """Fixed-capacity append-only view of the most recent items.

    Drop-in for the unbounded lists the engine used to keep
    (``wave_stats``): supports ``append``, ``len``, iteration (oldest ->
    newest), indexing (``[-1]`` = newest) and ``clear``.  ``total`` counts
    every append ever made, ``dropped`` how many the ring evicted — callers
    that need EXACT aggregates over the full history keep running sums and
    use the ring only for the recent-window detail.
    """

    __slots__ = ("_cap", "_buf", "_start", "total")

    def __init__(self, capacity: int):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self._cap = int(capacity)
        self._buf: List[Any] = []
        self._start = 0          # index of the oldest element in _buf
        self.total = 0

    @property
    def capacity(self) -> int:
        return self._cap

    @property
    def dropped(self) -> int:
        return self.total - len(self._buf)

    def append(self, item: Any) -> None:
        self.total += 1
        if len(self._buf) < self._cap:
            self._buf.append(item)
        else:
            self._buf[self._start] = item
            self._start = (self._start + 1) % self._cap

    def clear(self) -> None:
        self._buf.clear()
        self._start = 0
        self.total = 0

    def __len__(self) -> int:
        return len(self._buf)

    def __iter__(self) -> Iterator[Any]:
        n = len(self._buf)
        for i in range(n):
            yield self._buf[(self._start + i) % n]

    def __getitem__(self, idx):
        n = len(self._buf)
        if isinstance(idx, slice):
            return list(self)[idx]
        if not -n <= idx < n:
            raise IndexError(idx)
        return self._buf[(self._start + (idx % n)) % n]

    def __repr__(self) -> str:
        return (f"RingBuffer(cap={self._cap}, len={len(self._buf)}, "
                f"total={self.total})")


class _NullSpan:
    """The disabled-tracer span: one shared instance, does nothing."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs: Any) -> "_NullSpan":
        return self


NULL_SPAN = _NullSpan()


class Span:
    """One completed timed section.  ``dur_s`` is monotonic-clock seconds;
    ``depth`` 0 is a root span (nesting recorded at entry time); ``events``
    the (start, end) CUDA events of a device-timed span, else None."""

    __slots__ = ("name", "t0", "t1", "depth", "attrs", "events")

    def __init__(self, name: str, t0: float, t1: float, depth: int = 0,
                 attrs: Optional[Dict[str, Any]] = None,
                 events: Optional[Tuple[Any, Any]] = None):
        self.name = name
        self.t0 = t0
        self.t1 = t1
        self.depth = depth
        self.attrs = attrs
        self.events = events

    @property
    def dur_s(self) -> float:
        return self.t1 - self.t0

    @property
    def elapsed_ms(self) -> float:
        """The card's time between the span's events when it has them
        (waits for the end event), else the host's."""
        if self.events is None:
            return self.dur_s * 1e3
        start, end = self.events
        end.synchronize()
        return start.elapsed_time(end)

    def to_json(self) -> Dict[str, Any]:
        d = {"name": self.name, "t0": self.t0, "t1": self.t1,
             "dur_s": self.dur_s, "depth": self.depth}
        if self.attrs:
            d["attrs"] = self.attrs
        if self.events is not None:
            d["device_ms"] = self.elapsed_ms
        return d

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, {self.dur_s * 1e3:.3f}ms, "
                f"depth={self.depth})")


class _LiveSpan:
    """Context manager for an enabled tracer; records itself on exit."""

    __slots__ = ("_tracer", "name", "t0", "attrs", "_events")

    def __init__(self, tracer: "Tracer", name: str, device=None):
        self._tracer = tracer
        self.name = name
        self.attrs: Optional[Dict[str, Any]] = None
        self.t0 = 0.0
        self._events = None
        if device is not None:
            import torch
            if torch.device(device).type == "cuda":
                self._events = (torch.cuda.Event(enable_timing=True),
                                torch.cuda.Event(enable_timing=True))

    def set(self, **attrs: Any) -> "_LiveSpan":
        if self.attrs is None:
            self.attrs = attrs
        else:
            self.attrs.update(attrs)
        return self

    def __enter__(self) -> "_LiveSpan":
        self._tracer._depth += 1
        if self._events is not None:
            self._events[0].record()
        self.t0 = self._tracer._clock()
        return self

    def __exit__(self, *exc) -> bool:
        if self._events is not None:
            self._events[1].record()
        t1 = self._tracer._clock()
        tr = self._tracer
        tr._depth -= 1
        tr._emit(Span(self.name, self.t0, t1, tr._depth, self.attrs,
                      self._events))
        return False


class Tracer:
    """Span collector with a per-site summary and a bounded span ring.

    ``enabled`` is plain attribute assignment — flip it at runtime (the
    CLI's ``TRACE=1`` key does).  ``clock`` is injectable for deterministic
    tests; it must be monotonic.
    """

    def __init__(self, enabled: bool = False,
                 clock: Callable[[], float] = time.perf_counter,
                 capacity: int = 65536):
        self.enabled = bool(enabled)
        self._clock = clock
        self.spans = RingBuffer(capacity)
        self._depth = 0
        # per-site running aggregates — exact even after the ring wraps
        self._agg: Dict[str, List[float]] = {}   # name -> [count, total, max]

    # ------------------------------------------------------------ recording
    def span(self, name: str, device=None):
        """Timed context manager for ``name``; :data:`NULL_SPAN` when
        disabled (no allocation).  Attach attributes inside the body with
        ``sp.set(key=value)`` — a no-op on the null span.  A CUDA
        ``device`` also times the span on the card (CUDA events)."""
        if not self.enabled:
            return NULL_SPAN
        return _LiveSpan(self, name, device)

    def record(self, name: str, t0: float, t1: float) -> None:
        """Record an already-measured interval (caller read the clock).

        The engine's hot path times its stages unconditionally for
        ``wave_stats``; this hands the same two timestamps to the tracer
        without a second clock read — and costs one attribute test when
        the tracer is off.
        """
        if not self.enabled:
            return
        self._emit(Span(name, t0, t1, self._depth, None))

    def _emit(self, span: Span) -> None:
        self.spans.append(span)
        agg = self._agg.get(span.name)
        d = span.dur_s
        if agg is None:
            self._agg[span.name] = [1, d, d]
        else:
            agg[0] += 1
            agg[1] += d
            if d > agg[2]:
                agg[2] = d

    # ------------------------------------------------------------- reading
    def summary(self) -> Dict[str, Dict[str, float]]:
        """Per-site ``{count, total_s, mean_s, max_s}`` over every span
        ever recorded (exact; not limited to the ring window)."""
        return {name: {"count": int(c), "total_s": tot,
                       "mean_s": tot / c, "max_s": mx}
                for name, (c, tot, mx) in sorted(self._agg.items())}

    def breakdown_ms(self, root: str) -> List[Dict[str, Any]]:
        """Per ``root`` span in the retained window, oldest first: its
        attrs under ``"attrs"``, its own :attr:`Span.elapsed_ms` under its
        name, and the summed elapsed_ms of each span name recorded inside
        it (children complete before their parent, so they precede it)."""
        out: List[Dict[str, Any]] = []
        pending: List[Span] = []
        for sp in self.spans:
            if sp.name != root:
                pending.append(sp)
                continue
            row: Dict[str, Any] = {"attrs": dict(sp.attrs or {}),
                                   root: sp.elapsed_ms}
            for ch in pending:
                if ch.t0 >= sp.t0 and ch.t1 <= sp.t1:
                    row[ch.name] = row.get(ch.name, 0.0) + ch.elapsed_ms
            out.append(row)
            pending = []
        return out

    def clear(self) -> None:
        self.spans.clear()
        self._agg.clear()
        self._depth = 0

    # ------------------------------------------------------------ exporting
    def write_jsonl(self, path: str) -> int:
        """Dump the retained span window as JSONL (header line first);
        returns the number of span lines written.  The format is pinned as
        ``repro.obs.trace.v1`` and checked by :func:`validate_trace_jsonl`
        (the tier-1 smoke runs it against the CLI's ``TRACE_OUT``)."""
        n = 0
        with open(path, "w") as f:
            f.write(json.dumps({
                "schema": TRACE_SCHEMA, "unix_time": time.time(),
                "spans_total": self.spans.total,
                "spans_dropped": self.spans.dropped,
                "summary": self.summary()}) + "\n")
            for s in self.spans:
                f.write(json.dumps(s.to_json()) + "\n")
                n += 1
        return n


_SUMMARY_FIELDS = ("count", "total_s", "mean_s", "max_s")


def validate_trace_jsonl(path: str) -> List[str]:
    """Check a trace JSONL file against the ``repro.obs.trace.v1`` schema.

    The metrics validator's twin (``obs.metrics.validate_jsonl``): returns
    a list of human-readable errors, empty when valid.  Pinned facts:

      line 1:  {"schema": "repro.obs.trace.v1", "unix_time": number,
                "spans_total": int >= "spans_dropped": int >= 0,
                "summary": {site: {count, total_s, mean_s, max_s}}}
      span:    {"name": str, "t0": number, "t1": number >= t0,
                "dur_s": t1 - t0, "depth": int >= 0, "attrs": dict?}

    and the span line count must equal ``spans_total - spans_dropped``
    (the ring retains exactly what was not evicted).
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
    if header.get("schema") != TRACE_SCHEMA:
        errors.append(f"line 1: schema={header.get('schema')!r}, "
                      f"expected {TRACE_SCHEMA!r}")
    if not isinstance(header.get("unix_time"), (int, float)):
        errors.append("line 1: missing numeric unix_time")
    total, dropped = header.get("spans_total"), header.get("spans_dropped")
    if (not isinstance(total, int) or not isinstance(dropped, int)
            or not 0 <= dropped <= total):
        errors.append("line 1: spans_total/spans_dropped must be ints with "
                      "0 <= dropped <= total")
        total = dropped = None
    summary = header.get("summary")
    if not isinstance(summary, dict):
        errors.append("line 1: missing summary dict")
    else:
        for site, agg in summary.items():
            if (not isinstance(agg, dict)
                    or not all(isinstance(agg.get(k), (int, float))
                               for k in _SUMMARY_FIELDS)):
                errors.append(f"line 1: summary[{site!r}] needs numeric "
                              f"{'/'.join(_SUMMARY_FIELDS)}")
    n_spans = 0
    for i, line in enumerate(lines[1:], start=2):
        if not line.strip():
            continue
        try:
            d = json.loads(line)
        except ValueError as e:
            errors.append(f"line {i}: not JSON ({e})")
            continue
        n_spans += 1
        name = d.get("name")
        if not isinstance(name, str) or not name:
            errors.append(f"line {i}: missing span name")
            continue
        t0, t1, dur = d.get("t0"), d.get("t1"), d.get("dur_s")
        if (not isinstance(t0, (int, float)) or not isinstance(t1, (int, float))
                or t1 < t0):
            errors.append(f"line {i}: {name}: t0/t1 must be numeric with "
                          f"t1 >= t0")
        elif (not isinstance(dur, (int, float))
              or abs(dur - (t1 - t0)) > 1e-9 * max(1.0, abs(t1))):
            errors.append(f"line {i}: {name}: dur_s != t1 - t0")
        if not isinstance(d.get("depth"), int) or d["depth"] < 0:
            errors.append(f"line {i}: {name}: depth must be an int >= 0")
        if "attrs" in d and not isinstance(d["attrs"], dict):
            errors.append(f"line {i}: {name}: attrs must be a dict")
    if total is not None and n_spans != total - dropped:
        errors.append(f"{n_spans} span lines but header says "
                      f"{total} total - {dropped} dropped")
    return errors
