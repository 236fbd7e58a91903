"""repro_torch.obs — unified tracing + metrics for train/select/serve hot paths.

One process-global :class:`Tracer` and :class:`MetricsRegistry` live here,
mirroring how ``repro_torch.testing.faults`` exposes one global site registry:
production code imports the module and uses ``obs.tracer`` / ``obs.metrics``
directly (or accepts them as injectable constructor arguments, as
``SVMEngine`` does, defaulting to the globals).

Configuration is string keys (the same ``-S`` config keys as the JAX
package's CLI):

  ``TRACE=1``            enable the span tracer
  ``TRACE_OUT=<path>``   write the retained span window as JSONL on exit
                         (schema ``repro.obs.trace.v1``; implies TRACE=1
                         unless TRACE=0 is given explicitly)
  ``METRICS_OUT=<path>`` write the metrics registry as JSONL on exit
  ``PROFILE_DIR=<path>`` capture ``torch.profiler`` traces around wave
                         launches into this directory

Everything is off by default and each disabled hook costs one attribute
test on the hot path.  The consumer layer on top of these signals —
quantile sketches (``obs.sketch``) and SLO burn rates (``obs.slo``) —
reads the same global instruments.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

from . import profiler
from .metrics import (Counter, Gauge, Histogram, LATENCY_MS_BUCKETS,
                      METRICS_SCHEMA, MetricsRegistry, WELL_KNOWN,
                      validate_jsonl)
from .sketch import QuantileSketch
from .slo import SLOSpec, SLOTracker
from .trace import (NULL_SPAN, RingBuffer, Span, TRACE_SCHEMA, Tracer,
                    validate_trace_jsonl)

__all__ = [
    "Counter", "Gauge", "Histogram", "LATENCY_MS_BUCKETS", "METRICS_SCHEMA",
    "MetricsRegistry", "NULL_SPAN", "QuantileSketch", "RingBuffer",
    "SLOSpec", "SLOTracker", "Span", "TRACE_SCHEMA", "Tracer", "WELL_KNOWN",
    "configure", "flush_metrics", "flush_trace", "metrics",
    "metrics_out", "profile_dir", "profiler", "reset", "trace_out", "tracer",
    "validate_jsonl", "validate_trace_jsonl",
]

# process-global instruments — the default sinks for every instrumented site
tracer = Tracer()
metrics = MetricsRegistry()

_METRICS_OUT: Optional[str] = None
_TRACE_OUT: Optional[str] = None


def configure(trace: Optional[bool] = None,
              metrics_out: Optional[str] = None,
              trace_out: Optional[str] = None,
              profile_dir: Optional[str] = None) -> None:
    """Apply the observability config keys.  ``None`` leaves a setting
    unchanged, so callers can forward exactly what the user passed."""
    global _METRICS_OUT, _TRACE_OUT
    if trace is not None:
        tracer.enabled = bool(trace)
    if trace_out is not None:
        _TRACE_OUT = trace_out or None
        # a trace dump with the tracer off would always be empty: TRACE_OUT
        # implies TRACE=1 unless the same call says TRACE=0 explicitly
        if _TRACE_OUT and trace is None:
            tracer.enabled = True
    if metrics_out is not None:
        _METRICS_OUT = metrics_out or None
    if profile_dir is not None:
        profiler.configure(profile_dir or None)


def metrics_out() -> Optional[str]:
    return _METRICS_OUT


def trace_out() -> Optional[str]:
    return _TRACE_OUT


def profile_dir() -> Optional[str]:
    return profiler.profile_dir()


def flush_metrics(extra: Optional[Dict[str, Any]] = None) -> Optional[str]:
    """Write the global registry to the configured ``METRICS_OUT`` path (if
    any); returns the path written or None.  The CLI calls this on exit."""
    if _METRICS_OUT is None:
        return None
    metrics.write_jsonl(_METRICS_OUT, extra=extra)
    return _METRICS_OUT


def flush_trace() -> Optional[str]:
    """Write the global tracer's span window to ``TRACE_OUT`` (if any);
    returns the path written or None.  The CLI calls this on exit."""
    if _TRACE_OUT is None:
        return None
    tracer.write_jsonl(_TRACE_OUT)
    return _TRACE_OUT


def reset() -> None:
    """Return the process-global instruments to their startup state (tests)."""
    global _METRICS_OUT, _TRACE_OUT
    tracer.enabled = False
    tracer.clear()
    metrics.clear()
    _METRICS_OUT = None
    _TRACE_OUT = None
    profiler.configure(None)
