"""Validated string-key configuration (liquidSVM's one config system; the
JAX package's ``api/config.py``).

Every liquidSVM binding — R, Python, MATLAB, the command line — shares one
set of string configuration keys (``d$train("FOLDS=3 KERNEL=GAUSS_RBF")``,
``mcSVM(..., folds=3)``).  This module is that layer for the PyTorch port:
a registry of typed, validated keys that map onto
:class:`repro_torch.train.svm_trainer.SVMTrainerConfig` fields or select-stage
parameters.  Keys are case-insensitive; values arrive as Python values or
as strings (the CLI's ``-S KEY=VALUE``).

Train-stage keys
  SCENARIO             str    binary|ova|ava|weighted|npsvm|quantile|expectile|ls
  SOLVER               str    auto|hinge|ls|quantile|expectile
  KERNEL               str    gauss_rbf|laplacian (the registered kernels)
  SCALE                bool   train-statistics feature scaling (default on)
  FOLDS                int    number of CV folds (>= 2)
  FOLD_SCHEME          str    random|stratified|blocks
  GRID_CHOICE          int    0|1|2 -> 10x10 | 15x15 | 20x20 grid
  ADAPTIVITY_CONTROL   int    0|1|2 coarse-grid subsetting (paper App. C)
  MAX_ITERATIONS       int    solver iteration cap
  SOLVER_POLISH        int    Gauss-Seidel CD epochs appended to each
                       box-QP solve (B4, one launch per epoch over the
                       wave); 0 = off, the FISTA-only path
  TOLERANCE            float  solver duality-gap tolerance
  RANDOM_SEED          int    fold/cell PRNG seed
  VORONOI              int|str cell decomposition: 0=none 1=random
                       2-4=voronoi 5=overlap 6=recursive (or method names,
                       incl. coarse_fine)
  CELL_SIZE            int    max working-set size per cell
  WEIGHTS              floats explicit hinge +1-class weight grid
  MIN_WEIGHT /
  MAX_WEIGHT /
  WEIGHT_STEPS         float/float/int geometric weight grid (wSVM/rocSVM)
  TAUS                 floats quantile/expectile levels
  WAVE_SLOTS           int    packed slots solved per wave (memory bound)
  CHUNK_SIZE           int    streaming-ingestion chunk rows

Select-stage keys (consumed by ``select()``, not the trainer)
  NPL_CONSTRAINT       float  Neyman-Pearson false-alarm budget alpha
  NPL_CLASS            int    +-1: which class the constraint binds on

Serve-stage keys (consumed by the serving engine — ``SVM(...).engine()``
and ``python -m repro_torch.cli serve`` — never the trainer; split off with
:func:`split_serve_keys`)
  SERVE_OVERLAP        bool   route each request to its 2 nearest cells
                       and blend decisions with distance-softmax weights.
                       Defaults to the bank's recorded routing mode
                       (overlap for VORONOI=5 fits, else exact 1-NN).
  DEADLINE_MS          float  latency bound for the async stepper: a wave
                       launches when it fills OR the oldest queued
                       request reaches this age.
  MAX_QUEUE            int    admission-queue bound (launch rows): a
                       submit that would overflow is rejected with a
                       retry-able OverloadError instead of growing
                       memory without bound.
  SWAP_POLL_MS         float  hot-swap watcher poll interval for
                       ``cli serve --swap-watch`` (how often the bank
                       directory is checked for a newer version).

Monitor keys (consumed by ``repro_torch.serve.monitor.HealthMonitor`` —
``SVM(...).monitor()`` and ``cli serve``; split off with
:func:`split_monitor_keys`)
  SLO_P99_MS           float  latency SLO: 99% of requests must complete
                       under this many ms.  Enables rolling-window
                       error-budget burn-rate tracking and breach events.
  DRIFT_WINDOW         float  rolling window (seconds) for the per-cell
                       routing-distance drift sketches and burn rates.
  DRIFT_REFRESH_THRESHOLD float per-cell drift score at which the closed
                       loop triggers a targeted ``refresh_bank`` +
                       hot swap (``cli serve --swap-watch`` with
                       ``--feedback-data``).

Embed-stage keys (consumed by :func:`repro_torch.embed.embed_source` — the
session front door, scenario front-ends and ``cli embed``/``cli serve
--tokens`` when the x input is a TOKEN corpus; split off with
:func:`split_embed_keys`)
  EMBED_ARCH           str    frozen-backbone architecture id from
                       ``repro_torch.configs.ARCH_IDS``; append ``:smoke`` for
                       the smoke-sized variant (tests, synthetic demos).
                       Presence of this key is what flags the x input as
                       tokens rather than features.
  EMBED_POOL           str    mean|last — hidden-state pooling.
  EMBED_CACHE          path   multi-identity embedding-cache root: npz
                       shards land under ``<dir>/<fingerprint>/`` keyed by
                       (arch, params digest, pooling, seq_len); cache hits
                       replay through ShardedNpzSource (I/O-bound).
  EMBED_BATCH          int    fixed batch shape for the backbone
                       forward (compute-block size; does NOT affect
                       output bits — blocks align to corpus offsets).
  EMBED_SEED           int    deterministic frozen-backbone init seed
                       (the random-features regime; ignored when real
                       params are supplied programmatically).

Observability keys (consumed by ``repro_torch.obs.configure`` — any
stage; split off with :func:`split_obs_keys`)
  TRACE                bool   enable the span tracer
                       (``repro_torch.obs.tracer``): monotonic-clock spans at every instrumented site,
                       per-site summaries, JSONL trace dumps.  Off by
                       default; disabled sites cost one attribute test.
  TRACE_OUT            path   write the retained span window (schema
                       ``repro.obs.trace.v1``, the reference's) to this
                       JSONL file when the CLI stage exits; implies TRACE=1 unless TRACE=0 is
                       set explicitly.
  METRICS_OUT          path   write the process metrics registry
                       (counters/gauges/latency histograms/quantile
                       sketches, schema ``repro.obs.metrics.v1``) to this
                       JSONL file when the CLI stage exits.
  PROFILE_DIR          path   capture ``torch.profiler`` traces around
                       wave launches into this directory
                       (``repro_torch.obs.profiler``: each wave is one
                       named ``record_function`` range, and the capture
                       includes the card's activity when there is one).

Accepted for liquidSVM compatibility, no effect here
  DISPLAY, THREADS
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np

from repro_torch.train.svm_trainer import SVMTrainerConfig

_CELL_CODES = {0: "none", 1: "random", 2: "voronoi", 3: "voronoi",
               4: "voronoi", 5: "overlap", 6: "recursive"}
_CELL_NAMES = ("none", "random", "voronoi", "overlap", "recursive",
               "coarse_fine")


@dataclasses.dataclass(frozen=True)
class ConfigKey:
    name: str
    kind: str                       # int | float | bool | str | path | floats
    doc: str
    field: Optional[str] = None     # SVMTrainerConfig field
    choices: Optional[Tuple] = None
    lo: Optional[float] = None
    hi: Optional[float] = None
    select: bool = False            # select-stage parameter
    serve: bool = False             # serve-stage (engine) parameter
    monitor: bool = False           # health-monitor (HealthMonitor) parameter
    obs: bool = False               # observability (obs.configure)
    embed: bool = False             # embed-stage (embed_source) parameter
    noop: bool = False              # accepted (compat), ignored


_KEYS: Dict[str, ConfigKey] = {k.name: k for k in [
    ConfigKey("SCENARIO", "str", "learning scenario", field="scenario",
              choices=("binary", "ova", "ava", "weighted", "npsvm",
                       "quantile", "expectile", "ls")),
    ConfigKey("SOLVER", "str", "solver override", field="solver",
              choices=("auto", "hinge", "ls", "quantile", "expectile")),
    ConfigKey("KERNEL", "str", "kernel name", field="kernel"),
    ConfigKey("SCALE", "bool", "train-statistics scaling", field="scale"),
    ConfigKey("FOLDS", "int", "CV folds", field="n_folds", lo=2, hi=64),
    ConfigKey("FOLD_SCHEME", "str", "fold construction", field="fold_scheme",
              choices=("random", "stratified", "blocks")),
    ConfigKey("GRID_CHOICE", "int", "grid size preset", field="grid_choice",
              lo=0, hi=2),
    ConfigKey("ADAPTIVITY_CONTROL", "int", "coarse-grid level",
              field="adaptivity_control", lo=0, hi=2),
    ConfigKey("MAX_ITERATIONS", "int", "solver iteration cap",
              field="max_iters", lo=1),
    ConfigKey("SOLVER_POLISH", "int", "wave-fused CD polish epochs (0 = off)",
              field="cd_polish", lo=0),
    ConfigKey("TOLERANCE", "float", "solver tolerance", field="tol", lo=0.0),
    ConfigKey("RANDOM_SEED", "int", "PRNG seed", field="seed"),
    ConfigKey("VORONOI", "", "cell decomposition code/name"),
    ConfigKey("PARTITION_CHOICE", "", "alias of VORONOI"),
    ConfigKey("CELL_SIZE", "int", "max cell size", field="cell_size", lo=2),
    ConfigKey("WEIGHTS", "floats", "explicit weight grid", field="weights"),
    ConfigKey("MIN_WEIGHT", "float", "weight grid lower end", lo=0.0),
    ConfigKey("MAX_WEIGHT", "float", "weight grid upper end", lo=0.0),
    ConfigKey("WEIGHT_STEPS", "int", "weight grid size", lo=1),
    ConfigKey("TAUS", "floats", "quantile/expectile levels", field="taus"),
    ConfigKey("WAVE_SLOTS", "int", "slots per training wave",
              field="n_slots_per_wave", lo=1),
    ConfigKey("CHUNK_SIZE", "int", "streaming chunk rows",
              field="chunk_size", lo=1),
    ConfigKey("NPL_CONSTRAINT", "float", "NP false-alarm budget",
              select=True, lo=0.0, hi=1.0),
    ConfigKey("NPL_CLASS", "int", "NP constrained class", select=True,
              choices=(-1, 1)),
    ConfigKey("SERVE_OVERLAP", "bool", "blend the 2 nearest cells' decisions",
              serve=True),
    ConfigKey("DEADLINE_MS", "float", "async-stepper latency bound",
              serve=True, lo=0.0),
    ConfigKey("MAX_QUEUE", "int", "admission-queue bound (sheds on overflow)",
              serve=True, lo=1),
    ConfigKey("SWAP_POLL_MS", "float", "hot-swap watcher poll interval",
              serve=True, lo=0.0),
    ConfigKey("SLO_P99_MS", "float", "p99 latency SLO (burn-rate tracking)",
              monitor=True, lo=0.0),
    ConfigKey("DRIFT_WINDOW", "float", "drift/SLO rolling window seconds",
              monitor=True, lo=0.0),
    ConfigKey("DRIFT_REFRESH_THRESHOLD", "float",
              "drift score that triggers a targeted bank refresh",
              monitor=True, lo=0.0),
    ConfigKey("EMBED_ARCH", "str", "frozen-backbone arch id (:smoke variant)",
              embed=True),
    ConfigKey("EMBED_POOL", "str", "hidden-state pooling", embed=True,
              choices=("mean", "last")),
    ConfigKey("EMBED_CACHE", "path", "embedding-cache root directory",
              embed=True),
    ConfigKey("EMBED_BATCH", "int", "fixed batch shape for the backbone",
              embed=True, lo=1),
    ConfigKey("EMBED_SEED", "int", "frozen-backbone init seed", embed=True),
    ConfigKey("TRACE", "bool", "enable the span tracer", obs=True),
    ConfigKey("TRACE_OUT", "path", "write trace JSONL here on exit",
              obs=True),
    ConfigKey("METRICS_OUT", "path", "write metrics JSONL here on exit",
              obs=True),
    ConfigKey("PROFILE_DIR", "path", "torch.profiler capture directory",
              obs=True),
    ConfigKey("DISPLAY", "int", "verbosity (compat; ignored)", noop=True),
    ConfigKey("THREADS", "int", "thread count (compat; ignored)", noop=True),
]}

_SELECT_NAMES = {"NPL_CONSTRAINT": "alpha", "NPL_CLASS": "npl_class"}
_SERVE_NAMES = {"SERVE_OVERLAP": "overlap", "DEADLINE_MS": "deadline_ms",
                "MAX_QUEUE": "max_queue", "SWAP_POLL_MS": "swap_poll_ms"}
_MONITOR_NAMES = {"SLO_P99_MS": "slo_p99_ms",
                  "DRIFT_WINDOW": "drift_window_s",
                  "DRIFT_REFRESH_THRESHOLD": "drift_threshold"}
_OBS_NAMES = {"TRACE": "trace", "TRACE_OUT": "trace_out",
              "METRICS_OUT": "metrics_out", "PROFILE_DIR": "profile_dir"}
_EMBED_NAMES = {"EMBED_ARCH": "arch", "EMBED_POOL": "pooling",
                "EMBED_CACHE": "cache_dir", "EMBED_BATCH": "batch_size",
                "EMBED_SEED": "seed"}


class ConfigError(ValueError):
    """A config key or value failed validation."""


def available_keys() -> Tuple[str, ...]:
    return tuple(sorted(_KEYS))


def describe_keys() -> str:
    """Human-readable key table (the CLI's ``--help-keys``)."""
    rows = []
    for name in sorted(_KEYS):
        k = _KEYS[name]
        kind = k.kind or "int|str"
        extra = " (select stage)" if k.select else \
            " (serve stage)" if k.serve else \
            " (health monitor)" if k.monitor else \
            " (observability)" if k.obs else \
            " (embed stage)" if k.embed else \
            " (ignored)" if k.noop else ""
        rows.append(f"  {name:<20} {kind:<7} {k.doc}{extra}")
    return "\n".join(rows)


def _coerce(key: ConfigKey, raw: Any) -> Any:
    kind = key.kind
    try:
        if kind == "int":
            v: Any = int(raw)
        elif kind == "float":
            v = float(raw)
        elif kind == "bool":
            v = (raw.strip().lower() in ("1", "true", "yes", "on")
                 if isinstance(raw, str) else bool(raw))
        elif kind == "floats":
            if isinstance(raw, str):
                v = tuple(float(p) for p in raw.replace(",", " ").split())
            else:
                v = tuple(float(p) for p in np.atleast_1d(raw))
        elif kind == "str":
            v = str(raw).lower()
        elif kind == "path":
            # filesystem paths keep their case, unlike "str" enum values
            v = str(raw)
        else:                       # VORONOI: int code or method name
            s = str(raw).lower()
            if s in _CELL_NAMES:
                return s
            v = _CELL_CODES.get(int(s))
            if v is None:
                raise ValueError(s)
            return v
    except (TypeError, ValueError):
        raise ConfigError(
            f"{key.name}: cannot parse {raw!r} as {kind or 'int|str'}")
    if key.choices is not None and v not in key.choices:
        raise ConfigError(f"{key.name}: {v!r} not in {key.choices}")
    if key.lo is not None and v < key.lo:
        raise ConfigError(f"{key.name}: {v!r} below minimum {key.lo}")
    if key.hi is not None and v > key.hi:
        raise ConfigError(f"{key.name}: {v!r} above maximum {key.hi}")
    return v


def split_serve_keys(pairs: Dict[str, Any]
                     ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Partition raw key pairs into (non-serve pairs, engine kwargs).

    Serve-stage keys (SERVE_OVERLAP, DEADLINE_MS, MAX_QUEUE, SWAP_POLL_MS)
    configure the
    :class:`repro_torch.serve.SVMEngine`, not the trainer: callers that accept
    mixed string keys (the session front door, ``cli serve``) split them
    off here — validated/coerced — before ``apply_keys`` sees the rest.
    """
    rest: Dict[str, Any] = {}
    serve: Dict[str, Any] = {}
    for name, raw in pairs.items():
        canon = str(name).upper()
        k = _KEYS.get(canon)
        if k is not None and k.serve:
            serve[_SERVE_NAMES[canon]] = _coerce(k, raw)
        else:
            rest[name] = raw
    return rest, serve


def split_monitor_keys(pairs: Dict[str, Any]
                       ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Partition raw key pairs into (non-monitor pairs, monitor kwargs).

    Monitor keys (SLO_P99_MS, DRIFT_WINDOW, DRIFT_REFRESH_THRESHOLD)
    configure the :class:`repro_torch.serve.monitor.HealthMonitor` attached to an
    engine, not the trainer or the engine itself — callers pass the
    returned kwargs to ``HealthMonitor(engine, **kw)`` (or
    ``SVM(...).monitor()``).
    """
    rest: Dict[str, Any] = {}
    mon: Dict[str, Any] = {}
    for name, raw in pairs.items():
        canon = str(name).upper()
        k = _KEYS.get(canon)
        if k is not None and k.monitor:
            mon[_MONITOR_NAMES[canon]] = _coerce(k, raw)
        else:
            rest[name] = raw
    return rest, mon


def split_obs_keys(pairs: Dict[str, Any]
                   ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Partition raw key pairs into (non-obs pairs, obs kwargs).

    Observability keys (TRACE, METRICS_OUT, PROFILE_DIR) configure the
    process-global ``repro_torch.obs`` instruments, not the trainer or
    the engine — callers pass the returned kwargs to
    ``repro_torch.obs.configure``.
    """
    rest: Dict[str, Any] = {}
    ob: Dict[str, Any] = {}
    for name, raw in pairs.items():
        canon = str(name).upper()
        k = _KEYS.get(canon)
        if k is not None and k.obs:
            ob[_OBS_NAMES[canon]] = _coerce(k, raw)
        else:
            rest[name] = raw
    return rest, ob


def split_embed_keys(pairs: Dict[str, Any]
                     ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Partition raw key pairs into (non-embed pairs, embed kwargs).

    Embed-stage keys (EMBED_ARCH, EMBED_POOL, EMBED_CACHE, EMBED_BATCH,
    EMBED_SEED) configure :func:`repro_torch.embed.embed_source` — the frozen
    backbone that turns a TOKEN corpus into the feature source the trainer
    and engine consume.  Presence of ``arch`` in the returned kwargs is
    the signal that the x input is tokens: callers wrap it with
    ``embed_source(x, **kw)`` before anything touches the ChunkSource
    contract.
    """
    rest: Dict[str, Any] = {}
    emb: Dict[str, Any] = {}
    for name, raw in pairs.items():
        canon = str(name).upper()
        k = _KEYS.get(canon)
        if k is not None and k.embed:
            emb[_EMBED_NAMES[canon]] = _coerce(k, raw)
        else:
            rest[name] = raw
    if emb and "arch" not in emb:
        raise ConfigError(
            "EMBED_POOL/EMBED_CACHE/EMBED_BATCH/EMBED_SEED require "
            "EMBED_ARCH — without an architecture there is no backbone "
            "to embed with")
    return rest, emb


def parse_keys(pairs: Dict[str, Any]) -> Dict[str, Any]:
    """Normalize/validate a {key: value} mapping to canonical upper keys."""
    out: Dict[str, Any] = {}
    for name, raw in pairs.items():
        canon = name.upper()
        if canon == "PARTITION_CHOICE":
            canon = "VORONOI"
        if canon not in _KEYS:
            raise ConfigError(f"unknown config key {name!r}; known keys:\n"
                              + describe_keys())
        out[canon] = _coerce(_KEYS[canon], raw)
    return out


def apply_keys(base: SVMTrainerConfig, pairs: Dict[str, Any]
               ) -> Tuple[SVMTrainerConfig, Dict[str, Any]]:
    """Apply string keys onto a trainer config.

    Returns ``(config, select_params)`` — the select-stage keys
    (NPL_CONSTRAINT/NPL_CLASS) are routed to ``select()`` rather than the
    trainer.  MIN_WEIGHT/MAX_WEIGHT/WEIGHT_STEPS expand to a geometric
    weight grid (overridden by an explicit WEIGHTS).
    """
    keys = parse_keys(pairs)
    fields: Dict[str, Any] = {}
    select_params: Dict[str, Any] = {}
    w_lo = w_hi = w_steps = None
    for name, v in keys.items():
        k = _KEYS[name]
        if k.noop:
            continue
        if k.serve:
            raise ConfigError(
                f"{name} is a serve-stage key — it configures the engine, "
                f"not the trainer (use SVM(...).engine(), `cli serve`, or "
                f"split_serve_keys)")
        if k.monitor:
            raise ConfigError(
                f"{name} is a health-monitor key — it configures the "
                f"serving HealthMonitor, not the trainer (use "
                f"SVM(...).monitor(), `cli serve`, or split_monitor_keys)")
        if k.obs:
            raise ConfigError(
                f"{name} is an observability key — it configures "
                f"repro_torch.obs, not the trainer (the session front door and "
                f"the CLI split it off; see split_obs_keys)")
        if k.embed:
            raise ConfigError(
                f"{name} is an embed-stage key — it configures the frozen "
                f"embedding backbone, not the trainer (the session front "
                f"door, `cli embed` and `cli serve --tokens` split it "
                f"off; see split_embed_keys)")
        if name == "VORONOI":
            fields["cell_method"] = v
        elif name == "MIN_WEIGHT":
            w_lo = v
        elif name == "MAX_WEIGHT":
            w_hi = v
        elif name == "WEIGHT_STEPS":
            w_steps = v
        elif k.select:
            select_params[_SELECT_NAMES[name]] = v
        else:
            fields[k.field] = v
    if w_steps is not None or w_lo is not None or w_hi is not None:
        w_lo = 1.0 / 9.0 if w_lo is None else w_lo
        w_hi = 9.0 if w_hi is None else w_hi
        w_steps = 5 if w_steps is None else w_steps
        if "weights" not in fields:
            fields["weights"] = weight_grid(w_lo, w_hi, w_steps)
    cfg = dataclasses.replace(base, **fields)
    if cfg.kernel not in _registered_kernels():
        raise ConfigError(f"KERNEL: {cfg.kernel!r} not registered "
                          f"({_registered_kernels()})")
    return cfg, select_params


def weight_grid(lo: float, hi: float, steps: int) -> Tuple[float, ...]:
    """Geometric class-weight grid (the wSVM/rocSVM weight axis)."""
    if steps == 1:
        return (float(lo),)
    return tuple(float(v) for v in np.geomspace(lo, hi, steps))


def _registered_kernels() -> Tuple[str, ...]:
    from repro_torch.core import kernel_fns
    return tuple(sorted(kernel_fns._REGISTRY))
