"""Cell-routed SVM serving engine: overlap routing, async admission, deadlines.

The paper's test phase at serving scale.  Every query is Voronoi-routed
host-side (the same nearest-center rule the training decomposition uses),
requests accumulate per cell, and each launch drains the queues with ONE
batched launch over all active cells:

  * :func:`repro_torch.distributed.planner.plan_wave` turns the ragged
    per-cell queue depths into a static launch layout — hot cells are
    chunked into several slots, cold cells padded a little, shapes bucketed
    so repeated steps reuse the same launch shapes;
  * on CUDA the launch is the fused ``svm_predict_cells`` kernel (one
    kernel for the whole wave; the Gram never touches device memory);
    otherwise (``fused=False``, or the CPU) it is the batched
    distance-cache path: the batched D² kernel, the per-gamma epilogue
    kernel and one batched ``torch.matmul`` against the coefficients;
  * the wave's gamma-independent cross-D² is kept as a persistent cache
    keyed by the routed batch (``cache_dtype="bf16"`` halves it);
    ``sweep_gammas`` replays only the elementwise epilogue.

Three serving behaviours layer on top of the batched launch:

  * **overlap routing** — banks built from ``voronoi=5`` (overlap) models
    were TRAINED on 2-cell ownership; serving them 1-NN throws half the
    training signal away.  With ``routing="overlap"`` each request is
    routed to its 2 nearest centers via the SAME
    ``pipeline.assign._top2_chunk`` core the JAX package's cell builder
    uses (tie-breaks cannot drift) and the two cells' decision blocks are blended with
    distance-softmax weights (:func:`blend_weights`; exactly (0.5, 0.5) for
    equidistant rows, exactly (1, 0) when no second cell is reachable —
    and the engine falls back to exact 1-NN when the bank says
    ``routing="nearest"`` or has fewer than two cells);
  * **async admission** — ``begin_step()`` snapshots the admission queues
    into one wave and DISPATCHES it without blocking; ``submit()`` stays
    legal while the wave is in flight (a double-buffered queue pair), so
    host-side routing/packing of wave w+1 overlaps the device work of wave
    w, which is left in flight on the current CUDA stream;
    ``finish_step()`` collects, and its copy to the host is the only
    synchronisation.  ``step()`` is the synchronous begin+finish pair;
  * **latency-bounded stepping** — :meth:`run` drives an arrival stream
    and launches when the queued rows would fill a bucketed wave OR the
    oldest queued request's age crosses ``deadline_ms``; every launch
    records occupancy and a request-age histogram (``wave_stats``,
    aggregated by ``stats()``).

Slots are LPT-ordered by :func:`plan_wave`, so sharding the slot axis over
several cards inherits balanced waves; this engine runs on one device.
"""
from __future__ import annotations

import collections
import dataclasses
import hashlib
import time
from typing import Callable, Dict, Iterable, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch import obs
from repro_torch.distributed.planner import WavePlan, plan_wave
from repro_torch.kernels import runtime
from repro_torch.kernels.kernel_matrix import ops as km_ops
from repro_torch.kernels.svm_predict import ops as sp_ops
from repro_torch.obs import profiler
from repro_torch.obs.trace import RingBuffer
from repro_torch.pipeline.assign import nearest_center, nearest_top2_dists
from repro_torch.serve.model_bank import ModelBank
from repro_torch.tasks.builder import combine_decisions
from repro_torch.testing import faults

_ROUTE_CHUNK = 4096

# request-age histogram bucket upper edges (ms); the last bucket is open
AGE_BUCKETS_MS = (1.0, 2.0, 5.0, 10.0, 20.0, 50.0, 100.0)

# rid -> serving bank version attributions kept for late readers (bounded:
# overload protection must bound EVERY per-request structure)
_SERVED_VERSION_CAP = 65536

# recent-wave detail window; exact aggregates live in running sums so a
# long-running serve loop cannot grow memory by being observed
_WAVE_STATS_CAP = 512

# the per-wave host stages every served response decomposes into
_STAGES = ("queue", "pack", "dispatch", "device", "collect")


class OverloadError(RuntimeError):
    """Admission rejected by the bounded queue (graceful degradation).

    Carries a machine-readable ``code`` and ``retryable=True``: the queue
    drains at the next wave, so the caller should back off and retry
    rather than treat this as a hard failure.  No request id is assigned —
    a shed request was never admitted.
    """

    code = "ENGINE_OVERLOADED"
    retryable = True


def blend_weights(d1: np.ndarray, d2: np.ndarray
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Distance-softmax blend weights for a request's two nearest cells.

    ``softmax(-d²)`` over the pair, computed stably from the non-negative
    gap: ``w1 = 1 / (1 + exp(-(d2 - d1)))``, ``w2 = 1 - w1`` (f32).  An
    exactly equidistant row gets exactly ``(0.5, 0.5)``; a second cell far
    enough that the gap underflows ``exp`` gets exactly ``(1.0, 0.0)`` —
    the engine then enqueues a single part, which is also how far-away
    padding-slot centers drop out of blending.
    """
    delta = np.asarray(d2, np.float32) - np.asarray(d1, np.float32)
    w1 = (np.float32(1.0) / (np.float32(1.0) + np.exp(-delta))).astype(
        np.float32)
    return w1, np.float32(1.0) - w1


@dataclasses.dataclass
class _Request:
    """Blend state of one submitted request.

    Parts arrive from (possibly different) waves in any order; the blend
    ``sum_p w_p * vals[p]`` is evaluated in FIXED part order once every
    part landed, so completion numerics are independent of the
    async/sync interleaving that served the parts.
    """
    weights: Tuple[np.float32, ...]
    vals: List[Optional[np.ndarray]]
    ts: float
    left: int
    raw: np.ndarray     # original (unscaled) feature row: a hot swap
                        # re-scales + re-routes still-queued requests
                        # against the new bank's scaling and centers
    version: int        # bank version the request is currently routed with


def _wave_d2(xt: torch.Tensor, sv: torch.Tensor) -> torch.Tensor:
    """(n_slots, m, d) x (n_slots, k, d) -> (n_slots, m, k) cross-D², one
    batched launch (both built-in kernels factor through the same D²)."""
    return km_ops.sq_dists(xt, sv)


def _decide_cells(d2: torch.Tensor, gammas: torch.Tensor,
                  coefs: torch.Tensor, kernel: str) -> torch.Tensor:
    """Per-gamma epilogue + contraction over a cached wave D².

    d2 (C, m, k) f32 or bf16; gammas (C, P); coefs (C, k, P) -> (C, m, P).
    Column p of cell c is ``gram_from_d2(d2[c], gammas[c, p]) @ coefs[c, :,
    p]``: one epilogue launch builds every (cell, column) Gram plane, one
    batched matmul contracts each plane with its own coefficient column.
    """
    k = km_ops.gram_from_d2(d2, gammas, kind=kernel)         # (C, P, m, k)
    cols = coefs.transpose(1, 2).unsqueeze(-1)               # (C, P, k, 1)
    return torch.matmul(k, cols).squeeze(-1).transpose(1, 2)


def _sweep_cells(d2: torch.Tensor, sweep_gammas: torch.Tensor,
                 coefs: torch.Tensor, kernel: str) -> torch.Tensor:
    """Replay the epilogue for a whole gamma grid over one cached wave D².

    (C, m, k) x (G,) x (C, k, P) -> (G, C, m, P): the multi-gamma serving
    scan — no cross term at all, the D² was paid when the wave first ran.
    One gamma serves every column, so each (cell, gamma) Gram plane is
    contracted with the whole coefficient block at once.
    """
    gg = sweep_gammas[None, :].expand(d2.shape[0], -1).contiguous()
    k = km_ops.gram_from_d2(d2, gg, kind=kernel)             # (C, G, m, k)
    return torch.matmul(k, coefs.unsqueeze(1)).transpose(0, 1)


class SVMEngine:
    """Serve micro-batched queries against a compacted :class:`ModelBank`.

    ``device=None`` serves on the current CUDA device and raises when
    there is none; ``device="cpu"`` runs the plain PyTorch path.
    ``fused=None`` means the fused kernel on CUDA and the distance-cache
    path on the CPU.  ``overlap=None`` reads the bank's recorded routing
    mode (``routing="overlap"`` for ``VORONOI=5`` fits); ``deadline_ms``
    is the default latency bound for :meth:`run`; ``clock`` is injectable
    for deterministic deadline/shedding tests.

    Overload protection: ``max_queue`` bounds the admission queue in launch
    rows — a ``submit()`` that would exceed it raises :class:`OverloadError`
    (retry-able, no id assigned) instead of growing memory without bound;
    ``shed_ms`` additionally rejects NEW admissions while the oldest queued
    request is older than the bound (deadline-based shedding: when the
    engine is this far behind, new arrivals would miss their deadline
    anyway, so they are turned away while the backlog drains).

    Hot swap: :meth:`swap_bank` replaces the bank mid-flight — see its
    docstring.

    Observability: every wave's pack/dispatch/device/collect host stages
    are timed unconditionally (one ``clock()`` read per boundary) into
    ``wave_stats`` (bounded ring + exact running aggregates, see
    ``stats()["per_stage"]``), every completed request gets a
    queue/pack/dispatch/device/collect breakdown (:meth:`breakdown`), and
    the same timestamps feed the ``tracer``/``metrics`` instruments —
    defaulting to the process-global ``repro_torch.obs`` pair, injectable
    for tests.  A disabled tracer costs one attribute test per site.
    """

    def __init__(
        self,
        bank: ModelBank,
        *,
        device: Union[None, str, torch.device] = None,
        fused: Optional[bool] = None,
        cache_dtype: str = "f32",
        row_bucket: int = 8,
        slot_bucket: int = 4,
        max_cached_d2: int = 8,
        overlap: Optional[bool] = None,
        deadline_ms: Optional[float] = None,
        fill_rows: Optional[int] = None,
        max_queue: Optional[int] = None,
        shed_ms: Optional[float] = None,
        clock: Callable[[], float] = time.monotonic,
        tracer: Optional["obs.Tracer"] = None,
        metrics: Optional["obs.MetricsRegistry"] = None,
    ):
        if cache_dtype not in ("f32", "bf16"):
            raise ValueError(f"cache_dtype must be f32|bf16, got {cache_dtype!r}")
        self.device = runtime.resolve_device(device)
        self.fused = (self.device.type == "cuda") if fused is None \
            else bool(fused)
        self.cache_dtype = cache_dtype
        self.row_bucket = row_bucket
        self.slot_bucket = slot_bucket
        self.max_cached_d2 = max_cached_d2
        self._overlap_pref = overlap
        self.deadline_ms = deadline_ms
        # "m_pad fills": one bucketed wave's worth of rows triggers a launch
        self.fill_rows = (row_bucket * slot_bucket if fill_rows is None
                          else int(fill_rows))
        self.max_queue = None if max_queue is None else int(max_queue)
        self.shed_ms = None if shed_ms is None else float(shed_ms)
        self._clock = clock

        self._reqs: Dict[int, _Request] = {}
        self._inflight: Optional[tuple] = None
        self._next_id = 0
        self._d2_cache: "collections.OrderedDict[bytes, torch.Tensor]" = \
            collections.OrderedDict()
        self._last_wave: Optional[dict] = None
        self.counters = collections.Counter()
        # recent-wave window; stats() aggregates come from the running
        # sums below so they stay EXACT after the ring wraps
        self.wave_stats = RingBuffer(_WAVE_STATS_CAP)
        self._occ_sum = 0.0
        self._age_ms_max = 0.0
        self._age_hist_sum = [0] * (len(AGE_BUCKETS_MS) + 1)
        self._stage_ms = {s: 0.0 for s in _STAGES}
        self._stage_n = {s: 0 for s in _STAGES}
        # rid -> bank version that served it (bounded; see swap_bank)
        self.served_version: "collections.OrderedDict[int, int]" = \
            collections.OrderedDict()
        # rid -> per-stage latency breakdown of the completing wave
        # (bounded like served_version; read via breakdown())
        self.served_breakdown: "collections.OrderedDict[int, dict]" = \
            collections.OrderedDict()
        self._tracer = obs.tracer if tracer is None else tracer
        self._metrics = obs.metrics if metrics is None else metrics
        self._m_request_ms = self._metrics.histogram("serve.request_ms")
        self._m_request_q = self._metrics.sketch("serve.request_ms.q")
        self._m_served = self._metrics.counter("serve.served")
        self._m_shed = self._metrics.counter("serve.shed")
        self._m_waves = self._metrics.counter("serve.waves")
        # health monitor hook (attach_monitor); detached cost is one
        # `is not None` test per batch/wave
        self._monitor = None
        self._bind_bank(bank)

    def attach_monitor(self, monitor) -> None:
        """Attach (or detach with ``None``) a health monitor.  The engine
        feeds it per-batch routing distances (``observe_routing``) and
        per-wave completed-request latencies (``observe_requests``)."""
        self._monitor = monitor

    def _bind_bank(self, bank: ModelBank) -> None:
        """Point every bank-derived structure at ``bank``.

        Fresh admission queues are sized to the new cell count; the wave-D²
        cache and the last-wave handle are dropped (they index the OLD
        bank's SV tables).  An in-flight wave is untouched — it carries its
        own snapshot of everything it needs (see ``begin_step``).
        """
        self.bank = bank
        # 1-NN fallback is EXACT: a bank built with voronoi<5 records
        # routing="nearest", and blending needs a second center to exist
        want = ((bank.routing == "overlap") if self._overlap_pref is None
                else bool(self._overlap_pref))
        if want and bank.n_cells < 2:
            self.counters["routing_degraded"] += 1
        self.overlap = want and bank.n_cells >= 2

        self._sv, self._coefs = bank.cell_arrays_f32(self.device)
        self._gammas = torch.as_tensor(
            np.asarray(bank.gammas, np.float32)).to(self.device)
        self._centers = np.asarray(bank.centers, np.float32)

        # admission buffer: per-cell (rid, part, row); begin_step snapshots
        # it into a wave and swaps in a fresh buffer (double buffering)
        self._queues: List[List[Tuple[int, int, np.ndarray]]] = [
            [] for _ in range(bank.n_cells)]
        self._d2_cache.clear()
        self._last_wave = None

    # ------------------------------------------------------------- ingestion
    def route(self, x: np.ndarray) -> np.ndarray:
        """Nearest-center Voronoi cell ids for already-scaled queries.

        Same chunked GEMM-form helper the JAX package's cell plan routes
        with, so serve-time routing and the decomposition's ownership rule
        cannot drift apart.  Host numpy, bit-identical to
        the JAX package's router.
        """
        return nearest_center(x, self._centers,
                              chunk_size=_ROUTE_CHUNK).astype(np.int64)

    def route_top2(self, x: np.ndarray
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Two nearest cells + blend weights for already-scaled queries.

        ``pipeline.assign.nearest_top2_dists`` — the overlap cell builder's
        ``_top2_chunk`` core, copied verbatim — so the serve-time
        pair (tie-breaking included) matches the 2-cell training ownership.
        """
        c1, c2, d1, d2 = nearest_top2_dists(x, self._centers,
                                            chunk_size=_ROUTE_CHUNK)
        w1, w2 = blend_weights(d1, d2)
        return c1.astype(np.int64), c2.astype(np.int64), w1, w2

    def submit(self, x: np.ndarray, now: Optional[float] = None) -> np.ndarray:
        """Enqueue queries (raw feature space); returns request ids.

        Legal at ANY time, including while a wave is in flight — admission
        lands in the fresh queue buffer and is consumed by the next
        ``begin_step()``.  Overlap banks enqueue up to two weighted parts
        per request; parts are merged at completion (``finish_step``).

        With a bounded queue (``max_queue`` / ``shed_ms``) an over-limit
        batch raises :class:`OverloadError` BEFORE any id is assigned —
        admission is all-or-nothing per batch, so a shed batch leaves no
        partial state behind.
        """
        x = np.asarray(x, np.float32)
        if x.ndim == 1:
            x = x[None, :]
        faults.fire("engine.submit", rows=x.shape[0])
        ts = float(self._clock()) if now is None else float(now)
        if x.shape[0]:
            self._admission_check(x.shape[0], ts)
        ids = np.arange(self._next_id, self._next_id + x.shape[0],
                        dtype=np.int64)
        self._next_id += x.shape[0]
        self._enqueue(x, ids, np.full((x.shape[0],), ts, np.float64))
        self.counters["submitted"] += x.shape[0]
        return ids

    def _admission_check(self, m: int, now: float) -> None:
        """Bounded-queue gate; raises :class:`OverloadError` to shed."""
        if self.max_queue is not None:
            parts = m * (2 if self.overlap else 1)
            if self.pending + parts > self.max_queue:
                self.counters["shed_overflow"] += 1
                self.counters["shed_rows"] += m
                self._m_shed.inc()
                raise OverloadError(
                    f"[{OverloadError.code}] admission queue full "
                    f"({self.pending} parts queued, batch needs {parts}, "
                    f"max_queue={self.max_queue}); retry after a step")
        if self.shed_ms is not None and self.pending:
            age = self.oldest_age_ms(now)
            if age >= self.shed_ms:
                self.counters["shed_stale"] += 1
                self.counters["shed_rows"] += m
                self._m_shed.inc()
                raise OverloadError(
                    f"[{OverloadError.code}] backlog too stale (oldest "
                    f"queued request {age:.1f} ms >= shed_ms="
                    f"{self.shed_ms}); retry after the backlog drains")

    def _enqueue(self, x_raw: np.ndarray, ids: np.ndarray,
                 ts: np.ndarray) -> None:
        """Scale, route and queue rows under the CURRENT bank (used by
        both fresh admission and post-swap re-admission, which is why raw
        rows and per-row timestamps come in explicitly)."""
        xs = (x_raw - self.bank.feat_mean) / self.bank.feat_std
        version = int(self.bank.version)
        if self.overlap:
            with self._tracer.span("serve.route"):
                c1, c2, w1, w2 = self.route_top2(xs)
            if self._monitor is not None:
                self._observe_routing(xs, c1)
            for i, rid in enumerate(map(int, ids)):
                parts = [(int(c1[i]), np.float32(w1[i]))]
                if w2[i] > 0.0:          # unreachable 2nd cell: single part
                    parts.append((int(c2[i]), np.float32(w2[i])))
                self._reqs[rid] = _Request(
                    weights=tuple(w for _, w in parts),
                    vals=[None] * len(parts), ts=float(ts[i]),
                    left=len(parts), raw=x_raw[i], version=version)
                for p, (c, _) in enumerate(parts):
                    self._queues[c].append((rid, p, xs[i]))
        else:
            with self._tracer.span("serve.route"):
                cells = self.route(xs)
            if self._monitor is not None:
                self._observe_routing(xs, cells)
            for i, rid in enumerate(map(int, ids)):
                self._reqs[rid] = _Request(
                    weights=(np.float32(1.0),), vals=[None],
                    ts=float(ts[i]), left=1, raw=x_raw[i], version=version)
                self._queues[int(cells[i])].append((rid, 0, xs[i]))

    def _observe_routing(self, xs: np.ndarray, primary: np.ndarray) -> None:
        """Feed the attached monitor each row's squared distance to its
        PRIMARY routing center — O(m*d), uniform across the nearest and
        overlap paths, and the same quantity the bank's train-time
        ``route_baseline`` recorded."""
        diff = xs - self._centers[primary]
        d2 = np.einsum("ij,ij->i", diff, diff)
        self._monitor.observe_routing(primary, d2,
                                      now=float(self._clock()))

    # ------------------------------------------------------------- hot swap
    def swap_bank(self, new_bank: ModelBank, *, force: bool = False) -> dict:
        """Swap the serving bank, mid-flight, with zero downtime.

        The in-flight wave (if any) FINISHES on the old bank — it was
        dispatched with a full snapshot (decisions, entry map, shape,
        version), so nothing it needs is rebound.  Still-QUEUED requests
        are re-admitted against the new bank: re-scaled with its feature
        scaling, re-routed against its centers, original request ids and
        admission timestamps preserved.  This is whole-request by
        construction — ``begin_step`` drains every queue into the wave, so
        a request is either fully in flight or fully queued, never split
        across banks.

        Versions are monotonic: ``new_bank.version`` must be strictly
        greater than the serving version unless ``force=True`` (an
        emergency rollback; counted as ``bank_fallbacks``).  The new bank
        must be decision-compatible (same feature dim and (n_tasks, n_sub)
        block shape); cell count, SV tables, routing mode and scaling may
        all change freely.

        Returns ``{"version", "requeued"}``; counters: ``swaps``,
        ``swap_requeued``, ``bank_fallbacks``, ``routing_degraded``.
        """
        faults.fire("engine.swap")
        d_old = self._centers.shape[1]
        d_new = np.asarray(new_bank.centers).shape[1]
        if d_new != d_old:
            raise ValueError(
                f"swap_bank: feature dim changed ({d_old} -> {d_new})")
        if (new_bank.n_tasks, new_bank.n_sub) != (self.bank.n_tasks,
                                                  self.bank.n_sub):
            raise ValueError(
                "swap_bank: decision block shape changed "
                f"(({self.bank.n_tasks}, {self.bank.n_sub}) -> "
                f"({new_bank.n_tasks}, {new_bank.n_sub}))")
        if int(new_bank.version) <= int(self.bank.version):
            if not force:
                raise ValueError(
                    f"swap_bank: version must be strictly newer (serving "
                    f"v{self.bank.version}, offered v{new_bank.version}); "
                    f"pass force=True to roll back")
            self.counters["bank_fallbacks"] += 1

        queued_rids: List[int] = []
        seen = set()
        for q in self._queues:
            for rid, _part, _row in q:
                if rid not in seen:
                    seen.add(rid)
                    queued_rids.append(rid)
        requeue = [(rid, self._reqs.pop(rid)) for rid in queued_rids]

        self._bind_bank(new_bank)

        if requeue:
            raws = np.stack([r.raw for _, r in requeue]).astype(np.float32)
            ids = np.asarray([rid for rid, _ in requeue], np.int64)
            ts = np.asarray([r.ts for _, r in requeue], np.float64)
            self._enqueue(raws, ids, ts)
            self.counters["swap_requeued"] += len(requeue)
        self.counters["swaps"] += 1
        return {"version": int(new_bank.version), "requeued": len(requeue)}

    @property
    def pending(self) -> int:
        """Queued launch rows (overlap requests count once per part)."""
        return sum(len(q) for q in self._queues)

    @property
    def in_flight(self) -> bool:
        return self._inflight is not None

    def oldest_age_ms(self, now: Optional[float] = None) -> float:
        """Age of the oldest QUEUED (not yet launched) request, ms."""
        now = float(self._clock()) if now is None else float(now)
        ts = [self._reqs[rid].ts for q in self._queues for (rid, _, _) in q]
        return 0.0 if not ts else (now - min(ts)) * 1e3

    # -------------------------------------------------------------- the step
    def begin_step(self) -> bool:
        """Snapshot the admission queues into one wave and DISPATCH it.

        Non-blocking: the batched launch is left in flight on the current
        stream and a fresh admission buffer is swapped in, so
        routing/packing of the next wave (and any amount of ``submit()``
        traffic) overlaps the device work.  Returns False when nothing was
        queued.
        """
        if self._inflight is not None:
            raise RuntimeError(
                "a wave is already in flight - call finish_step() first")
        faults.fire("engine.begin_step")
        t_begin = float(self._clock())
        counts = np.asarray([len(q) for q in self._queues], np.int64)
        plan = plan_wave(counts, row_bucket=self.row_bucket,
                         slot_bucket=self.slot_bucket)
        if plan.n_requests == 0:
            return False
        queues, self._queues = self._queues, [
            [] for _ in range(self.bank.n_cells)]
        d = self._centers.shape[1]
        xt = np.zeros((plan.n_slots, plan.m_pad, d), np.float32)
        slot_entries: List[List[Tuple[int, int]]] = []
        now = float(self._clock())
        ages: List[float] = []
        for s in range(plan.n_slots):
            cid, off, take = (int(plan.slot_cell[s]), int(plan.slot_off[s]),
                              int(plan.slot_take[s]))
            entries: List[Tuple[int, int]] = []
            if cid >= 0:
                for r, (rid, part, row) in enumerate(queues[cid][off:off + take]):
                    xt[s, r] = row
                    entries.append((rid, part))
                    ages.append((now - self._reqs[rid].ts) * 1e3)
            slot_entries.append(entries)
        t_pack = float(self._clock())

        cell_idx = np.maximum(plan.slot_cell, 0)     # padding slots: ignored rows
        with profiler.step("serve_wave", self.wave_stats.total):
            dec = self._evaluate(xt, cell_idx)
        t_disp = float(self._clock())
        rec = self._record_wave(plan, ages,
                                pack_ms=(t_pack - t_begin) * 1e3,
                                dispatch_ms=(t_disp - t_pack) * 1e3)
        # full snapshot: a swap_bank between begin and finish must not
        # change what this wave returns or which version it is tagged with
        # (rec rides along so finish_step can attach device/collect times)
        self._inflight = (plan, slot_entries, dec,
                          self.bank.n_tasks, self.bank.n_sub,
                          int(self.bank.version), rec)
        self._tracer.record("serve.pack", t_begin, t_pack)
        self._tracer.record("serve.dispatch", t_pack, t_disp)
        self._m_waves.inc()
        self.counters["steps"] += 1
        return True

    def finish_step(self) -> Dict[int, np.ndarray]:
        """Collect the in-flight wave (blocking).

        Returns ``{request_id: (n_tasks, n_sub) decision block}`` for every
        request COMPLETED by this wave — an overlap request whose second
        part is still queued stays pending and is returned by the wave that
        serves its last part.  Blending (``sum_p w_p * part_p``) happens
        here, in fixed part order, in f32.

        Every completion is attributed to the bank version the wave was
        DISPATCHED with (``served_version[rid]``, plus a per-version
        ``served_v<N>`` counter) — under a mid-flight swap, old-wave
        responses carry the old version and post-swap admissions the new
        one, so every response is attributable to exactly one bank.
        """
        if self._inflight is None:
            return {}
        plan, slot_entries, dec, t, s_count, version, rec = self._inflight
        self._inflight = None
        t_wait = float(self._clock())
        dec = dec.cpu().numpy()          # the wave's one synchronisation
        t_dev = float(self._clock())
        results: Dict[int, np.ndarray] = {}
        done_ts: List[Tuple[int, float]] = []
        for s, entries in enumerate(slot_entries):
            for r, (rid, part) in enumerate(entries):
                req = self._reqs[rid]
                req.vals[part] = dec[s, r].reshape(t, s_count)
                req.left -= 1
                if req.left == 0:
                    out = req.weights[0] * req.vals[0]
                    for p in range(1, len(req.vals)):
                        out = out + req.weights[p] * req.vals[p]
                    results[rid] = out
                    del self._reqs[rid]
                    done_ts.append((rid, req.ts))
                    self.served_version[rid] = version
                    while len(self.served_version) > _SERVED_VERSION_CAP:
                        self.served_version.popitem(last=False)
        t_col = float(self._clock())
        device_ms = (t_dev - t_wait) * 1e3
        collect_ms = (t_col - t_dev) * 1e3
        rec["device_ms"] = device_ms
        rec["collect_ms"] = collect_ms
        self._stage_ms["device"] += device_ms
        self._stage_ms["collect"] += collect_ms
        self._stage_n["device"] += 1
        self._stage_n["collect"] += 1
        self._tracer.record("serve.device", t_wait, t_dev)
        self._tracer.record("serve.collect", t_dev, t_col)
        # per-response latency attribution: total is exact; queue is the
        # residual (time not spent in this wave's pack/dispatch/device/
        # collect — i.e. waiting in the admission queue or an earlier wave)
        wave_ms = rec["pack_ms"] + rec["dispatch_ms"] + device_ms + collect_ms
        totals: List[float] = []
        for rid, ts in done_ts:
            total_ms = (t_col - ts) * 1e3
            totals.append(total_ms)
            queue_ms = max(total_ms - wave_ms, 0.0)
            self._stage_ms["queue"] += queue_ms
            self._stage_n["queue"] += 1
            self._m_request_ms.observe(total_ms)
            self._m_request_q.observe(total_ms)
            self.served_breakdown[rid] = {
                "wave": rec["wave"], "total_ms": total_ms,
                "queue_ms": queue_ms, "pack_ms": rec["pack_ms"],
                "dispatch_ms": rec["dispatch_ms"],
                "device_ms": device_ms, "collect_ms": collect_ms}
            while len(self.served_breakdown) > _SERVED_VERSION_CAP:
                self.served_breakdown.popitem(last=False)
                self.counters["breakdown_evicted"] += 1
        if self._monitor is not None and totals:
            self._monitor.observe_requests(totals, now=t_col)
        self._m_served.inc(len(results))
        self.counters["served"] += len(results)
        self.counters[f"served_v{version}"] += len(results)
        self.counters["served_rows"] += plan.n_requests
        # counted here, with served_rows, so stats() ratios stay consistent
        # while a wave is in flight
        self.counters["launched_rows"] += plan.n_slots * plan.m_pad
        return results

    def step(self) -> Dict[int, np.ndarray]:
        """Synchronous drain: dispatch (unless a wave is already in flight)
        and collect."""
        if self._inflight is None:
            self.begin_step()
        return self.finish_step()

    def _record_wave(self, plan: WavePlan, ages: List[float], *,
                     pack_ms: float, dispatch_ms: float) -> dict:
        """Append one wave record to the ring AND fold it into the running
        aggregates (``stats()`` reads the sums, so it stays exact after the
        ring wraps).  ``device_ms``/``collect_ms`` are filled in by
        ``finish_step`` mutating the returned dict."""
        a = np.asarray(ages, np.float64)
        hist = np.bincount(np.searchsorted(AGE_BUCKETS_MS, a, side="right"),
                           minlength=len(AGE_BUCKETS_MS) + 1)
        rec = {
            "wave": self.wave_stats.total,      # 0-based wave sequence no.
            "n_rows": plan.n_requests,
            "n_slots": plan.n_slots,
            "m_pad": plan.m_pad,
            "occupancy": plan.n_requests / max(plan.n_slots * plan.m_pad, 1),
            "oldest_ms": float(a.max()) if a.size else 0.0,
            "age_ms_mean": float(a.mean()) if a.size else 0.0,
            "age_hist": hist.tolist(),
            "pack_ms": pack_ms,
            "dispatch_ms": dispatch_ms,
            "device_ms": 0.0,
            "collect_ms": 0.0,
        }
        self.wave_stats.append(rec)
        self._occ_sum += rec["occupancy"]
        if rec["oldest_ms"] > self._age_ms_max:
            self._age_ms_max = rec["oldest_ms"]
        for i, n in enumerate(rec["age_hist"]):
            self._age_hist_sum[i] += n
        self._stage_ms["pack"] += pack_ms
        self._stage_ms["dispatch"] += dispatch_ms
        self._stage_n["pack"] += 1
        self._stage_n["dispatch"] += 1
        return rec

    def breakdown(self, rid: int) -> Optional[dict]:
        """Per-stage latency breakdown of a completed request:
        ``{wave, total_ms, queue_ms, pack_ms, dispatch_ms, device_ms,
        collect_ms}`` with ``total = queue + pack + dispatch + device +
        collect`` exactly (queue is the residual: admission-queue wait plus
        any earlier wave that served only part of an overlap request).

        ``None`` has two distinct causes a caller can tell apart:

          * the rid never completed here (unknown id, still pending, or
            shed) — ``stats()["breakdown_evicted"]`` is unchanged by such
            lookups and stays 0 on an engine that never wrapped;
          * the entry was EVICTED from the bounded ring (oldest-first, cap
            ``_SERVED_VERSION_CAP``) — every eviction increments
            ``breakdown_evicted``, so a nonzero counter says old rids are
            being dropped and a late reader holding one should treat its
            ``None`` as "aged out", not "never served".
        """
        return self.served_breakdown.get(int(rid))

    # -------------------------------------------------- latency-bounded run
    def should_launch(self, deadline_ms: Optional[float] = None,
                      now: Optional[float] = None) -> bool:
        """The launch policy: queued rows fill a bucketed wave, OR the
        oldest queued request's age crosses the deadline."""
        rows = self.pending
        if rows == 0:
            return False
        if rows >= self.fill_rows:
            return True
        deadline_ms = self.deadline_ms if deadline_ms is None else deadline_ms
        return (deadline_ms is not None
                and self.oldest_age_ms(now) >= deadline_ms)

    def run(self, traffic: Iterable[Optional[np.ndarray]],
            deadline_ms: Optional[float] = None,
            max_queue: Optional[int] = None) -> Dict[int, np.ndarray]:
        """Latency-bounded async serving over an arrival stream.

        ``traffic`` yields request batches ((m, d) raw-feature arrays);
        yield ``None`` or an empty batch as an idle tick so the deadline
        can force a partially-filled launch.  Launches follow
        :meth:`should_launch`; each one is dispatched right after the
        PREVIOUS wave is collected, so admission and host routing/packing
        overlap device work.  Exhausting ``traffic`` drains everything.
        Returns ``{request_id: blended (n_tasks, n_sub) decision block}``
        for every ADMITTED request.

        ``max_queue`` (or the engine-level default) bounds the admission
        queue for the duration of the run: an arrival batch that would
        overflow is SHED — rejected with :class:`OverloadError` at
        admission, counted in ``shed_*``, never assigned an id — and the
        run continues.  Graceful degradation instead of unbounded memory.
        """
        results: Dict[int, np.ndarray] = {}
        prev_mq = self.max_queue
        if max_queue is not None:
            self.max_queue = int(max_queue)
        try:
            for batch in traffic:
                if batch is not None and np.size(batch):
                    try:
                        self.submit(batch)
                    except OverloadError:
                        pass             # shed; visible in shed_* counters
                if self.should_launch(deadline_ms):
                    if self._inflight is not None:
                        results.update(self.finish_step())
                    self.begin_step()
            if self._inflight is not None:
                results.update(self.finish_step())
            while self.pending:
                results.update(self.step())
        finally:
            self.max_queue = prev_mq
        return results

    def launch_operands(self, xt: np.ndarray, cell_idx: np.ndarray
                        ) -> Tuple[torch.Tensor, ...]:
        """The fused launch's operands for a packed wave, on the engine's
        device: ``xt`` (n_slots, m_pad, d) and the SV tables, coefficients
        and gammas of the slots' cells ``cell_idx`` (n_slots,), as
        ``sp_ops.svm_predict_cells`` takes them with ``bank.kernel``."""
        xt_d, idx_d = self._upload(xt, cell_idx)
        return (xt_d, *self._cell_operands(idx_d))

    def _upload(self, xt: np.ndarray, cell_idx: np.ndarray):
        return (torch.from_numpy(xt).to(self.device, non_blocking=True),
                torch.from_numpy(cell_idx).to(self.device, non_blocking=True))

    def _cell_operands(self, idx_d: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        return tuple(t.index_select(0, idx_d)
                     for t in (self._sv, self._coefs, self._gammas))

    def _evaluate(self, xt: np.ndarray, cell_idx: np.ndarray
                  ) -> torch.Tensor:
        """Upload the packed wave and enqueue its launch(es); returns the
        (n_slots, m_pad, P) decisions without waiting for the device."""
        xt_d, idx_d = self._upload(xt, cell_idx)
        self._last_wave = {"xt": xt, "cell_idx": cell_idx, "xt_d": xt_d,
                           "idx_d": idx_d, "d2": None}
        if self.fused:
            # one fused launch; the Gram never touches device memory
            return sp_ops.svm_predict_cells(
                xt_d, *self._cell_operands(idx_d), kind=self.bank.kernel)
        co_w = self._coefs.index_select(0, idx_d)
        ga_w = self._gammas.index_select(0, idx_d)
        d2 = self._d2_for(self._last_wave)
        self._last_wave["d2"] = d2
        return _decide_cells(d2, ga_w, co_w, self.bank.kernel)

    # --------------------------------------------------- persistent wave D²
    @staticmethod
    def _wave_key(xt: np.ndarray, cell_idx: np.ndarray) -> bytes:
        """Cache key of a routed wave, hashed from the HOST arrays (never a
        copy back from the device)."""
        h = hashlib.blake2b(digest_size=16)
        h.update(xt.tobytes())
        h.update(cell_idx.tobytes())
        return h.digest()

    def _d2_for(self, wave: dict) -> torch.Tensor:
        key = self._wave_key(wave["xt"], wave["cell_idx"])
        hit = self._d2_cache.get(key)
        if hit is not None:
            self._d2_cache.move_to_end(key)
            self.counters["d2_hits"] += 1
            return hit
        self.counters["d2_misses"] += 1
        sv_w = self._sv.index_select(0, wave["idx_d"])
        d2 = _wave_d2(wave["xt_d"], sv_w)
        if self.cache_dtype == "bf16":
            d2 = d2.to(torch.bfloat16)
        self._d2_cache[key] = d2
        while len(self._d2_cache) > self.max_cached_d2:
            self._d2_cache.popitem(last=False)
        return d2

    def sweep_gammas(self, gammas: np.ndarray) -> torch.Tensor:
        """Re-evaluate the LAST wave for a whole gamma grid.

        The cached cross-D² is replayed through the per-gamma epilogue only
        — (G,) gammas cost G elementwise passes, zero cross terms.  Returns
        (G, n_slots, m_pad, P) raw slot decisions (padding rows included)
        on the engine's device.
        """
        if self._last_wave is None:
            raise RuntimeError("no wave evaluated yet — call step() first")
        w = self._last_wave
        d2 = w["d2"]
        if d2 is None:                    # fused launch kept no D²; build it
            d2 = self._d2_for(w)
        co_w = self._coefs.index_select(0, w["idx_d"])
        g = torch.as_tensor(np.asarray(gammas, np.float32).reshape(-1))
        return _sweep_cells(d2, g.to(self.device), co_w, self.bank.kernel)

    # ------------------------------------------------------------ high level
    def predict(self, x: np.ndarray) -> np.ndarray:
        """(m, d) -> (m, n_tasks, n_sub): submit + drain, original order."""
        ids = self.submit(x)
        results: Dict[int, np.ndarray] = {}
        while self.pending or self._inflight is not None:
            results.update(self.step())
        if ids.size == 0:
            return np.zeros((0, self.bank.n_tasks, self.bank.n_sub),
                            np.float32)
        return np.stack([results[int(i)] for i in ids])

    def predict_label(self, x: np.ndarray,
                      sub: Optional[int] = None) -> np.ndarray:
        """Scenario labels; ``sub=None`` reads the bank's default column
        (the select stage's NP weight pick for npsvm banks)."""
        if sub is None:
            sub = self.bank.default_sub
        return combine_decisions(self.predict(x), self.bank.scenario,
                                 classes=self.bank.classes,
                                 pairs=self.bank.pairs, sub=sub)

    def stats(self) -> dict:
        out = dict(self.counters)
        # robustness counters are always visible, even at zero
        for k in ("swaps", "swap_requeued", "bank_fallbacks",
                  "routing_degraded", "shed_overflow", "shed_stale",
                  "shed_rows", "breakdown_evicted"):
            out.setdefault(k, 0)
        out["bank_version"] = int(self.bank.version)
        out["pending"] = self.pending
        out["pending_requests"] = len(self._reqs)
        out["routing"] = "overlap" if self.overlap else "nearest"
        launched = out.get("launched_rows", 0)
        out["pad_fraction"] = (1.0 - out.get("served_rows", 0) / launched
                               if launched else 0.0)
        out["cached_d2_waves"] = len(self._d2_cache)
        out["cached_d2_bytes"] = int(sum(a.numel() * a.element_size()
                                         for a in self._d2_cache.values()))
        # wave aggregates come from running sums, NOT the ring window, so
        # they cover every wave ever launched (exact after the ring wraps)
        out["waves"] = self.wave_stats.total
        out["wave_stats_dropped"] = self.wave_stats.dropped
        if self.wave_stats.total:
            out["occupancy_mean"] = self._occ_sum / self.wave_stats.total
            out["age_ms_max"] = self._age_ms_max
            out["age_hist"] = list(self._age_hist_sum)
        out["per_stage"] = {
            s: {"total_ms": self._stage_ms[s],
                "mean_ms": (self._stage_ms[s] / self._stage_n[s]
                            if self._stage_n[s] else 0.0),
                "count": self._stage_n[s]}
            for s in _STAGES}
        # true request-latency quantiles from the sketch (exact below its
        # cap, analytic rank-error bound above; see obs.sketch)
        if self._m_request_q.count:
            out["request_ms_q"] = self._m_request_q.summary()
        return out
