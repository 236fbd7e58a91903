"""Co-located embed->route->blend serving.

:class:`EmbedServe` wraps an :class:`~repro_torch.serve.svm_engine.SVMEngine`
with a frozen-backbone :class:`~repro_torch.embed.extractor.EmbeddingExtractor`
in the SAME process: ``submit_tokens()`` runs the backbone forward and
feeds the pooled embeddings straight into the engine's admission queue —
no serialization hop, no second service, and the engine's cell routing
operates in embedding space (a monitor attached to the engine sees
embedding-space routing distances).

Accounting: the per-request breakdown grows an ``embed_ms`` stage.  The
embed stage ends at the exact timestamp passed to ``engine.submit(now=)``
as the admission time, so the engine's own invariant
(``queue + pack + dispatch + device + collect == engine total``) extends
to ``embed + queue + ... + collect == total_ms`` with no gap and no
double-counting between the stages.
"""
from __future__ import annotations

import collections
from typing import Dict, Iterable, Optional

import numpy as np

from repro_torch import obs
from repro_torch.embed.extractor import EmbeddingExtractor
from repro_torch.serve.svm_engine import (_SERVED_VERSION_CAP, OverloadError,
                                          SVMEngine)

_EMBED_STAGE = "embed"


class EmbedServe:
    """An ``SVMEngine`` fronted by an in-process embedding stage.

    Token-space requests enter via :meth:`submit_tokens`; feature-space
    requests may still use :meth:`submit` (their ``embed_ms`` is 0.0).
    Everything else — stepping, hot swap, overload shedding, monitor
    attachment — delegates to the wrapped engine, so serving tooling
    written for the engine works unchanged.
    """

    def __init__(self, engine: SVMEngine, extractor: EmbeddingExtractor,
                 *, tracer: Optional["obs.Tracer"] = None):
        bank_d = int(engine.bank.centers.shape[1])
        if extractor.dim != bank_d:
            raise ValueError(
                f"extractor produces d={extractor.dim} embeddings but the "
                f"bank was trained at d={bank_d}")
        self.engine = engine
        self.extractor = extractor
        self._tracer = obs.tracer if tracer is None else tracer
        # rid -> embed-stage latency, bounded exactly like the engine's
        # served_breakdown ring so the two age out together
        self._embed_ms: "collections.OrderedDict[int, float]" = \
            collections.OrderedDict()
        self._embed_ms_sum = 0.0
        self._embed_n = 0

    # ------------------------------------------------------------ admission
    def submit_tokens(self, tokens, now: Optional[float] = None
                      ) -> np.ndarray:
        """Embed a batch of token sequences (frames ``(m, T, d_frontend)``
        for an embed front end) and enqueue the embeddings.

        The backbone forward + pooling run here, in-process; the resulting
        rows land in the engine's admission queue with the embed-end
        timestamp as their admission time, so the engine's queue-residual
        accounting starts exactly where the embed stage stops.  Returns
        the engine-assigned request ids.  Overload shedding happens at the
        ENGINE's admission gate — a shed batch still paid for its
        embedding (the forward ran), which is the honest cost model for a
        co-located stage.
        """
        t0 = float(self.engine._clock()) if now is None else float(now)
        with self._tracer.span("serve.embed"):
            emb = self.extractor(tokens)
        t1 = float(self.engine._clock())
        ids = self.engine.submit(emb, now=t1)
        embed_ms = (t1 - t0) * 1e3
        per_req = embed_ms / max(len(ids), 1)
        for rid in ids:
            self._embed_ms[int(rid)] = per_req
        while len(self._embed_ms) > _SERVED_VERSION_CAP:
            self._embed_ms.popitem(last=False)
        self._embed_ms_sum += embed_ms
        self._embed_n += 1
        return ids

    def submit(self, x: np.ndarray, now: Optional[float] = None
               ) -> np.ndarray:
        """Feature-space admission passthrough (``embed_ms`` = 0)."""
        return self.engine.submit(x, now=now)

    # ----------------------------------------------------------- accounting
    def breakdown(self, rid: int) -> Optional[dict]:
        """Engine breakdown plus the ``embed_ms`` stage; ``total_ms`` is
        the end-to-end figure (embed + queue + pack + dispatch + device +
        collect — the stages sum to it exactly, inheriting the engine's
        own exactness guarantee)."""
        b = self.engine.breakdown(rid)
        if b is None:
            return None
        embed_ms = self._embed_ms.get(int(rid), 0.0)
        out = dict(b)
        out["embed_ms"] = embed_ms
        out["total_ms"] = b["total_ms"] + embed_ms
        return out

    def stats(self) -> dict:
        """Engine stats with the embed stage merged into ``per_stage``."""
        out = self.engine.stats()
        per_stage = dict(out["per_stage"])
        per_stage[_EMBED_STAGE] = {
            "total_ms": self._embed_ms_sum,
            "mean_ms": (self._embed_ms_sum / self._embed_n
                        if self._embed_n else 0.0),
            "count": self._embed_n,
        }
        out["per_stage"] = per_stage
        out["embedded_batches"] = self._embed_n
        return out

    # ------------------------------------------------------------ lifecycle
    def run_tokens(self, traffic: Iterable[Optional[np.ndarray]],
                   deadline_ms: Optional[float] = None,
                   max_queue: Optional[int] = None
                   ) -> Dict[int, np.ndarray]:
        """Latency-bounded serving over a token-batch arrival stream —
        the token-space mirror of :meth:`SVMEngine.run` (same launch
        policy, same overlap of admission with device work, same shedding
        semantics; ``None``/empty batches are idle ticks)."""
        eng = self.engine
        results: Dict[int, np.ndarray] = {}
        prev_mq = eng.max_queue
        if max_queue is not None:
            eng.max_queue = int(max_queue)
        try:
            for batch in traffic:
                if batch is not None and np.size(batch):
                    try:
                        self.submit_tokens(batch)
                    except OverloadError:
                        pass         # shed; visible in engine shed_* stats
                if eng.should_launch(deadline_ms):
                    if eng._inflight is not None:
                        results.update(eng.finish_step())
                    eng.begin_step()
            if eng._inflight is not None:
                results.update(eng.finish_step())
            while eng.pending:
                results.update(eng.step())
        finally:
            eng.max_queue = prev_mq
        return results

    def predict_tokens(self, tokens) -> np.ndarray:
        """Synchronous convenience: embed (tokens or frames) +
        engine.predict."""
        return self.engine.predict(self.extractor(tokens))

    def predict_label_tokens(self, tokens, **kw) -> np.ndarray:
        return self.engine.predict_label(self.extractor(tokens), **kw)

    # ------------------------------------------------------------ delegates
    def attach_monitor(self, monitor) -> None:
        """Drift scores now watch embedding-space routing distances —
        the engine routes what the extractor produced."""
        self.engine.attach_monitor(monitor)

    def swap_bank(self, new_bank, **kw) -> dict:
        return self.engine.swap_bank(new_bank, **kw)

    def step(self):
        return self.engine.step()

    def begin_step(self):
        return self.engine.begin_step()

    def finish_step(self):
        return self.engine.finish_step()

    def should_launch(self, deadline_ms: Optional[float] = None,
                      now: Optional[float] = None) -> bool:
        return self.engine.should_launch(deadline_ms, now)

    @property
    def pending(self) -> int:
        return self.engine.pending

    @property
    def bank(self):
        return self.engine.bank

    @property
    def counters(self):
        return self.engine.counters
