"""Synthetic LM token pipeline with deterministic, step-indexed batches
(the JAX package's ``data/tokens.py``).

Fault-tolerance contract: ``batch(step)`` is a pure function of (seed,
step), so after a crash and restore the pipeline replays the same tokens
with no iterator state (a checkpoint stores only the step).

The generator is a hidden-Markov "language": a sticky random transition
matrix over a few states, each state emitting token ids from its own
sparse unigram mixture.  The tables (``_trans``, ``_emits``, ``_proj``)
come from ``numpy.random.default_rng(seed)`` exactly as in the reference,
so they are the reference's bit for bit.  The walk and the emissions draw
from a ``torch.Generator`` seeded by (seed, step): the same distribution
as the reference's ``jax.random`` draws, not the same tokens.  An
emission depends only on its state, so tokens are drawn state by state
(never as a (B, T, vocab) table of logits).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class TokenPipelineConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_states: int = 12
    input_kind: str = "tokens"   # tokens | embed
    d_frontend: int = 0


class TokenPipeline:
    def __init__(self, cfg: TokenPipelineConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        n = cfg.n_states
        trans = rng.dirichlet(0.3 * np.ones(n), size=n) + 4.0 * np.eye(n)
        self._trans = torch.from_numpy(
            (trans / trans.sum(1, keepdims=True)).astype(np.float32))
        emits = rng.dirichlet(0.05 * np.ones(cfg.vocab), size=n)
        self._emits = torch.from_numpy(
            np.log(emits + 1e-9).astype(np.float32))
        self._proj = None
        if cfg.input_kind == "embed":
            self._proj = torch.from_numpy(
                (rng.normal(0, 1, (cfg.vocab, cfg.d_frontend))
                 / np.sqrt(cfg.d_frontend)).astype(np.float32))

    def _generator(self, step: int) -> torch.Generator:
        seq = np.random.SeedSequence([self.cfg.seed, int(step)])
        seed = int(seq.generate_state(1, dtype=np.uint64)[0] >> np.uint64(1))
        return torch.Generator().manual_seed(seed)

    def batch(self, step: int) -> Dict[str, torch.Tensor]:
        """Deterministic CPU batch for ``step``: ``inputs`` (B, T) int32
        (or (B, T, d_frontend) f32), ``labels`` the inputs shifted left,
        ``mask`` 0 at the last position."""
        cfg = self.cfg
        gen = self._generator(step)
        b, t = cfg.global_batch, cfg.seq_len
        trans = self._trans + 1e-9          # the reference's log(p + 1e-9)
        state = torch.randint(0, cfg.n_states, (b,), generator=gen)
        states = torch.empty((b, t), dtype=torch.int64)
        for i in range(t):
            state = torch.multinomial(trans[state], 1, generator=gen)[:, 0]
            states[:, i] = state
        emit = torch.exp(self._emits)
        tokens = torch.empty((b, t), dtype=torch.int64)
        for s in range(cfg.n_states):
            where = states == s
            count = int(where.sum())
            if count:
                tokens[where] = torch.multinomial(emit[s], count,
                                                  replacement=True,
                                                  generator=gen)
        tokens = tokens.to(torch.int32)
        labels = torch.roll(tokens, -1, dims=1)
        mask = torch.ones((b, t), dtype=torch.float32)
        mask[:, -1] = 0.0
        inputs = self._proj[tokens.long()] if self._proj is not None \
            else tokens
        return {"inputs": inputs, "labels": labels, "mask": mask}
