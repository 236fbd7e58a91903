"""Frozen-backbone sequence embedding at one fixed batch shape.

The extractor turns token sequences (or, for an embed front end, frame
features ``(m, T, d_frontend)``) into fixed-dimension feature rows for
the SVM verticals: ``models.model.backbone`` runs frozen (on the card, or
on the CPU when asked), the final hidden states are pooled (mean over
time, or the last position) in f32, and the result is an ``(m, d_model)``
float32 host array ready for cells, scaling and serving.

  * **fixed batch shape** — rows are processed in blocks of
    ``batch_size``; a ragged tail is zero-padded on the ROW axis, computed,
    and sliced off, so every launch of a block has one shape.  Padded rows
    never leave the extractor, and a real row's embedding does not depend
    on what else is in its block (the backbone is row-independent and a
    block's shapes, hence its kernels and their sum orders, never change);
  * **determinism by construction** — for one input block the computation
    is a pure function of ``(config, params, tokens)``;
    :class:`repro_torch.embed.source.EmbeddingSource` aligns its compute
    blocks to absolute corpus offsets so a row always lands in the same
    block.

The JAX package compiles the forward once per shape and counts the
compiles; the port runs eagerly and has no such counter.  Instrumented
with ``embed.forward`` / ``embed.pool`` tracer spans (CUDA events on the
card) and an ``embed.sequences`` counter.
"""
from __future__ import annotations

import hashlib
from typing import Optional, Union

import numpy as np
import torch

from repro_torch import obs
from repro_torch.kernels import runtime
from repro_torch.models import model as model_mod
from repro_torch.models.layers import tree_items, tree_map
from repro_torch.models.model import ModelConfig

POOLINGS = ("mean", "last")


def resolve_arch(arch: str) -> ModelConfig:
    """``"<arch-id>"`` -> full config, ``"<arch-id>:smoke"`` -> smoke config."""
    from repro_torch.configs import get_arch
    name, _, variant = arch.partition(":")
    spec = get_arch(name)
    if variant in ("", "full"):
        return spec.config
    if variant == "smoke":
        return spec.smoke
    raise ValueError(f"unknown arch variant {variant!r} in {arch!r} "
                     f"(use '<id>' or '<id>:smoke')")


def _keystr(path) -> str:
    """The JAX package's key path string of a nested-dict leaf."""
    return "".join(f"[{k!r}]" for k in path)


def _leaf_bytes(t: torch.Tensor) -> bytes:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().tobytes()


def params_digest(params) -> str:
    """Content hash of a parameter tree: blake2b over sorted (path, bytes)
    leaves, with the JAX package's key path strings and raw leaf bytes, so
    the same parameters give the same digest in both packages."""
    items = sorted(((_keystr(path), leaf) for path, leaf in tree_items(params)),
                   key=lambda item: item[0])
    h = hashlib.blake2b(digest_size=16)
    for path, leaf in items:
        h.update(path.encode())
        h.update(_leaf_bytes(leaf))
    return h.hexdigest()


class EmbeddingExtractor:
    """Pooled backbone embeddings at one fixed ``(batch_size, seq_len)``.

    ``__call__(tokens)`` accepts ``(m, seq_len)`` int tokens (or ``(m,
    seq_len, d_frontend)`` float frames for ``input_kind="embed"``) for
    ANY ``m`` and returns ``(m, d_model)`` float32.  ``params=None`` initialises a
    deterministic frozen backbone from ``seed`` with a ``torch.Generator``
    on the device (the random-features regime); given parameters are used
    as they are (moved to the device).  ``device=None`` runs on the current
    card and raises without one; ``device="cpu"`` runs the plain path.
    """

    def __init__(self, cfg: ModelConfig, params=None, *,
                 pooling: str = "mean", batch_size: int = 32, seed: int = 0,
                 device: Union[None, str, torch.device] = None,
                 tracer: Optional["obs.Tracer"] = None,
                 metrics: Optional["obs.MetricsRegistry"] = None):
        if pooling not in POOLINGS:
            raise ValueError(f"pooling must be one of {POOLINGS}, "
                             f"got {pooling!r}")
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        self.cfg = cfg
        self.pooling = pooling
        self.batch_size = int(batch_size)
        self.seed = int(seed)
        self.device = runtime.resolve_device(device)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(self.seed)
            params = model_mod.init_params(cfg, gen)
        else:
            params = tree_map(lambda t: t.to(self.device), params)
        self.params = params
        self._digest: Optional[str] = None
        self._tracer = obs.tracer if tracer is None else tracer
        self._metrics = obs.metrics if metrics is None else metrics
        self._m_sequences = self._metrics.counter("embed.sequences")
        self._span_dev = self.device if self.device.type == "cuda" else None

    # ----------------------------------------------------------- identity
    @property
    def dim(self) -> int:
        return self.cfg.d_model

    def digest(self) -> str:
        """Cached content hash of the frozen parameters."""
        if self._digest is None:
            self._digest = params_digest(self.params)
        return self._digest

    def fingerprint(self, seq_len: int) -> str:
        """Cache identity of embeddings this extractor produces over
        ``seq_len``-token sequences: (arch config, params digest, pooling,
        seq_len).  Batch size does NOT participate — block-aligned callers
        pin it separately (see ``EmbedCache``)."""
        h = hashlib.blake2b(digest_size=16)
        h.update(repr(self.cfg).encode())
        h.update(self.digest().encode())
        h.update(self.pooling.encode())
        h.update(np.int64(seq_len).tobytes())
        return h.hexdigest()

    # ------------------------------------------------------------ forward
    @torch.no_grad()
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Hidden states (B, T, d) of a (B, T) token block (or (B, T,
        d_frontend) frame block) on the device."""
        b, t = x.shape[0], x.shape[1]
        positions = torch.arange(t, dtype=torch.int32,
                                 device=x.device)[None].expand(b, t)
        h, _, _ = model_mod.backbone(self.cfg, self.params, x, positions)
        return h

    def pool(self, h: torch.Tensor) -> torch.Tensor:
        h32 = h.float()
        if self.pooling == "mean":
            return torch.mean(h32, dim=1)
        return h32[:, -1]

    def _block(self, x: np.ndarray) -> np.ndarray:
        """One fixed-shape block: pad rows to ``batch_size``, run, slice."""
        m = x.shape[0]
        b = self.batch_size
        if m < b:
            x = np.concatenate([x, np.zeros((b - m,) + x.shape[1:], x.dtype)])
        xd = torch.from_numpy(x).to(self.device)
        with self._tracer.span("embed.forward", device=self._span_dev):
            h = self.forward(xd)
        with self._tracer.span("embed.pool", device=self._span_dev):
            emb = self.pool(h).cpu().numpy()
        return emb[:m]

    def __call__(self, tokens) -> np.ndarray:
        """(m, seq_len[, d_frontend]) -> (m, d_model) f32, any ``m``."""
        if self.cfg.input_kind == "tokens":
            x = np.asarray(tokens).astype(np.int64, copy=False)
            if x.ndim != 2:
                raise ValueError(f"tokens must be (m, seq_len), got "
                                 f"{x.shape}")
        else:
            x = np.asarray(tokens).astype(np.float32, copy=False)
            if x.ndim != 3 or x.shape[2] != self.cfg.d_frontend:
                raise ValueError(f"frames must be (m, seq_len, "
                                 f"{self.cfg.d_frontend}), got {x.shape}")
        if x.shape[0] == 0:
            return np.zeros((0, self.dim), np.float32)
        out = np.concatenate(
            [self._block(x[lo:lo + self.batch_size])
             for lo in range(0, x.shape[0], self.batch_size)])
        self._m_sequences.inc(x.shape[0])
        return np.ascontiguousarray(out, np.float32)
