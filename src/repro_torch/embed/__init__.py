"""repro_torch.embed — frozen-backbone embedding pipeline.

Connects the LM stack (``models/``, ``configs/``) to the SVM verticals: a
fixed-batch :class:`~repro_torch.embed.extractor.EmbeddingExtractor` pools
backbone hidden states into feature rows,
:class:`~repro_torch.embed.source.EmbeddingSource` exposes a token corpus
behind the ChunkSource contract (lazy, block-aligned for bitwise
chunk-size invariance, write-through
:class:`~repro_torch.embed.source.EmbedCache` with npz-shard replay), and
:func:`embed_source` is the one-call front door.
"""
from __future__ import annotations

import os
from typing import Union

import torch

from repro_torch.embed.extractor import (POOLINGS, EmbeddingExtractor,
                                         params_digest, resolve_arch)
from repro_torch.embed.source import (EmbedCache, EmbedCacheError,
                                      EmbeddingSource, LabeledSource,
                                      TokenArraySource)

__all__ = [
    "POOLINGS", "EmbeddingExtractor", "params_digest", "resolve_arch",
    "EmbedCache", "EmbedCacheError", "EmbeddingSource", "LabeledSource",
    "TokenArraySource", "embed_source",
]


def embed_source(tokens, *, arch: str, pooling: str = "mean",
                 cache_dir: Union[str, os.PathLike, None] = None,
                 batch_size: int = 32, params=None, seed: int = 0,
                 labels=None, device: Union[None, str, torch.device] = None,
                 tracer=None, metrics=None) -> EmbeddingSource:
    """Wrap a token corpus as a lazily-embedded ChunkSource.

    ``arch`` is ``"<arch-id>"`` or ``"<arch-id>:smoke"`` from
    ``repro_torch.configs.ARCH_IDS``; ``params=None`` uses the
    deterministic seed-initialised frozen backbone.  ``cache_dir`` is a
    multi-identity cache root — shards land under
    ``cache_dir/<fingerprint-prefix>/``.  ``labels=`` carries the y pairing
    through the token->embedding hop.  ``device=None`` embeds on the
    current card and raises without one.
    """
    cfg = resolve_arch(arch)
    extractor = EmbeddingExtractor(cfg, params, pooling=pooling,
                                   batch_size=batch_size, seed=seed,
                                   device=device, tracer=tracer,
                                   metrics=metrics)
    return EmbeddingSource(tokens, extractor, cache=cache_dir, labels=labels)
