"""Chunked dataset sources: the in-memory half of the JAX package's
``pipeline.dataset`` contract.

A :class:`ChunkSource` yields ``(start, chunk)`` from ``iter_chunks`` with
``chunk`` a float32 ``(rows, d)`` array, rows in dataset order, covering
every row exactly once.  Chunks never exceed ``chunk_size`` rows but MAY
be shorter, so per-row results must never depend on which chunk a row
landed in.  Only the in-memory source and the part of the contract the
serving router uses are here; ``gather`` and the file-backed sources
(memmap, sharded npz) come with the cell-building slice.
"""
from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np

DEFAULT_CHUNK = 65536


class ChunkSource:
    """Abstract chunked view of an (n, d) float dataset."""

    @property
    def n_rows(self) -> int:
        raise NotImplementedError

    @property
    def dim(self) -> int:
        raise NotImplementedError

    def iter_chunks(self, chunk_size: int = DEFAULT_CHUNK
                    ) -> Iterator[Tuple[int, np.ndarray]]:
        raise NotImplementedError


class ArraySource(ChunkSource):
    """In-memory ndarray behind the chunk contract."""

    def __init__(self, x: np.ndarray):
        x = np.asarray(x)
        if x.ndim != 2:
            raise ValueError(f"ArraySource needs a 2-D array, got {x.shape}")
        self._x = np.ascontiguousarray(x, np.float32)

    @property
    def n_rows(self) -> int:
        return self._x.shape[0]

    @property
    def dim(self) -> int:
        return self._x.shape[1]

    def iter_chunks(self, chunk_size: int = DEFAULT_CHUNK):
        for lo in range(0, self.n_rows, chunk_size):
            yield lo, self._x[lo:lo + chunk_size]


def as_source(x) -> ChunkSource:
    """Coerce an ndarray or a source into a ChunkSource."""
    if isinstance(x, ChunkSource):
        return x
    if isinstance(x, np.ndarray):
        return ArraySource(x)
    raise TypeError(f"cannot make a ChunkSource from {type(x)!r}")
