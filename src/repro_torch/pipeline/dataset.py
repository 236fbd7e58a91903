"""Chunked dataset sources: the in-memory half of the JAX package's
``pipeline.dataset`` contract.

A :class:`ChunkSource` yields ``(start, chunk)`` from ``iter_chunks`` with
``chunk`` a float32 ``(rows, d)`` array, rows in dataset order, covering
every row exactly once.  Chunks never exceed ``chunk_size`` rows but MAY
be shorter, so per-row results must never depend on which chunk a row
landed in.  ``gather(ids)`` returns the rows of ``ids`` in the given order.

Here: the in-memory source, the lazy scaled view (``ScaledSource``) and
the one-pass mean/std (``streaming_mean_std``), numpy as in the reference.
The file-backed sources (memmap, sharded npz) wait for the staged API.
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

    def gather(self, ids: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n_rows, self.dim)

    def materialize(self) -> np.ndarray:
        """Full (n, d) f32 array, O(n) memory."""
        return self.gather(np.arange(self.n_rows, dtype=np.int64))


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

    def gather(self, ids: np.ndarray) -> np.ndarray:
        return self._x[np.asarray(ids, np.int64)]


class ScaledSource(ChunkSource):
    """Lazy ``(x - mean) / std`` view: train-scaled features on the fly."""

    def __init__(self, base: ChunkSource, mean: np.ndarray, std: np.ndarray):
        self._base = base
        self._mean = np.asarray(mean, np.float32)
        self._std = np.asarray(std, np.float32)

    @property
    def n_rows(self) -> int:
        return self._base.n_rows

    @property
    def dim(self) -> int:
        return self._base.dim

    def _apply(self, x: np.ndarray) -> np.ndarray:
        return ((x - self._mean) / self._std).astype(np.float32)

    def iter_chunks(self, chunk_size: int = DEFAULT_CHUNK):
        for lo, chunk in self._base.iter_chunks(chunk_size):
            yield lo, self._apply(chunk)

    def gather(self, ids: np.ndarray) -> np.ndarray:
        return self._apply(self._base.gather(ids))


def streaming_mean_std(source: ChunkSource, chunk_size: int = DEFAULT_CHUNK
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """One-pass per-feature mean/std (f64 accumulators), O(chunk) memory."""
    d = source.dim
    s = np.zeros(d, np.float64)
    ss = np.zeros(d, np.float64)
    n = 0
    for _, chunk in source.iter_chunks(chunk_size):
        c64 = chunk.astype(np.float64)
        s += c64.sum(0)
        ss += (c64 * c64).sum(0)
        n += chunk.shape[0]
    if n == 0:
        raise ValueError("streaming_mean_std: empty source")
    mean = s / n
    var = np.maximum(ss / n - mean * mean, 0.0)
    return mean.astype(np.float32), np.sqrt(var).astype(np.float32)


def as_source(x) -> ChunkSource:
    """Coerce an ndarray or a source into a ChunkSource."""
    if isinstance(x, ChunkSource):
        return x
    if isinstance(x, np.ndarray):
        return ArraySource(x)
    raise TypeError(f"cannot make a ChunkSource from {type(x)!r}")
