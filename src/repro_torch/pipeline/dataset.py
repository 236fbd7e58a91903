"""Chunked dataset sources: the in-memory half of the JAX package's
``pipeline.dataset`` contract.

A :class:`ChunkSource` yields ``(start, chunk)`` from ``iter_chunks`` with
``chunk`` a float32 ``(rows, d)`` array, rows in dataset order, covering
every row exactly once.  Chunks never exceed ``chunk_size`` rows but MAY
be shorter, so per-row results must never depend on which chunk a row
landed in.  ``gather(ids)`` returns the rows of ``ids`` in the given order.

Here: the in-memory source, the on-disk ``.npy`` source
(``MemmapSource``, which the device half of cell construction streams at
Covertype's full size), the sharded npz source (``ShardedNpzSource``,
which the embedding cache replays through), the lazy scaled view
(``ScaledSource``) and the one-pass mean/std (``streaming_mean_std``),
numpy as in the reference.
File-backed sources raise :class:`DataSourceError`, naming the file and
the affected row range, when the bytes on disk are truncated or corrupt.
"""
from __future__ import annotations

import os
import zipfile
import zlib
from typing import Iterator, Optional, Sequence, Tuple, Union

import numpy as np

DEFAULT_CHUNK = 65536


class DataSourceError(RuntimeError):
    """A file-backed source is unreadable: truncated/corrupt shard or
    header.  The message names the offending file and row range."""


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


class MemmapSource(ChunkSource):
    """An on-disk ``.npy`` file read through ``np.load(mmap_mode="r")``.

    Chunks are materialized (and cast to f32) one at a time; the full
    array never enters host memory.  ``np.lib.format.open_memmap`` is the
    matching writer.
    """

    def __init__(self, path: Union[str, os.PathLike]):
        self._path = os.fspath(path)
        try:
            self._mm = np.load(self._path, mmap_mode="r")
        except (OSError, ValueError) as e:
            # ValueError covers a torn/garbled .npy header; OSError a
            # missing/unreadable file or a body shorter than the header
            # promises (mmap of the full extent fails up front)
            raise DataSourceError(
                f"{self._path}: cannot memmap .npy ({e}) — "
                f"truncated or corrupt file?") from e
        assert self._mm.ndim == 2, self._mm.shape

    @property
    def n_rows(self) -> int:
        return self._mm.shape[0]

    @property
    def dim(self) -> int:
        return self._mm.shape[1]

    def iter_chunks(self, chunk_size: int = DEFAULT_CHUNK):
        for lo in range(0, self.n_rows, chunk_size):
            yield lo, np.asarray(self._mm[lo:lo + chunk_size], np.float32)

    def gather(self, ids: np.ndarray) -> np.ndarray:
        return np.asarray(self._mm[np.asarray(ids, np.int64)], np.float32)


def _npz_member_shape(path: str, key: str):
    """Read one member's shape from an npz WITHOUT its payload."""
    try:
        with zipfile.ZipFile(path) as zf, zf.open(key + ".npy") as f:
            version = np.lib.format.read_magic(f)
            if version == (1, 0):
                shape, _, _ = np.lib.format.read_array_header_1_0(f)
            else:
                shape, _, _ = np.lib.format.read_array_header_2_0(f)
    except KeyError as e:
        raise DataSourceError(
            f"{path}: npz shard has no member {key!r} ({e})") from e
    except (zipfile.BadZipFile, OSError, ValueError) as e:
        raise DataSourceError(
            f"{path}: unreadable npz shard header ({e}) — "
            f"truncated or corrupt file?") from e
    return shape


class ShardedNpzSource(ChunkSource):
    """An ordered sequence of ``.npz`` shards, each holding ``key`` (n_i, d).

    Row order is shard order; only headers are touched at construction, and
    at most one decompressed shard is resident during iteration/gather.
    """

    def __init__(self, paths: Sequence[Union[str, os.PathLike]],
                 key: str = "x"):
        if not paths:
            raise ValueError("ShardedNpzSource needs at least one shard")
        self._paths = [os.fspath(p) for p in paths]
        self._key = key
        shapes = [_npz_member_shape(p, key) for p in self._paths]
        if any(len(s) != 2 for s in shapes):
            raise DataSourceError(f"npz shards must hold 2-D {key!r}: "
                                  f"{shapes}")
        dims = {s[1] for s in shapes}
        if len(dims) != 1:
            raise DataSourceError(f"shards disagree on dim: {sorted(dims)}")
        self._dim = int(dims.pop())
        self._starts = np.concatenate(
            [[0], np.cumsum([s[0] for s in shapes])]).astype(np.int64)
        self._cache: Optional[Tuple[int, np.ndarray]] = None  # last shard

    @property
    def n_rows(self) -> int:
        return int(self._starts[-1])

    @property
    def dim(self) -> int:
        return self._dim

    def _load(self, i: int) -> np.ndarray:
        if self._cache is not None and self._cache[0] == i:
            return self._cache[1]
        lo, hi = int(self._starts[i]), int(self._starts[i + 1])
        try:
            with np.load(self._paths[i]) as z:
                shard = np.asarray(z[self._key], np.float32)
        except KeyError as e:
            raise DataSourceError(
                f"{self._paths[i]}: npz shard has no member "
                f"{self._key!r} ({e})") from e
        except (zipfile.BadZipFile, zlib.error, OSError, ValueError) as e:
            raise DataSourceError(
                f"{self._paths[i]}: corrupt npz shard covering rows "
                f"[{lo}, {hi}) ({e})") from e
        if shard.shape[0] != hi - lo:
            raise DataSourceError(
                f"{self._paths[i]}: shard payload holds {shard.shape[0]} "
                f"rows but its header promised {hi - lo} "
                f"(rows [{lo}, {hi}))")
        self._cache = (i, shard)
        return shard

    def iter_chunks(self, chunk_size: int = DEFAULT_CHUNK):
        for i in range(len(self._paths)):
            shard = self._load(i)
            base = int(self._starts[i])
            for lo in range(0, shard.shape[0], chunk_size):
                yield base + lo, shard[lo:lo + chunk_size]

    def gather(self, ids: np.ndarray) -> np.ndarray:
        ids = np.asarray(ids, np.int64)
        out = np.empty((ids.shape[0], self._dim), np.float32)
        shard_of = np.searchsorted(self._starts, ids, side="right") - 1
        for i in np.unique(shard_of):
            sel = shard_of == i
            out[sel] = self._load(int(i))[ids[sel] - self._starts[i]]
        return out


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
