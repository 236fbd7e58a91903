"""Lazy embedding sources: tokenized corpora behind the ChunkSource contract.

:class:`EmbeddingSource` embeds a token corpus chunk-by-chunk through an
:class:`repro_torch.embed.extractor.EmbeddingExtractor`, honoring the
``iter_chunks``/``gather`` contract of :mod:`repro_torch.pipeline.dataset`
— so ``Scaler.fit_stream``, ``build_cells_stream`` and wave training run
over tokenized corpora unchanged, and the full corpus embedding matrix
never has to exist in host memory.  The on-disk cache format is the JAX
package's.

**Bitwise invariance.**  The contract demands per-row results independent
of which chunk a row landed in.  The source computes embeddings ONLY in
blocks aligned to absolute corpus offsets (block ``j`` covers rows
``[j*B, (j+1)*B)``, ``B`` = the extractor's fixed batch size); both access
paths read through the same blocks, so row ``i``'s embedding is a pure
function of the corpus — never of the query that requested it.

**Write-through cache.**  ``EmbedCache`` persists computed blocks as npz
shards keyed by the extractor's (arch, params-digest, pooling, seq_len)
fingerprint, with crash-safe tmp+rename writes.  Once every shard exists
the source replays through
:class:`repro_torch.pipeline.dataset.ShardedNpzSource` — a second epoch is
I/O-bound, the backbone never runs again, and the replayed bits are
identical to the cold path (npz round-trips floats exactly).

**Label pairing.**  :class:`LabeledSource` pairs any x backend with a
streaming label backend (array / ``.npy`` memmap / npz shards);
``EmbeddingSource`` accepts the same ``labels=`` backend and preserves the
pairing across the token->embedding hop, so ``SVM(x, y=None)`` trains on
it directly.
"""
from __future__ import annotations

import json
import os
import tempfile
from collections import OrderedDict
from typing import Iterator, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.embed.extractor import EmbeddingExtractor
from repro_torch.pipeline.dataset import (DEFAULT_CHUNK, ChunkSource,
                                    DataSourceError, ShardedNpzSource,
                                    as_source)

_META = "meta.json"
_CACHE_FORMAT = "repro.embed.cache.v1"

# computed blocks memoized in memory (cold path); small: the contract's
# access patterns (sequential chunks, spatially local gathers) rarely
# touch more than adjacent blocks
_LRU_BLOCKS = 4


class EmbedCacheError(RuntimeError):
    """The cache directory exists but belongs to a different embedding
    identity (fingerprint mismatch) or is structurally invalid."""


def _atomic_write_bytes(path: str, data: bytes) -> None:
    """tmp + fsync + rename in the checkpoint idiom: readers only ever see
    complete files, a crash leaves at most a ``*.tmp.*`` straggler."""
    d = os.path.dirname(path)
    fd, tmp = tempfile.mkstemp(dir=d, prefix=os.path.basename(path) + ".tmp.")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    dfd = os.open(d, os.O_RDONLY)
    try:
        os.fsync(dfd)
    finally:
        os.close(dfd)


class EmbedCache:
    """Persistent block cache for one embedding identity.

    Layout: ``path/meta.json`` plus one ``shard_<j>.npz`` (member ``"x"``)
    per extractor block — shard boundaries ARE block boundaries, so a cache
    written under one fingerprint replays bit-identically regardless of the
    chunk sizes that populated it.  ``meta.json`` records the fingerprint
    and geometry; opening an existing directory under a different
    fingerprint raises :class:`EmbedCacheError` (mixing embeddings from two
    backbones is data corruption, not a cache miss).

    ``EmbedCache.at(root, ...)`` nests the cache under
    ``root/<fingerprint-prefix>/`` — the multi-identity layout the
    ``cache=<dir>`` argument of :class:`EmbeddingSource` points at.
    """

    def __init__(self, path: Union[str, os.PathLike], fingerprint: str,
                 n_rows: int, dim: int, block: int, seq_len: int,
                 extra: Optional[dict] = None):
        self.path = os.fspath(path)
        self.fingerprint = fingerprint
        self.n_rows = int(n_rows)
        self.dim = int(dim)
        self.block = int(block)
        self.n_blocks = -(-self.n_rows // self.block)
        os.makedirs(self.path, exist_ok=True)
        meta_path = os.path.join(self.path, _META)
        meta = {"format": _CACHE_FORMAT, "fingerprint": fingerprint,
                "n_rows": self.n_rows, "dim": self.dim, "block": self.block,
                "seq_len": int(seq_len), **(extra or {})}
        if os.path.exists(meta_path):
            try:
                with open(meta_path) as f:
                    have = json.load(f)
            except ValueError as e:
                raise EmbedCacheError(
                    f"{meta_path}: unreadable cache metadata ({e})") from e
            for k in ("format", "fingerprint", "n_rows", "dim", "block"):
                if have.get(k) != meta[k]:
                    raise EmbedCacheError(
                        f"{self.path}: cache belongs to a different "
                        f"embedding identity ({k}: {have.get(k)!r} != "
                        f"{meta[k]!r}) — delete the directory or point "
                        f"the cache elsewhere")
            self.meta = have
        else:
            _atomic_write_bytes(meta_path,
                                json.dumps(meta, indent=2).encode())
            self.meta = meta

    @classmethod
    def at(cls, root: Union[str, os.PathLike], fingerprint: str,
           **kw) -> "EmbedCache":
        """The ``root/<fp12>`` layout: one root, many identities."""
        return cls(os.path.join(os.fspath(root), fingerprint[:12]),
                   fingerprint, **kw)

    @classmethod
    def open(cls, path: Union[str, os.PathLike]) -> dict:
        """Read an existing cache's metadata (no validation beyond JSON
        and the format tag).  The CLI uses this to rebuild an extractor
        from a stage artifact."""
        meta_path = os.path.join(os.fspath(path), _META)
        if not os.path.exists(meta_path):
            raise EmbedCacheError(f"{path}: not an embed cache "
                                  f"(no {_META})")
        with open(meta_path) as f:
            meta = json.load(f)
        if meta.get("format") != _CACHE_FORMAT:
            raise EmbedCacheError(f"{path}: not an embed cache "
                                  f"(format={meta.get('format')!r})")
        return meta

    # ------------------------------------------------------------- blocks
    def _shard_path(self, j: int) -> str:
        return os.path.join(self.path, f"shard_{j:05d}.npz")

    def shard_paths(self) -> Tuple[str, ...]:
        return tuple(self._shard_path(j) for j in range(self.n_blocks))

    def has(self, j: int) -> bool:
        return os.path.exists(self._shard_path(j))

    def complete(self) -> bool:
        return all(self.has(j) for j in range(self.n_blocks))

    def put(self, j: int, emb: np.ndarray) -> None:
        """Write-through one block, crash-safe (tmp+rename): a reader never
        sees a torn shard, a crash mid-put leaves the block absent."""
        lo = j * self.block
        want = min(self.block, self.n_rows - lo)
        assert emb.shape == (want, self.dim), (emb.shape, want, self.dim)
        import io
        buf = io.BytesIO()
        np.savez(buf, x=np.ascontiguousarray(emb, np.float32))
        _atomic_write_bytes(self._shard_path(j), buf.getvalue())

    def get(self, j: int) -> Optional[np.ndarray]:
        p = self._shard_path(j)
        if not os.path.exists(p):
            return None
        lo = j * self.block
        want = min(self.block, self.n_rows - lo)
        try:
            with np.load(p) as z:
                emb = np.asarray(z["x"], np.float32)
        except Exception as e:     # torn/corrupt shard: recompute, don't die
            raise DataSourceError(
                f"{p}: corrupt embed-cache shard covering rows "
                f"[{lo}, {lo + want}) ({e}) — delete it to re-embed") from e
        if emb.shape != (want, self.dim):
            raise DataSourceError(
                f"{p}: embed-cache shard holds {emb.shape} but rows "
                f"[{lo}, {lo + want}) need ({want}, {self.dim})")
        return emb


# --------------------------------------------------------------- token side
class TokenArraySource:
    """Minimal token backend: an (n, seq_len[, d_frontend]) array or an
    on-disk ``.npy`` opened as a memmap.  Rows are sequences, not features —
    this is deliberately NOT a ChunkSource (no float32 coercion, no dim)."""

    def __init__(self, tokens):
        if isinstance(tokens, (str, os.PathLike)):
            try:
                tokens = np.load(os.fspath(tokens), mmap_mode="r")
            except (OSError, ValueError) as e:
                raise DataSourceError(
                    f"{os.fspath(tokens)}: cannot memmap token .npy ({e})"
                ) from e
        self._tok = tokens
        assert self._tok.ndim in (2, 3), self._tok.shape

    @property
    def n_rows(self) -> int:
        return self._tok.shape[0]

    @property
    def seq_len(self) -> int:
        return self._tok.shape[1]

    def rows(self, lo: int, hi: int) -> np.ndarray:
        return np.asarray(self._tok[lo:hi])


def _label_backend(y):
    """Coerce a label spec into a lazily-readable (n,) view.

    Accepts an array, a ``.npy`` path (memmapped) or a sequence of ``.npz``
    shard paths holding member ``"y"`` — mirroring what ``--data`` accepts
    for x, so labeled shard exports stream without a host copy.
    """
    if isinstance(y, (str, os.PathLike)):
        try:
            return np.load(os.fspath(y), mmap_mode="r")
        except (OSError, ValueError) as e:
            raise DataSourceError(
                f"{os.fspath(y)}: cannot memmap label .npy ({e})") from e
    if isinstance(y, (list, tuple)):
        return _ShardedLabels(y)
    return np.asarray(y)


class _ShardedLabels:
    """Ordered npz label shards (member ``"y"``), one resident at a time."""

    def __init__(self, paths: Sequence[Union[str, os.PathLike]]):
        src = ShardedNpzSource([os.fspath(p) for p in paths], key="y") \
            if _is_2d_label_shards(paths) else None
        self._paths = [os.fspath(p) for p in paths]
        self._src = src
        if src is None:
            # 1-D shards: track boundaries ourselves
            sizes = []
            for p in self._paths:
                with np.load(p) as z:
                    if "y" not in z:
                        raise DataSourceError(
                            f"{p}: npz shard has no member 'y'")
                    sizes.append(int(np.asarray(z["y"]).shape[0]))
            self._starts = np.concatenate(
                [[0], np.cumsum(sizes)]).astype(np.int64)
            self._cache: Optional[Tuple[int, np.ndarray]] = None

    @property
    def shape(self):
        if self._src is not None:
            return (self._src.n_rows,)
        return (int(self._starts[-1]),)

    def _load(self, i: int) -> np.ndarray:
        if self._cache is not None and self._cache[0] == i:
            return self._cache[1]
        with np.load(self._paths[i]) as z:
            y = np.asarray(z["y"]).reshape(-1)
        self._cache = (i, y)
        return y

    def __getitem__(self, idx):
        if self._src is not None:
            flat = self._src.gather(np.atleast_1d(
                np.arange(self._src.n_rows)[idx]))
            return flat[:, 0]
        if isinstance(idx, slice):
            ids = np.arange(*idx.indices(self.shape[0]), dtype=np.int64)
        else:
            ids = np.atleast_1d(np.asarray(idx, np.int64))
        out = np.empty(ids.shape[0], self._load(0).dtype
                       if self._paths else np.float32)
        shard_of = np.searchsorted(self._starts, ids, side="right") - 1
        for i in np.unique(shard_of):
            sel = shard_of == i
            out[sel] = self._load(int(i))[ids[sel] - self._starts[i]]
        return out


def _is_2d_label_shards(paths) -> bool:
    try:
        with np.load(os.fspath(paths[0])) as z:
            return "y" in z and np.asarray(z["y"]).ndim == 2
    except Exception:
        return False


class LabeledSource(ChunkSource):
    """An x ChunkSource paired with a streaming label backend.

    Delegates the full ChunkSource contract to ``x`` (anything
    ``as_source`` accepts) and adds the y side: ``gather_labels(ids)``
    mirrors ``gather``, ``iter_labeled_chunks`` yields aligned
    ``(start, x_chunk, y_chunk)`` triples, and ``labels_vector()``
    assembles the (n,) float32 label vector by streaming — O(n) scalars,
    never a caller-held host array per shard.  ``SVM(x, y=None)`` accepts
    any source exposing this API.
    """

    def __init__(self, x, y):
        self._x = as_source(x)
        self._y = _label_backend(y)
        n = self._y.shape[0]
        if n != self._x.n_rows:
            raise DataSourceError(
                f"labeled source row mismatch: {self._x.n_rows} x rows vs "
                f"{n} labels")

    @property
    def n_rows(self) -> int:
        return self._x.n_rows

    @property
    def dim(self) -> int:
        return self._x.dim

    def iter_chunks(self, chunk_size: int = DEFAULT_CHUNK):
        return self._x.iter_chunks(chunk_size)

    def gather(self, ids: np.ndarray) -> np.ndarray:
        return self._x.gather(ids)

    # ------------------------------------------------------------- labels
    def gather_labels(self, ids: np.ndarray) -> np.ndarray:
        ids = np.asarray(ids, np.int64)
        return np.asarray(self._y[ids], np.float32).reshape(-1)

    def iter_labeled_chunks(self, chunk_size: int = DEFAULT_CHUNK
                            ) -> Iterator[Tuple[int, np.ndarray, np.ndarray]]:
        for lo, chunk in self.iter_chunks(chunk_size):
            hi = lo + chunk.shape[0]
            yield lo, chunk, np.asarray(self._y[lo:hi],
                                        np.float32).reshape(-1)

    def labels_vector(self, chunk_size: int = DEFAULT_CHUNK) -> np.ndarray:
        """The (n,) label vector, assembled chunk-by-chunk (each label
        shard is resident once) — the one O(n)-scalar array wave training
        needs for task construction."""
        out = np.empty(self.n_rows, np.float32)
        for lo in range(0, self.n_rows, chunk_size):
            hi = min(lo + chunk_size, self.n_rows)
            out[lo:hi] = np.asarray(self._y[lo:hi], np.float32).reshape(-1)
        return out


# ---------------------------------------------------------- embedding source
class EmbeddingSource(ChunkSource):
    """Lazily-embedded token corpus behind the ChunkSource contract.

    ``tokens`` is an (n, seq_len) int array / ``.npy`` path (or
    ``(n, seq_len, d_frontend)`` floats for embed-frontend configs);
    ``extractor`` a fixed-batch :class:`EmbeddingExtractor`.  Embeddings
    are computed per block aligned to absolute corpus offsets (see module
    docstring), memoized in a small LRU, and written through ``cache``
    when given.  When the cache is (or becomes) complete, iteration and
    gathers replay through :class:`ShardedNpzSource` — I/O-bound, bitwise
    identical to the cold path.

    ``cache`` may be an :class:`EmbedCache`, a directory path (the cache is
    created there under the extractor's fingerprint, the multi-identity
    layout), or ``None``.  ``labels`` adds the :class:`LabeledSource` API
    on top, preserved across the token->embedding hop.
    """

    def __init__(self, tokens, extractor: EmbeddingExtractor,
                 cache: Union[EmbedCache, str, os.PathLike, None] = None,
                 labels=None):
        self._tok = tokens if isinstance(tokens, TokenArraySource) \
            else TokenArraySource(tokens)
        self.extractor = extractor
        b = extractor.batch_size
        if isinstance(cache, (str, os.PathLike)):
            cache = EmbedCache.at(
                cache, extractor.fingerprint(self._tok.seq_len),
                n_rows=self._tok.n_rows, dim=extractor.dim, block=b,
                seq_len=self._tok.seq_len)
        if cache is not None:
            if (cache.n_rows, cache.dim, cache.block) != \
                    (self._tok.n_rows, extractor.dim, b):
                raise EmbedCacheError(
                    f"{cache.path}: cache geometry "
                    f"({cache.n_rows}, {cache.dim}, block {cache.block}) "
                    f"does not match this corpus/extractor "
                    f"({self._tok.n_rows}, {extractor.dim}, block {b})")
            want_fp = extractor.fingerprint(self._tok.seq_len)
            if cache.fingerprint != want_fp:
                raise EmbedCacheError(
                    f"{cache.path}: cache fingerprint "
                    f"{cache.fingerprint[:12]} does not match this "
                    f"extractor ({want_fp[:12]})")
        self.cache = cache
        self._lru: "OrderedDict[int, np.ndarray]" = OrderedDict()
        self._replay: Optional[ShardedNpzSource] = None
        self._maybe_seal()

        self._y = None
        if labels is not None:
            self._y = _label_backend(labels)
            if self._y.shape[0] != self._tok.n_rows:
                raise DataSourceError(
                    f"labeled source row mismatch: {self._tok.n_rows} "
                    f"sequences vs {self._y.shape[0]} labels")

    # ------------------------------------------------------------ geometry
    @property
    def n_rows(self) -> int:
        return self._tok.n_rows

    @property
    def dim(self) -> int:
        return self.extractor.dim

    @property
    def block(self) -> int:
        return self.extractor.batch_size

    @property
    def n_blocks(self) -> int:
        return -(-self.n_rows // self.block)

    def cache_complete(self) -> bool:
        return self._replay is not None

    def _maybe_seal(self) -> None:
        """Flip to npz replay once every block shard exists — mid-run, so
        the second pass of one training job is already I/O-bound."""
        if self._replay is None and self.cache is not None \
                and self.cache.complete():
            self._replay = ShardedNpzSource(self.cache.shard_paths())

    # -------------------------------------------------------------- blocks
    def _block_arr(self, j: int) -> np.ndarray:
        hit = self._lru.get(j)
        if hit is not None:
            self._lru.move_to_end(j)
            return hit
        emb = self.cache.get(j) if self.cache is not None else None
        if emb is None:
            lo = j * self.block
            hi = min(lo + self.block, self.n_rows)
            emb = self.extractor(self._tok.rows(lo, hi))
            if self.cache is not None:
                self.cache.put(j, emb)
                self._maybe_seal()
        self._lru[j] = emb
        while len(self._lru) > _LRU_BLOCKS:
            self._lru.popitem(last=False)
        return emb

    def _rows(self, lo: int, hi: int) -> np.ndarray:
        """Rows [lo, hi) assembled from aligned blocks."""
        b = self.block
        pieces = []
        for j in range(lo // b, (hi - 1) // b + 1):
            blk = self._block_arr(j)
            s = max(lo - j * b, 0)
            e = min(hi - j * b, blk.shape[0])
            pieces.append(blk[s:e])
        return pieces[0] if len(pieces) == 1 else np.concatenate(pieces)

    # ------------------------------------------------------------ contract
    def iter_chunks(self, chunk_size: int = DEFAULT_CHUNK):
        if self._replay is not None:
            yield from self._replay.iter_chunks(chunk_size)
            return
        for lo in range(0, self.n_rows, chunk_size):
            hi = min(lo + chunk_size, self.n_rows)
            yield lo, self._rows(lo, hi)
            if self._replay is not None:     # sealed mid-pass: finish hot
                yield from self._replay_from(hi, chunk_size)
                return

    def _replay_from(self, start: int, chunk_size: int):
        for lo in range(start, self.n_rows, chunk_size):
            ids = np.arange(lo, min(lo + chunk_size, self.n_rows),
                            dtype=np.int64)
            yield lo, self._replay.gather(ids)

    def gather(self, ids: np.ndarray) -> np.ndarray:
        ids = np.asarray(ids, np.int64)
        if self._replay is not None:
            return self._replay.gather(ids)
        out = np.empty((ids.shape[0], self.dim), np.float32)
        block_of = ids // self.block
        for j in np.unique(block_of):
            sel = block_of == j
            out[sel] = self._block_arr(int(j))[ids[sel] - j * self.block]
        return out

    # -------------------------------------------------------------- labels
    def gather_labels(self, ids: np.ndarray) -> np.ndarray:
        self._need_labels()
        ids = np.asarray(ids, np.int64)
        return np.asarray(self._y[ids], np.float32).reshape(-1)

    def iter_labeled_chunks(self, chunk_size: int = DEFAULT_CHUNK):
        self._need_labels()
        for lo, chunk in self.iter_chunks(chunk_size):
            hi = lo + chunk.shape[0]
            yield lo, chunk, np.asarray(self._y[lo:hi],
                                        np.float32).reshape(-1)

    def labels_vector(self, chunk_size: int = DEFAULT_CHUNK) -> np.ndarray:
        self._need_labels()
        out = np.empty(self.n_rows, np.float32)
        for lo in range(0, self.n_rows, chunk_size):
            hi = min(lo + chunk_size, self.n_rows)
            out[lo:hi] = np.asarray(self._y[lo:hi], np.float32).reshape(-1)
        return out

    def _need_labels(self) -> None:
        if self._y is None:
            raise DataSourceError(
                "this EmbeddingSource carries no labels — construct it "
                "with labels=... to use the LabeledSource API")
