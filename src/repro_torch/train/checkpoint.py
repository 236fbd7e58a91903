"""Checkpoints: atomic, checksummed step directories (the JAX package's
``train/checkpoint.py``, in its on-disk format).

A checkpoint is ``<dir>/step_<n>/`` holding ``shard_0.npz`` (one raw-byte
``uint8`` leaf per array) and ``manifest.json`` (version 2: step, leaf
paths, shapes, dtype names, per-leaf blake2b checksums, ``extra``).  The
format is the reference's byte for byte, so either package restores the
other's checkpoints with no converter:

  * leaf paths are the strings ``jax.tree_util.tree_flatten_with_path``
    gives: dict keys sorted and written ``['name']``, named-tuple fields
    ``.name``, other sequence items ``[i]``, nested levels joined by
    ``/`` (so ``(params, OptState)`` gives ``[1]/.master/['w']``);
  * bf16 leaves (``torch.bfloat16`` tensors, or ``bfloat16`` numpy arrays
    where ``ml_dtypes`` is installed) are written as their raw 2-byte words
    under the dtype name ``"bfloat16"``, and restored as CPU
    ``torch.bfloat16`` tensors without ``ml_dtypes``;
  * restored leaves take the dtypes the reference's 32-bit restore gives
    them (64-bit integers and floats narrow to 32 bits).

Crash safety as in the reference: the shard and manifest land in a tmp
dir, are fsync'd and become visible in one ``rename``; the ``latest``
pointer is advisory; ``latest_step`` skips torn step dirs; restores verify
sizes and checksums and fall back to the newest older step that passes
(:class:`CheckpointCorruptError` when none does).  The fault sites
(``repro_torch.testing.faults``) bracket every durable transition of the
save path.  One process writes one shard (``shard_0.npz``).

Sharded trees: a tree with DTensor leaves is saved by every rank of its
mesh together: each leaf in turn is gathered whole (``full_tensor``) on
every rank, global rank 0 moves it to host memory and the others drop it
(a device holds one whole leaf at most), rank 0 writes the file, and the
ranks meet at a barrier, so the bytes are those of an unsharded
checkpoint of the same values.  A
restore into DTensor targets reads the full arrays on every rank and
splits each per its target's placements: a checkpoint written under one
mesh restores under another (the elastic re-shard), or into a plain
tree.
"""
from __future__ import annotations

import concurrent.futures
import hashlib
import json
import os
import shutil
import tempfile
import time
import zipfile
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.launch.mesh import is_dtensor
from repro_torch.testing import faults

PyTree = Any

MANIFEST_VERSION = 2        # v2 adds per-leaf checksums; v1 restores fine
_HOST = 0                   # this process's shard index (one process)
# threads hashing leaves: a 23 GB LM training checkpoint hashed in one
# thread took ~40 s of a ~100 s save on the H100's host (8 cores)
_HASH_THREADS = min(8, os.cpu_count() or 1)

# step dirs currently being restored (abspaths): _gc must not delete them
_RESTORING: set = set()

# (ckpt_dir, skipped step) pairs recorded when a restore fell back past a
# torn/corrupt step
_FALLBACK_LOG: List[Tuple[str, int]] = []

# the dtypes a restore under the reference's 32-bit mode gives a leaf
_NARROW = {np.dtype(np.int64): np.dtype(np.int32),
           np.dtype(np.uint64): np.dtype(np.uint32),
           np.dtype(np.float64): np.dtype(np.float32),
           np.dtype(np.complex128): np.dtype(np.complex64)}


class CheckpointCorruptError(RuntimeError):
    """A step dir failed verification (torn write, checksum mismatch)."""


def fallback_log() -> List[Tuple[str, int]]:
    """Steps skipped as corrupt by restore fallbacks since process start."""
    return list(_FALLBACK_LOG)


def _note_fallback(ckpt_dir: str, skipped: List[int]) -> None:
    _FALLBACK_LOG.extend((ckpt_dir, int(s)) for s in skipped)
    obs.metrics.counter("checkpoint.fallback_steps").inc(len(skipped))


# ------------------------------------------------------------ tree paths
def _is_namedtuple(tree: PyTree) -> bool:
    return isinstance(tree, tuple) and hasattr(tree, "_fields")


def _flatten(tree: PyTree, prefix: Tuple[str, ...] = ()):
    """(path keys, leaf) pairs in ``tree_flatten_with_path`` order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], prefix + (f"[{k!r}]",))
    elif _is_namedtuple(tree):
        for name, v in zip(tree._fields, tree):
            yield from _flatten(v, prefix + (f".{name}",))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, prefix + (f"[{i}]",))
    elif tree is None:
        return
    else:
        yield prefix, tree


def _flatten_with_paths(tree: PyTree):
    flat = list(_flatten(tree))
    return ["/".join(p) for p, _ in flat], [leaf for _, leaf in flat]


def tree_leaves(tree: PyTree) -> List[Any]:
    """The leaves of ``tree`` in the order a checkpoint stores them."""
    return [leaf for _, leaf in _flatten(tree)]


def _unflatten(target: PyTree, leaves: List[Any]) -> PyTree:
    it = iter(leaves)

    def rebuild(t):
        if isinstance(t, dict):
            return {k: rebuild(t[k]) for k in sorted(t)}
        if _is_namedtuple(t):
            return type(t)(*[rebuild(v) for v in t])
        if isinstance(t, (list, tuple)):
            return type(t)(rebuild(v) for v in t)
        if t is None:
            return None
        return next(it)

    return rebuild(target)


# ------------------------------------------------------------ leaf bytes
def _leaf_bytes(leaf) -> Tuple[np.ndarray, List[int], str]:
    """(raw bytes as a flat uint8 view, shape, dtype name) of one leaf, as
    the reference writes them; a host leaf is not copied."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return (t.view(torch.int16).numpy().reshape(-1).view(np.uint8),
                    list(t.shape), "bfloat16")
        leaf = t.numpy()
    a = np.asarray(leaf)
    # shape before ascontiguousarray, which lifts a 0-d array to 1-d
    return (np.ascontiguousarray(a).reshape(-1).view(np.uint8),
            list(a.shape), str(a.dtype))


def _decode(raw: np.ndarray, dtype: str, shape: Tuple[int, ...]):
    """A leaf's raw bytes (a uint8 array this module owns) -> a numpy
    array (narrowed as the reference's restore does), or a CPU
    ``torch.bfloat16`` tensor for a bf16 leaf; viewed, not copied."""
    if dtype == "bfloat16":
        return torch.from_numpy(raw.view(np.int16).reshape(shape)).view(
            torch.bfloat16)
    dt = np.dtype(dtype)
    a = raw.view(dt).reshape(shape)
    return a.astype(_NARROW[dt]) if dt in _NARROW else a


def _itemsize(dtype: str) -> int:
    return 2 if dtype == "bfloat16" else np.dtype(dtype).itemsize


def _step_name(step: int) -> str:
    return f"step_{step:08d}"


def step_dir(ckpt_dir: str, step: int) -> str:
    """The directory ``save_checkpoint`` returns for ``step``."""
    return os.path.join(ckpt_dir, _step_name(step))


def _leaf_digest(raw) -> str:
    return hashlib.blake2b(raw, digest_size=16).hexdigest()


def _digests(raws: List[np.ndarray]) -> List[concurrent.futures.Future]:
    """The leaves' checksums, hashed on a thread pool (``hashlib`` releases
    the interpreter lock on large buffers): one future a leaf, so the
    hashing overlaps the shard's write."""
    pool = concurrent.futures.ThreadPoolExecutor(_HASH_THREADS)
    futures = [pool.submit(_leaf_digest, raw) for raw in raws]
    pool.shutdown(wait=False)
    return futures


def _fsync_path(path: str) -> None:
    """fsync a file or directory by path (best-effort on exotic fs)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _sweep_stale_tmp(ckpt_dir: str) -> None:
    """Remove tmp dirs left by a killed writer (single-writer protocol)."""
    for d in os.listdir(ckpt_dir):
        if d.startswith(".tmp_step_"):
            shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


# ------------------------------------------------------------------ save
def save_checkpoint(ckpt_dir: str, step: int, tree: PyTree,
                    extra: Optional[Dict[str, Any]] = None,
                    keep_last: int = 3) -> str:
    """Atomic, fsync'd, checksummed save.  Returns the final step dir."""
    t_save = time.perf_counter()
    paths, leaves = _flatten_with_paths(tree)
    if any(is_dtensor(leaf) for leaf in leaves):
        return _save_sharded(ckpt_dir, step, tree, extra, keep_last)
    os.makedirs(ckpt_dir, exist_ok=True)
    _sweep_stale_tmp(ckpt_dir)
    encoded = [_leaf_bytes(leaf) for leaf in leaves]
    raw = [e[0] for e in encoded]

    final = os.path.join(ckpt_dir, _step_name(step))
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=f".tmp_step_{step}_")
    try:
        faults.fire("checkpoint.save.pre_shard", step=step)
        digests = _digests(raw)
        shard_path = os.path.join(tmp, f"shard_{_HOST}.npz")
        np.savez(shard_path, **{f"leaf_{i}": b for i, b in enumerate(raw)})
        _fsync_path(shard_path)
        faults.fire("checkpoint.save.post_shard", step=step)
        manifest = {
            "manifest_version": MANIFEST_VERSION,
            "step": step,
            "n_leaves": len(leaves),
            "paths": paths,
            "shapes": [e[1] for e in encoded],
            "dtypes": [e[2] for e in encoded],
            "checksums": [f.result() for f in digests],
            "n_processes": 1,
            "extra": extra or {},
        }
        man_path = os.path.join(tmp, "manifest.json")
        with open(man_path, "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        _fsync_path(tmp)
        faults.fire("checkpoint.save.pre_rename", step=step)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        _fsync_path(ckpt_dir)
    except BaseException as e:
        # an InjectedFault emulates SIGKILL: leave the debris on disk so the
        # recovery path is tested against what a real kill leaves behind
        if not isinstance(e, faults.InjectedFault):
            shutil.rmtree(tmp, ignore_errors=True)
        raise
    faults.fire("checkpoint.save.post_rename", step=step)

    ptr_tmp = os.path.join(ckpt_dir, ".latest.tmp")
    with open(ptr_tmp, "w") as f:
        f.write(_step_name(step))
        f.flush()
        os.fsync(f.fileno())
    os.replace(ptr_tmp, os.path.join(ckpt_dir, "latest"))
    _fsync_path(ckpt_dir)
    faults.fire("checkpoint.save.post_latest", step=step)

    _gc(ckpt_dir, keep_last)
    t_done = time.perf_counter()
    obs.tracer.record("checkpoint.save", t_save, t_done)
    obs.metrics.counter("checkpoint.saves").inc()
    if t_done > t_save:
        obs.metrics.gauge("checkpoint.save_mbps").set(
            sum(b.nbytes for b in raw) / (t_done - t_save) / 1e6)
    return final


def _save_sharded(ckpt_dir: str, step: int, tree: PyTree,
                  extra: Optional[Dict[str, Any]], keep_last: int) -> str:
    """Every rank: gather each DTensor leaf whole, one leaf at a time
    (a collective), which global rank 0 moves to host memory at once and
    every other rank drops, so a device holds one whole leaf at most;
    rank 0 writes the plain tree; then a barrier."""
    import torch.distributed as dist
    _, leaves = _flatten_with_paths(tree)
    writer = dist.get_rank() == 0
    full = []
    for leaf in leaves:
        if is_dtensor(leaf):
            whole = leaf.full_tensor()
            leaf = whole.detach().cpu() if writer else None
            del whole
        full.append(leaf)
    final = step_dir(ckpt_dir, step)
    if writer:
        final = save_checkpoint(ckpt_dir, step, _unflatten(tree, full),
                                extra=extra, keep_last=keep_last)
    del full
    dist.barrier()
    return final


def _place(target, leaf):
    """A restored leaf for its target: split per a DTensor target's
    placements (on the target's device, no communication: every rank
    read the same array), else as read."""
    if not is_dtensor(target):
        return leaf
    from torch.distributed.tensor import distribute_tensor
    t = torch.as_tensor(leaf).to(target.to_local().device)
    return distribute_tensor(t, target.device_mesh, target.placements,
                             src_data_rank=None)


# ---------------------------------------------------------- verification
def _read_manifest(step_dir: str) -> Optional[Dict[str, Any]]:
    """Parse a step dir's manifest; None when missing/torn."""
    try:
        with open(os.path.join(step_dir, "manifest.json")) as f:
            m = json.load(f)
        for k in ("step", "n_leaves", "paths", "shapes", "dtypes"):
            if k not in m:
                return None
        return m
    except (OSError, ValueError):
        return None


def _quick_ok(step_dir: str) -> Optional[Dict[str, Any]]:
    """Manifest parses and this process's shard file exists."""
    m = _read_manifest(step_dir)
    if m is None:
        return None
    shard = os.path.join(step_dir, f"shard_{_HOST}.npz")
    return m if os.path.exists(shard) else None


def list_steps(ckpt_dir: str) -> List[int]:
    """Ascending step numbers of COMPLETE (quick-verified) step dirs."""
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for d in sorted(os.listdir(ckpt_dir)):
        if not d.startswith("step_"):
            continue
        if _quick_ok(os.path.join(ckpt_dir, d)) is not None:
            try:
                out.append(int(d.split("_")[1]))
            except ValueError:
                continue
    return out


def verify_step(ckpt_dir: str, step: int) -> bool:
    """Deep verification: manifest, shard, per-leaf sizes and checksums."""
    step_dir = os.path.join(ckpt_dir, _step_name(step))
    m = _quick_ok(step_dir)
    if m is None:
        return False
    try:
        _read_leaves(step_dir, m)
    except CheckpointCorruptError:
        return False
    return True


def _read_leaves(step_dir: str, manifest: Dict[str, Any]) -> List[Any]:
    """Load + verify this process's leaves; raises CheckpointCorruptError."""
    shard = os.path.join(step_dir, f"shard_{_HOST}.npz")
    checksums = manifest.get("checksums")
    raws = []
    try:
        with np.load(shard) as data:
            names = set(data.files)
            for i in range(manifest["n_leaves"]):
                key = f"leaf_{i}"
                if key not in names:
                    raise CheckpointCorruptError(
                        f"{shard}: missing {key} "
                        f"(has {len(names)}/{manifest['n_leaves']} leaves)")
                raw = data[key].reshape(-1).view(np.uint8)
                dt = manifest["dtypes"][i]
                shape = tuple(manifest["shapes"][i])
                want = int(np.prod(shape, dtype=np.int64)) * _itemsize(dt)
                if raw.nbytes != want:
                    raise CheckpointCorruptError(
                        f"{shard}: leaf_{i} holds {raw.nbytes} bytes, "
                        f"manifest says {want} ({shape}, {dt}) — truncated "
                        f"write?")
                raws.append(raw)
        if checksums is not None:
            for i, digest in enumerate(_digests(raws)):
                if digest.result() != checksums[i]:
                    raise CheckpointCorruptError(
                        f"{shard}: leaf_{i} checksum mismatch — corrupt "
                        f"payload (path {manifest['paths'][i]!r})")
        leaves = [_decode(raw, dt, tuple(shape)) for raw, dt, shape in zip(
            raws, manifest["dtypes"], manifest["shapes"])]
    except (OSError, ValueError, TypeError, zipfile.BadZipFile, zlib.error,
            KeyError) as e:
        # a torn zip (truncated shard), a CRC failure during member
        # decompression or an unknown dtype name lands here
        raise CheckpointCorruptError(f"{shard}: unreadable shard ({e})")
    return leaves


def _gc(ckpt_dir: str, keep_last: int) -> None:
    """Delete old step dirs; never a step being restored, and never the
    newest complete step."""
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))
    if keep_last <= 0:
        return
    victims = list(steps[:-keep_last])
    complete = {d for d in steps
                if _quick_ok(os.path.join(ckpt_dir, d)) is not None}
    surviving_complete = [d for d in steps
                          if d in complete and d not in victims]
    if not surviving_complete:
        for d in reversed(victims):         # spare the newest complete victim
            if d in complete:
                victims.remove(d)
                break
    for d in victims:
        path = os.path.join(ckpt_dir, d)
        if os.path.abspath(path) in _RESTORING:
            continue
        shutil.rmtree(path, ignore_errors=True)


def latest_step(ckpt_dir: str) -> Optional[int]:
    """Newest COMPLETE step.  The ``latest`` pointer is advisory: when it
    is missing, torn, or names an incomplete dir, the newest step dir that
    passes the completeness check wins."""
    if not os.path.isdir(ckpt_dir):
        return None
    ptr = os.path.join(ckpt_dir, "latest")
    if os.path.exists(ptr):
        try:
            with open(ptr) as f:
                name = f.read().strip()
            if name.startswith("step_") and \
                    _quick_ok(os.path.join(ckpt_dir, name)) is not None:
                return int(name.split("_")[1])
        except (OSError, ValueError):
            pass
    steps = list_steps(ckpt_dir)
    return steps[-1] if steps else None


def peek_manifest(ckpt_dir: str, step: Optional[int] = None
                  ) -> Dict[str, Any]:
    """Read a checkpoint's manifest without touching the array payload."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    m = _read_manifest(os.path.join(ckpt_dir, _step_name(step)))
    if m is None:
        raise CheckpointCorruptError(
            f"{ckpt_dir}/{_step_name(step)}: manifest missing or torn")
    return m


# --------------------------------------------------------------- restore
def _with_fallback(ckpt_dir: str, step: Optional[int], fn):
    """Run ``fn(step)`` on ``step``, or on the newest complete step and
    then older ones past corrupt steps (recorded in :func:`fallback_log`);
    an explicit ``step`` raises instead."""
    candidates = ([step] if step is not None
                  else list(reversed(list_steps(ckpt_dir))))
    if not candidates:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    last_err: Optional[Exception] = None
    for i, s in enumerate(candidates):
        try:
            out = fn(int(s))
            if i > 0:
                _note_fallback(ckpt_dir, candidates[:i])
            return out
        except CheckpointCorruptError as e:
            if step is not None:
                raise
            last_err = e
    raise CheckpointCorruptError(
        f"{ckpt_dir}: no step survived verification "
        f"(tried {candidates}; last error: {last_err})")


def restore_self_describing(ckpt_dir: str, step: Optional[int] = None
                            ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Restore a FLAT-dict checkpoint from its own manifest.  Returns
    ``({key: array}, extra)``: numpy arrays, bf16 leaves as CPU
    ``torch.bfloat16`` tensors."""
    def one(s: int):
        manifest = peek_manifest(ckpt_dir, s)
        target = {p.strip("[]'\""): 0 for p in manifest["paths"]}
        tree, _, extra = _restore_one(ckpt_dir, target, s)
        return tree, extra

    return _with_fallback(ckpt_dir, step, one)


def restore_checkpoint(ckpt_dir: str, target: PyTree,
                       step: Optional[int] = None
                       ) -> Tuple[PyTree, int, Dict[str, Any]]:
    """Restore into the structure of ``target`` (its leaves only name the
    slots; the stored arrays fill them).  Sizes and checksums are verified
    as the payload is read."""
    return _with_fallback(ckpt_dir, step,
                          lambda s: _restore_one(ckpt_dir, target, s))


def _restore_one(ckpt_dir: str, target: PyTree, step: int
                 ) -> Tuple[PyTree, int, Dict[str, Any]]:
    d = os.path.join(ckpt_dir, _step_name(step))
    _RESTORING.add(os.path.abspath(d))
    t_restore = time.perf_counter()
    try:
        manifest = _read_manifest(d)
        if manifest is None:
            raise CheckpointCorruptError(f"{d}: manifest missing or torn")
        leaves = _read_leaves(d, manifest)
        t_read = time.perf_counter()
        obs.tracer.record("checkpoint.restore", t_restore, t_read)
        obs.metrics.counter("checkpoint.restores").inc()
        if t_read > t_restore:
            nbytes = sum(leaf.numel() * leaf.element_size()
                         if isinstance(leaf, torch.Tensor) else leaf.nbytes
                         for leaf in leaves)
            obs.metrics.gauge("checkpoint.restore_mbps").set(
                nbytes / (t_read - t_restore) / 1e6)
        faults.fire("checkpoint.restore.mid", step=step)

        t_paths, t_leaves = _flatten_with_paths(target)
        if t_paths != manifest["paths"]:
            raise ValueError(
                "checkpoint/target structure mismatch:\n"
                f"  missing: {set(manifest['paths']) - set(t_paths)}\n"
                f"  extra:   {set(t_paths) - set(manifest['paths'])}")
        leaves = [_place(t, leaf) for t, leaf in zip(t_leaves, leaves)]
        return _unflatten(target, leaves), step, manifest["extra"]
    finally:
        _RESTORING.discard(os.path.abspath(d))
