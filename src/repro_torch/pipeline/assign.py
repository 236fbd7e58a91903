"""Chunked center assignment: the O(n·C·d) core of cell construction,
after the JAX package's ``pipeline.assign``.

Every consumer of "which center owns this row" goes through here:

  * host path — ``nearest_center`` / ``nearest_top2_dists``: row-chunked
    ``‖x‖² + ‖c‖² − 2x·cᵀ`` GEMM form in numpy, copied verbatim.  Peak
    memory is O(chunk · C), never the (n, 1, d) − (1, C, d) broadcast.
    Per-row results do not depend on the chunking.  Ties resolve to the
    LOWEST center index (``argmin``), so the serving router and the
    overlap cell builder share one rule;
  * device path — ``_assign_block`` (plain PyTorch GEMM form and argmin,
    the reference's ``_assign_block_jax``) and ``assign_kernel`` (the
    hand-written nearest-center kernel B6, the reference's
    ``assign_pallas``).  Both follow the reference's device path, whose
    d² is NOT clamped at 0 (the host path's ``_d2_chunk`` clamps): a row
    whose two nearest centers lie within rounding of each other may
    change owner between the backends, never by more than the GEMM
    form's error;
  * ``assign_stream`` — owner ids over a chunk source with the backend
    "numpy" (bit-exact reference used by the builders), "torch"
    (``_assign_block`` on the device; the reference's "jax") or "kernel"
    (B6; the reference's "pallas");
  * ``lloyd_stream`` — full-batch Lloyd sweeps with ``np.add.at``
    running-sum center updates on the host; only the assignment moves to
    the device, and the centers are uploaded once per sweep;
  * ``minibatch_kmeans`` — Sculley-style minibatch k-means on the device:
    per-batch assignment and per-center learning rates 1/count; seeded
    and deterministic on the card too (the segment sums are a one-hot
    product, not atomics).

For "torch", "kernel" and ``minibatch_kmeans`` ``device=None`` means the
CUDA card and raises without one; ``device="cpu"`` runs the plain
versions (the tests' mode).
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.kernels import runtime
from repro_torch.kernels.assign import ops as assign_ops
from repro_torch.kernels.assign.ref import assign_ref
from repro_torch.pipeline.dataset import DEFAULT_CHUNK, as_source

Device = Union[None, str, torch.device]
BACKENDS = ("numpy", "torch", "kernel")
_RENAMED = {"jax": "torch", "pallas": "kernel"}


# --------------------------------------------------------------- host (numpy)
def center_norms(centers: np.ndarray) -> np.ndarray:
    """‖c‖² per center, computed once per sweep and shared across chunks."""
    c = np.asarray(centers, np.float32)
    return (c * c).sum(1)


def _d2_chunk(chunk: np.ndarray, centers: np.ndarray,
              cnorm: Optional[np.ndarray] = None) -> np.ndarray:
    """(m, d) x (C, d) -> (m, C) squared distances, GEMM form, f32."""
    if cnorm is None:
        cnorm = center_norms(centers)
    xx = (chunk * chunk).sum(1)
    d2 = xx[:, None] + cnorm[None, :] - 2.0 * (chunk @ centers.T)
    np.maximum(d2, 0.0, out=d2)
    return d2


def nearest_center(x: np.ndarray, centers: np.ndarray,
                   chunk_size: int = DEFAULT_CHUNK) -> np.ndarray:
    """Row-chunked nearest-center ids, (m,) int32.  O(chunk·C) memory."""
    x = np.asarray(x, np.float32)
    centers = np.asarray(centers, np.float32)
    cnorm = center_norms(centers)
    out = np.empty(x.shape[0], np.int32)
    for lo in range(0, x.shape[0], chunk_size):
        chunk = x[lo:lo + chunk_size]
        out[lo:lo + chunk.shape[0]] = _d2_chunk(chunk, centers, cnorm).argmin(1)
    return out


def _top2_chunk(chunk: np.ndarray, centers: np.ndarray,
                cnorm: Optional[np.ndarray] = None
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """THE two-nearest rule (argmin, mask, argmin) — single implementation
    shared by every overlap-cells consumer so tie-breaking cannot drift.

    Returns ``(nn1, nn2, d1, d2)`` with the two squared distances.
    Tie-breaking is ``argmin``'s: the LOWEST center index wins, so an
    exactly equidistant row (duplicated centers included) deterministically
    gets ``nn1 < nn2`` with ``d1 == d2`` — the serving engine's overlap
    router and the overlap cell builder both inherit this rule from here.
    """
    d2 = _d2_chunk(chunk, centers, cnorm)
    rows = np.arange(chunk.shape[0])
    a1 = d2.argmin(1)
    dist1 = d2[rows, a1].copy()
    d2[rows, a1] = np.inf
    a2 = d2.argmin(1)
    dist2 = d2[rows, a2].copy()
    return (a1.astype(np.int32), a2.astype(np.int32),
            dist1.astype(np.float32), dist2.astype(np.float32))


def nearest_top2(x: np.ndarray, centers: np.ndarray,
                 chunk_size: int = DEFAULT_CHUNK
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Two nearest center ids per row (overlap cells), chunked, int32."""
    nn1, nn2, _, _ = assign_top2_stream(np.asarray(x, np.float32),
                                        np.asarray(centers, np.float32),
                                        chunk_size)
    return nn1, nn2


def nearest_top2_dists(x: np.ndarray, centers: np.ndarray,
                       chunk_size: int = DEFAULT_CHUNK
                       ) -> Tuple[np.ndarray, np.ndarray,
                                  np.ndarray, np.ndarray]:
    """``(nn1, nn2, d1, d2)`` per row — ids AND squared distances.

    The serving engine's overlap router consumes this (the distances feed
    the blend weights); it is the same ``_top2_chunk`` core the overlap
    cell builder uses, so serve-time routing cannot drift from the
    decomposition's 2-cell ownership rule.
    """
    return assign_top2_stream(np.asarray(x, np.float32),
                              np.asarray(centers, np.float32), chunk_size)


def assign_top2_stream(source, centers: np.ndarray,
                       chunk_size: int = DEFAULT_CHUNK
                       ) -> Tuple[np.ndarray, np.ndarray,
                                  np.ndarray, np.ndarray]:
    """(nn1, nn2, d1, d2) per row over a whole chunk source (overlap
    ownership + the squared distances of the pair)."""
    src = as_source(source)
    centers = np.asarray(centers, np.float32)
    cnorm = center_norms(centers)
    nn1 = np.empty(src.n_rows, np.int32)
    nn2 = np.empty(src.n_rows, np.int32)
    d1 = np.empty(src.n_rows, np.float32)
    d2 = np.empty(src.n_rows, np.float32)
    for lo, chunk in src.iter_chunks(chunk_size):
        hi = lo + chunk.shape[0]
        nn1[lo:hi], nn2[lo:hi], d1[lo:hi], d2[lo:hi] = \
            _top2_chunk(chunk, centers, cnorm)
    return nn1, nn2, d1, d2


def _check_backend(backend: str) -> None:
    if backend in _RENAMED:
        raise ValueError(f"unknown backend {backend!r}: the port's "
                         f"counterpart of the JAX package's {backend!r} "
                         f"backend is {_RENAMED[backend]!r}")
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}: one of {BACKENDS}")


def assign_stream(source, centers: np.ndarray,
                  chunk_size: int = DEFAULT_CHUNK,
                  backend: str = "numpy", device: Device = None
                  ) -> np.ndarray:
    """Owner id per row over a whole chunk source, (n,) int32.

    ``backend``: "numpy" (bit-exact reference used by the builders),
    "torch" (``_assign_block`` on ``device``) or "kernel" (B6 on
    ``device``; on the CPU its plain version).
    """
    _check_backend(backend)
    dev = None if backend == "numpy" else runtime.resolve_device(device)
    src = as_source(source)
    out = np.empty(src.n_rows, np.int32)
    assign_chunk = _assigner(np.asarray(centers, np.float32), backend, dev)
    for lo, chunk in src.iter_chunks(chunk_size):
        out[lo:lo + chunk.shape[0]] = assign_chunk(chunk)
    return out


def lloyd_stream(source, centers: np.ndarray, iters: int,
                 chunk_size: int = DEFAULT_CHUNK, backend: str = "numpy",
                 device: Device = None) -> np.ndarray:
    """Full-batch Lloyd sweeps over a chunk source, O(chunk·C) memory.

    Center updates are running sums (``np.add.at`` in ascending row order,
    so the accumulation is chunking-invariant); a center whose cell goes
    empty keeps its previous position.  ``backend`` picks the assignment
    as in :func:`assign_stream`; the update stays on the host."""
    _check_backend(backend)
    dev = None if backend == "numpy" else runtime.resolve_device(device)
    src = as_source(source)
    centers = np.array(centers, np.float32, copy=True)
    n_centers, d = centers.shape
    for _ in range(iters):
        csum = np.zeros((n_centers, d), np.float32)
        cnt = np.zeros(n_centers, np.int64)
        assign_chunk = _assigner(centers, backend, dev)
        for _, chunk in src.iter_chunks(chunk_size):
            a = assign_chunk(chunk)
            np.add.at(csum, a, chunk)
            cnt += np.bincount(a, minlength=n_centers)
        nonempty = cnt > 0
        denom = np.maximum(cnt, 1).astype(np.float32)[:, None]
        centers = np.where(nonempty[:, None], csum / denom, centers)
    return centers


# ------------------------------------------------------- device (PyTorch)
def _upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host f32 array as a tensor on ``device`` (a copy: memmap chunks
    are read-only)."""
    return torch.tensor(np.asarray(a, np.float32), device=device)


def _assign_block(chunk: torch.Tensor, centers: torch.Tensor
                  ) -> torch.Tensor:
    """Plain PyTorch GEMM-form d² + argmin on the tensors' device (the
    reference's ``_assign_block_jax``), the cross term in full fp32."""
    with runtime.full_fp32():
        return assign_ref(chunk, centers)


def assign_kernel(x, centers, device: Device = None) -> np.ndarray:
    """Nearest-center ids via the nearest-center kernel B6 (the
    reference's ``assign_pallas``): host arrays in, (n,) int32 out."""
    dev = runtime.resolve_device(device)
    return assign_ops.assign(_upload(x, dev),
                             _upload(centers, dev)).cpu().numpy()


def _assigner(centers: np.ndarray, backend: str,
              device: Optional[torch.device]
              ) -> Callable[[np.ndarray], np.ndarray]:
    """chunk -> (m,) int32 owner ids by ``backend``; the center norms
    (numpy) or the uploaded centers (on ``device``) are made once."""
    if backend == "numpy":
        cnorm = center_norms(centers)
        return lambda chunk: (_d2_chunk(chunk, centers, cnorm).argmin(1)
                              .astype(np.int32))
    c = _upload(centers, device)
    fn = _assign_block if backend == "torch" else assign_ops.assign
    return lambda chunk: fn(_upload(chunk, device), c).cpu().numpy()


# ------------------------------------------------------- minibatch k-means
def _mbk_step(centers: torch.Tensor, counts: torch.Tensor,
              batch: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One Sculley minibatch step: assign, then per-center rate-1/count pull.

    The per-center sums are a one-hot product, whose order of summation is
    fixed (``index_add_`` on the card adds with atomics, in an order that
    changes from run to run); centers a batch never touches are left in
    place (their update term is zero).
    """
    a = _assign_block(batch, centers)
    n_centers = centers.shape[0]
    onehot = (a[:, None] == torch.arange(n_centers, device=a.device)
              ).to(torch.float32)                                  # (b, C)
    with runtime.full_fp32():
        bs = onehot.T @ batch                                      # (C, d)
    bc = onehot.sum(0)
    new_counts = counts + bc
    upd = (bs - bc[:, None] * centers) / torch.clamp(new_counts,
                                                      min=1.0)[:, None]
    return centers + upd, new_counts


def minibatch_kmeans(source, n_centers: int, iters: int = 20,
                     batch_size: int = 4096, seed: int = 0,
                     device: Device = None) -> np.ndarray:
    """Seeded minibatch k-means over a chunk source, device-side updates.

    Initial centers are a uniform sample of rows; each iteration gathers a
    fresh seeded sample (sorted ids, as the reference draws them from
    ``np.random.default_rng(seed)``) and applies one :func:`_mbk_step`.
    Deterministic for a fixed (source, seed, iters, batch_size, device).
    """
    dev = runtime.resolve_device(device)
    src = as_source(source)
    n = src.n_rows
    rng = np.random.default_rng(seed)
    init_ids = rng.choice(n, min(n_centers, n), replace=False)
    centers = _upload(src.gather(init_ids), dev)
    counts = torch.zeros(centers.shape[0], dtype=torch.float32, device=dev)
    b = min(batch_size, n)
    for _ in range(iters):
        ids = np.sort(rng.choice(n, b, replace=False))
        centers, counts = _mbk_step(centers, counts,
                                    _upload(src.gather(ids), dev))
    return centers.cpu().numpy()
