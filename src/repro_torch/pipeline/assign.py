"""Chunked center assignment: the host half of the JAX package's
``pipeline.assign``, copied verbatim.

``nearest_center`` / ``nearest_top2_dists``: row-chunked
``‖x‖² + ‖c‖² − 2x·cᵀ`` GEMM form in numpy.  Peak memory is O(chunk · C),
never the (n, 1, d) − (1, C, d) broadcast.  Per-row results do not depend
on the chunking.  Ties resolve to the LOWEST center index (``argmin``), so
the serving router and the overlap cell builder share one rule.
``assign_stream`` (numpy backend) and ``lloyd_stream`` serve the cell
builders.  The device backend (the resident-center assignment kernel, B6)
waits: cell building runs on the host here, as the reference's builders
do (``backend="numpy"``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from repro_torch.pipeline.dataset import DEFAULT_CHUNK, as_source


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


def assign_stream(source, centers: np.ndarray,
                  chunk_size: int = DEFAULT_CHUNK,
                  backend: str = "numpy") -> np.ndarray:
    """Owner id per row over a whole chunk source (numpy backend only)."""
    if backend != "numpy":
        raise NotImplementedError(
            f"assign_stream backend {backend!r}: the device assignment "
            f"kernel is not ported yet; use backend='numpy'")
    src = as_source(source)
    centers = np.asarray(centers, np.float32)
    out = np.empty(src.n_rows, np.int32)
    cnorm = center_norms(centers)
    for lo, chunk in src.iter_chunks(chunk_size):
        out[lo:lo + chunk.shape[0]] = \
            _d2_chunk(chunk, centers, cnorm).argmin(1).astype(np.int32)
    return out


def lloyd_stream(source, centers: np.ndarray, iters: int,
                 chunk_size: int = DEFAULT_CHUNK) -> np.ndarray:
    """Full-batch Lloyd sweeps over a chunk source, O(chunk·C) memory.

    Center updates are running sums (``np.add.at`` in ascending row order,
    so the accumulation is chunking-invariant); a center whose cell goes
    empty keeps its previous position."""
    src = as_source(source)
    centers = np.array(centers, np.float32, copy=True)
    n_centers, d = centers.shape
    for _ in range(iters):
        csum = np.zeros((n_centers, d), np.float32)
        cnt = np.zeros(n_centers, np.int64)
        cnorm = center_norms(centers)
        for _, chunk in src.iter_chunks(chunk_size):
            a = _d2_chunk(chunk, centers, cnorm).argmin(1)
            np.add.at(csum, a, chunk)
            cnt += np.bincount(a, minlength=n_centers)
        nonempty = cnt > 0
        denom = np.maximum(cnt, 1).astype(np.float32)[:, None]
        centers = np.where(nonempty[:, None], csum / denom, centers)
    return centers
