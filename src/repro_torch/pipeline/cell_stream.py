"""Two-pass streaming cell construction: a CellPlan at any n.

The in-memory builder (`repro_torch.cells.builder.build_cells`) is this module
run over an :class:`ArraySource` — one implementation, two entry points —
and the streaming result is REQUIRED to be bit-identical for any source
and any chunk size.  That invariant holds because every per-row quantity
(assignment argmin, top-2) depends only on the row and the center table,
and every accumulated quantity (Lloyd sums, cell-member means) is summed
in ascending row order regardless of chunk boundaries (``np.add.at``).

Pass structure for the spatial methods (voronoi / overlap):

  pass 0  —  seeded center sample (``gather``) + streaming Lloyd sweeps
             (`assign.lloyd_stream`): O(chunk·C) peak, never (n, C);
  pass 1  —  ownership (and second-nearest for overlap) + per-cell member
             counts: O(n) int32 output, O(chunk·C) transient;
  pass 2  —  emit the padded per-cell index lists chunk-by-chunk into the
             preallocated (n_cells, k_max) plan, accumulating member sums
             for the final cell centers on the way.

``random`` touches data only for the final centers; ``recursive`` is
documented O(n) staging (it must see all points to split them — use
``coarse_fine`` at scale, which gathers one <= coarse_size coarse cell at
a time).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.cells.builder import CellPlan, _pad_groups
from repro_torch.pipeline import assign as assign_mod
from repro_torch.pipeline.dataset import DEFAULT_CHUNK, ChunkSource, as_source


def _owner_of_groups(groups, n: int) -> np.ndarray:
    owner = np.empty(n, np.int32)
    for c, g in enumerate(groups):
        owner[g] = c
    return owner


def _centers_by_owner(src: ChunkSource, owner: np.ndarray, n_cells: int,
                      chunk_size: int) -> np.ndarray:
    """Member means for a partition, accumulated in ascending row order."""
    csum = np.zeros((n_cells, src.dim), np.float32)
    cnt = np.zeros(n_cells, np.int64)
    for lo, chunk in src.iter_chunks(chunk_size):
        a = owner[lo:lo + chunk.shape[0]]
        np.add.at(csum, a, chunk)
        cnt += np.bincount(a, minlength=n_cells)
    return csum / np.maximum(cnt, 1).astype(np.float32)[:, None]


def _scatter_members(idx, mask, fill, cells_flat, rows_flat):
    """Append (row -> cell) pairs, IN GIVEN ORDER, into the padded plan."""
    order = np.argsort(cells_flat, kind="stable")
    sc = cells_flat[order]
    uniq, seg_start, seg_count = np.unique(sc, return_index=True,
                                           return_counts=True)
    pos = fill[sc] + (np.arange(sc.shape[0]) - np.repeat(seg_start, seg_count))
    idx[sc, pos] = rows_flat[order]
    mask[sc, pos] = 1.0
    fill[uniq] += seg_count


def _recursive_split(pts: np.ndarray, ids: np.ndarray, k: int,
                     rng: np.random.Generator, out: list) -> None:
    """voronoi=6: 2-means split until each part has <= k members.

    ``pts`` holds the rows of ``ids`` (local gather), so recursion never
    re-touches the source.
    """
    if len(ids) <= k:
        out.append(ids)
        return
    c = pts[rng.choice(len(ids), 2, replace=False)].copy()
    for _ in range(8):
        a = assign_mod._d2_chunk(pts, c).argmin(1)
        for j in (0, 1):
            if (a == j).any():
                c[j] = pts[a == j].mean(0)
    a = assign_mod._d2_chunk(pts, c).argmin(1)
    if (a == 0).all() or (a == 1).all():  # degenerate split: halve by order
        mid = len(ids) // 2
        _recursive_split(pts[:mid], ids[:mid], k, rng, out)
        _recursive_split(pts[mid:], ids[mid:], k, rng, out)
        return
    m0 = a == 0
    _recursive_split(pts[m0], ids[m0], k, rng, out)
    _recursive_split(pts[~m0], ids[~m0], k, rng, out)


def _drop_empty_rows(idx, mask, owner, coarse, counts):
    keep = np.flatnonzero(counts > 0)
    if keep.shape[0] == idx.shape[0]:
        return idx, mask, owner, coarse, keep
    old_to_new = np.zeros(idx.shape[0], np.int32)
    old_to_new[keep] = np.arange(keep.shape[0], dtype=np.int32)
    return idx[keep], mask[keep], old_to_new[owner], coarse[keep], keep


def build_cells_stream(
    source,
    cell_size: int = 2000,
    method: str = "voronoi",
    seed: int = 0,
    lloyd_iters: int = 3,
    coarse_size: int = 20000,
    pad_to: Optional[int] = None,
    chunk_size: int = DEFAULT_CHUNK,
) -> CellPlan:
    """Decompose a chunked source into cells of <= cell_size samples.

    Accepts anything :func:`repro_torch.pipeline.dataset.as_source` takes
    (ndarray or ChunkSource).  Produces a
    :class:`CellPlan` bit-identical to ``build_cells`` on the same data.
    """
    src = as_source(source)
    n, d = src.n_rows, src.dim
    rng = np.random.default_rng(seed)

    if method == "none" or n <= cell_size:
        groups = [np.arange(n, dtype=np.int32)]
        owner = np.zeros(n, np.int32)
        coarse = np.zeros(1, np.int32)
    elif method == "random":
        perm = rng.permutation(n).astype(np.int32)
        n_cells = int(np.ceil(n / cell_size))
        groups = [perm[c::n_cells] for c in range(n_cells)]
        owner = _owner_of_groups(groups, n)
        coarse = np.zeros(len(groups), np.int32)
    elif method in ("voronoi", "overlap"):
        return _build_spatial(src, cell_size, method, rng, lloyd_iters,
                              pad_to, chunk_size)
    elif method == "recursive":
        pts = src.materialize()        # documented O(n): the top split must
        out: list = []                 # see every point; use coarse_fine at scale
        _recursive_split(pts, np.arange(n, dtype=np.int32), cell_size, rng, out)
        groups = out
        owner = _owner_of_groups(groups, n)
        coarse = np.zeros(len(groups), np.int32)
    elif method == "coarse_fine":
        coarse_plan = build_cells_stream(src, cell_size=coarse_size,
                                         method="voronoi", seed=seed,
                                         lloyd_iters=lloyd_iters,
                                         chunk_size=chunk_size)
        groups, coarse_list = [], []
        for cc in range(coarse_plan.n_cells):
            ids = coarse_plan.indices[cc][coarse_plan.mask[cc] > 0].astype(
                np.int32)
            pts = src.gather(ids)      # bounded: one coarse cell at a time
            out = []
            _recursive_split(pts, ids, cell_size, rng, out)
            groups.extend(out)
            coarse_list.extend([cc] * len(out))
        owner = _owner_of_groups(groups, n)
        coarse = np.asarray(coarse_list, np.int32)
    else:
        raise ValueError(f"unknown cell method {method!r}")

    # drop empty cells, pad, centers (partition methods: means by owner)
    keep = [i for i, g in enumerate(groups) if len(g) > 0]
    if len(keep) != len(groups):
        old_to_new = np.zeros(len(groups), np.int32)
        for new, old in enumerate(keep):
            old_to_new[old] = new
        coarse = coarse[keep]
        groups = [groups[i] for i in keep]
        owner = old_to_new[owner]
    idx, mask = _pad_groups(groups, pad_to)
    centers = _centers_by_owner(src, owner, len(groups), chunk_size)
    return CellPlan(indices=idx, mask=mask, owner=owner, centers=centers,
                    coarse_of=np.asarray(coarse, np.int32))


def _build_spatial(src: ChunkSource, cell_size: int, method: str,
                   rng: np.random.Generator, lloyd_iters: int,
                   pad_to: Optional[int], chunk_size: int) -> CellPlan:
    """voronoi / overlap via the three streaming passes (see module doc)."""
    n, d = src.n_rows, src.dim
    n_cells = int(np.ceil(n / cell_size))

    # pass 0: seeded sample + streaming Lloyd
    init = src.gather(rng.choice(n, n_cells, replace=False))
    route_centers = assign_mod.lloyd_stream(src, init, lloyd_iters,
                                            chunk_size=chunk_size)

    # pass 1: ownership (+ 2nd-nearest for overlap) and member counts —
    # the same shared assignment helpers every other consumer routes through
    if method == "overlap":
        owner, nn2, _, _ = assign_mod.assign_top2_stream(src, route_centers,
                                                         chunk_size)
    else:
        owner = assign_mod.assign_stream(src, route_centers, chunk_size)
        nn2 = None
    counts = np.bincount(owner, minlength=n_cells)
    if nn2 is not None:
        counts = counts + np.bincount(nn2, minlength=n_cells)

    # pass 2: emit padded index lists chunk-by-chunk + member sums
    k_max = max(int(counts.max()), 1)
    if pad_to is not None:
        k_max = max(k_max, pad_to)
    idx = np.zeros((n_cells, k_max), np.int32)
    mask = np.zeros((n_cells, k_max), np.float32)
    fill = np.zeros(n_cells, np.int64)
    csum = np.zeros((n_cells, d), np.float32)
    for lo, chunk in src.iter_chunks(chunk_size):
        hi = lo + chunk.shape[0]
        rows = np.arange(lo, hi, dtype=np.int32)
        if nn2 is None:
            cells_flat, rows_flat = owner[lo:hi], rows
            x_flat = chunk
        else:  # overlap: each row belongs to its 2 nearest cells
            cells_flat = np.stack([owner[lo:hi], nn2[lo:hi]], 1).reshape(-1)
            rows_flat = np.repeat(rows, 2)
            x_flat = np.repeat(chunk, 2, axis=0)
        _scatter_members(idx, mask, fill, cells_flat, rows_flat)
        np.add.at(csum, cells_flat, x_flat)      # ascending row order

    centers = csum / np.maximum(counts, 1).astype(np.float32)[:, None]
    coarse = np.zeros(n_cells, np.int32)
    idx, mask, owner, coarse, keep = _drop_empty_rows(idx, mask, owner,
                                                      coarse, counts)
    return CellPlan(indices=idx, mask=mask, owner=owner,
                    centers=centers[keep].astype(np.float32),
                    coarse_of=coarse)
