"""Working-set decomposition into cells (liquidSVM §2 "Managing Working Sets").

Methods (paper's `voronoi=` configurations):
  random      — random chunks of size <= k (Bottou–Vapnik style)
  voronoi     — spatial Voronoi cells from sampled centers (+ Lloyd sweeps)
  overlap     — voronoi=5: overlapping cells (a cell trains on every point
                whose 2 nearest centers include it; ownership = 1-NN)
  recursive   — voronoi=6: recursive 2-means splitting until <= k
  coarse_fine — Table-4 Spark scheme: coarse cells of ~K samples, each
                recursively split into fine cells of <= k

Cell construction is host-side (a data-pipeline step, as in the C++
package); the resulting plan is a set of STATIC-shape padded index arrays
that the wave trainer consumes.

The implementation is the streaming builder in
``repro_torch.pipeline.cell_stream`` run over an in-memory source: chunked
GEMM-form distances (never an (n, 1, d) − (1, C, d) broadcast), running-sum
Lloyd updates, and — by construction — a plan that is bit-identical to the
out-of-core path on the same data.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class CellPlan:
    """Padded, static-shape decomposition.

    indices:  (n_cells, k_max) int32 — row ids into the dataset (0-padded)
    mask:     (n_cells, k_max) f32   — 1 for real members
    owner:    (n,) int32             — owning cell per sample (prediction routing)
    centers:  (n_cells, d) f32       — cell centers (nearest-center routing)
    coarse_of:(n_cells,) int32       — coarse group of each fine cell (or zeros)
    """
    indices: np.ndarray
    mask: np.ndarray
    owner: np.ndarray
    centers: np.ndarray
    coarse_of: np.ndarray

    @property
    def n_cells(self) -> int:
        return self.indices.shape[0]

    @property
    def k_max(self) -> int:
        return self.indices.shape[1]

    def route(self, x: np.ndarray) -> np.ndarray:
        """Nearest-center cell id for new points (test-phase routing).

        Row-chunked ‖x‖² + ‖c‖² − 2x·cᵀ — O(chunk · n_cells) peak, any m.
        """
        from repro_torch.pipeline.assign import nearest_center
        return nearest_center(np.asarray(x, np.float32), self.centers)


def _pad_groups(groups: list, n_pad_to: Optional[int] = None):
    k_max = max((len(g) for g in groups), default=1)
    k_max = max(k_max, 1)
    if n_pad_to is not None:
        k_max = max(k_max, n_pad_to)
    idx = np.zeros((len(groups), k_max), np.int32)
    mask = np.zeros((len(groups), k_max), np.float32)
    for c, g in enumerate(groups):
        idx[c, : len(g)] = g
        mask[c, : len(g)] = 1.0
    return idx, mask


def build_cells(
    x: np.ndarray,
    cell_size: int = 2000,
    method: str = "voronoi",
    seed: int = 0,
    lloyd_iters: int = 3,
    coarse_size: int = 20000,
    pad_to: Optional[int] = None,
) -> CellPlan:
    """Decompose x (n, d) into cells of <= cell_size samples.

    Thin in-memory wrapper over the streaming builder (one implementation;
    ``repro_torch.pipeline.cell_stream.build_cells_stream`` takes any source).
    """
    from repro_torch.pipeline.cell_stream import build_cells_stream
    from repro_torch.pipeline.dataset import ArraySource
    return build_cells_stream(
        ArraySource(np.asarray(x, np.float32)), cell_size=cell_size,
        method=method, seed=seed, lloyd_iters=lloyd_iters,
        coarse_size=coarse_size, pad_to=pad_to)
