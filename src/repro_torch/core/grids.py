"""Hyper-parameter grids (the JAX package's ``core/grids.py``).

``libsvm_grid`` is libsvm's fixed 10x11 grid converted to liquidSVM's
length-scale gamma; ``liquid_grid`` is liquidSVM's geometric grid whose
endpoints adapt to the fold size, cell size and dimension (grid_choice
0/1/2 -> 10x10 / 15x15 / 20x20); ``adaptive_subgrid`` the coarse subset.

Grids are small host tensors in float32, formed with the reference's
float32 operations in its order (the lambdas in float64, as numpy does
there), so a grid is the reference's to the ulp.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.core import kernel_fns


@dataclasses.dataclass(frozen=True)
class GridSpec:
    gammas: torch.Tensor   # (G,) f32, length-scale convention
    lambdas: torch.Tensor  # (L,) f32, descending

    @property
    def shape(self) -> Tuple[int, int]:
        return (len(self.gammas), len(self.lambdas))


def libsvm_grid(n: int) -> GridSpec:
    """gamma_libsvm in 2^{3,1,...,-15}, cost in 2^{-5,-3,...,15},
    lambda = 1 / (2 cost n)."""
    g = 2.0 ** np.arange(3, -17, -2, dtype=np.float64)
    cost = 2.0 ** np.arange(-5, 17, 2, dtype=np.float64)
    lam = 1.0 / (2.0 * cost * n)
    return GridSpec(
        gammas=kernel_fns.libsvm_gamma_to_scale(
            torch.tensor(g, dtype=torch.float32)),
        lambdas=torch.tensor(np.sort(lam)[::-1].copy(), dtype=torch.float32))


def _unit_linspace(num: int) -> torch.Tensor:
    """jnp.linspace(0, 1, num) in f32: iota / (num - 1), then exactly 1."""
    if num == 1:
        return torch.zeros(1)
    div = num - 1
    steps = torch.arange(div, dtype=torch.float32) / float(div)
    return torch.cat([steps, torch.ones(1)])


def liquid_grid(n: int, dim: int, median_dist=1.0, grid_choice: int = 0,
                cell_size: int | None = None) -> GridSpec:
    """liquidSVM's adaptive geometric grid: gamma from 5x the median
    distance down to the nearest-neighbour spacing of a fold, lambda from
    1 down to 1/(4 n_fold^2)."""
    sizes = {0: (10, 10), 1: (15, 15), 2: (20, 20)}
    if grid_choice not in sizes:
        raise ValueError(f"grid_choice must be 0/1/2, got {grid_choice}")
    n_gamma, n_lambda = sizes[grid_choice]
    n_fold = max(int(n * 0.8), 2)
    k = cell_size if cell_size is not None else n_fold
    k = min(k, n_fold)

    f32 = torch.float32
    med = torch.as_tensor(median_dist, dtype=f32).cpu()
    gamma_max = 5.0 * med
    gamma_min = (med * torch.pow(torch.tensor(max(k, 2), dtype=f32) / n_fold,
                                 1.0 / dim)
                 / torch.pow(torch.tensor(n_fold, dtype=f32),
                             1.0 / max(dim, 1)))
    gamma_min = torch.minimum(gamma_min, gamma_max / 8.0)
    gammas = gamma_max * torch.pow(gamma_min / gamma_max,
                                   _unit_linspace(n_gamma))

    s = np.linspace(0.0, 1.0, n_lambda)
    lambdas = 1.0 * np.power((1.0 / (4.0 * float(n_fold) ** 2)) / 1.0, s)
    return GridSpec(gammas=gammas.to(f32),
                    lambdas=torch.tensor(lambdas, dtype=f32))


def adaptive_subgrid(full: GridSpec, level: int) -> GridSpec:
    """level 1 keeps every 2nd gamma/lambda, level 2 every 3rd."""
    if level <= 0:
        return full
    step = level + 1
    return GridSpec(gammas=full.gammas[::step], lambdas=full.lambdas[::step])
