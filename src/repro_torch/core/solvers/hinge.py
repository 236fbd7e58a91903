"""(Weighted) hinge-loss SVM solver, offset-free dual (the JAX package's
``core/solvers/hinge.py``).

Dual in coefficient space:  min_c 0.5 c^T K c - c^T y  with
c_i y_i in [0, C w_i],  C = 1 / (2 lambda n): a box QP with
lo_i = min(0, y_i C w_i), hi_i = max(0, y_i C w_i).  Padding and non-fold
samples get lo = hi = 0, which removes them exactly.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.solvers import base


def hinge_boxes(y: torch.Tensor, lambdas: torch.Tensor, n_eff,
                sample_weight: Optional[torch.Tensor] = None,
                train_mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-column boxes (lo, hi), each (n, P)."""
    y = y.to(torch.float32)
    n_eff = torch.as_tensor(n_eff, dtype=torch.float32)
    cost = 1.0 / (2.0 * lambdas.to(torch.float32)
                  * torch.clamp(n_eff, min=1.0))
    w = (torch.ones_like(y) if sample_weight is None
         else sample_weight.to(torch.float32))
    if w.dim() == 1:
        w = w[:, None]
    edge = y[:, None] * cost[None, :] * w
    lo = torch.clamp(edge, max=0.0)
    hi = torch.clamp(edge, min=0.0)
    if train_mask is not None:
        m = train_mask.to(torch.float32)[:, None]
        lo, hi = lo * m, hi * m
    return lo, hi


def solve_hinge(k_mat: torch.Tensor, y: torch.Tensor, lambdas: torch.Tensor,
                n_eff, sample_weight: Optional[torch.Tensor] = None,
                train_mask: Optional[torch.Tensor] = None,
                c0: Optional[torch.Tensor] = None, tol: float = 1e-3,
                max_iters: int = 2000, l_est=None) -> base.BoxQPResult:
    lo, hi = hinge_boxes(y, lambdas, n_eff, sample_weight, train_mask)
    y_col = y.to(torch.float32)
    if train_mask is not None:
        y_col = y_col * train_mask.to(torch.float32)
    return base.box_qp(k_mat, y_col, lo, hi, c0=c0, tol=tol,
                       max_iters=max_iters, l_est=l_est)
