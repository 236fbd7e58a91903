"""Pinball-loss solver for quantile regression (the JAX package's
``core/solvers/quantile.py``): the hinge box QP with the asymmetric,
label-independent box c_i in [C (tau - 1), C tau]."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.solvers import base


def quantile_boxes(taus: torch.Tensor, lambdas: torch.Tensor, n_eff,
                   train_mask: Optional[torch.Tensor] = None,
                   n: Optional[int] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    n_eff = torch.as_tensor(n_eff, dtype=torch.float32, device=taus.device)
    cost = 1.0 / (2.0 * lambdas.to(torch.float32)
                  * torch.clamp(n_eff, min=1.0))
    lo_row = cost * (taus.to(torch.float32) - 1.0)
    hi_row = cost * taus.to(torch.float32)
    if train_mask is not None:
        m = train_mask.to(torch.float32)[:, None]
    else:
        if n is None:
            raise ValueError("quantile_boxes: pass train_mask or n")
        m = torch.ones((n, 1), device=taus.device)
    return m * lo_row[None, :], m * hi_row[None, :]


def solve_quantile(k_mat: torch.Tensor, y: torch.Tensor, taus: torch.Tensor,
                   lambdas: torch.Tensor, n_eff,
                   train_mask: Optional[torch.Tensor] = None,
                   c0: Optional[torch.Tensor] = None, tol: float = 1e-3,
                   max_iters: int = 3000, l_est=None) -> base.BoxQPResult:
    lo, hi = quantile_boxes(taus, lambdas, n_eff, train_mask,
                            n=k_mat.shape[0])
    y_col = y.to(torch.float32)
    if train_mask is not None:
        y_col = y_col * train_mask.to(torch.float32)
    return base.box_qp(k_mat, y_col, lo, hi, c0=c0, tol=tol,
                       max_iters=max_iters, l_est=l_est)


def pinball_loss(y: torch.Tensor, f: torch.Tensor, tau) -> torch.Tensor:
    r = y - f
    return torch.where(r >= 0, tau * r, (tau - 1.0) * r)
