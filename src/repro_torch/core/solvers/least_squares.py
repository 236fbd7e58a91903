"""Least-squares solver, kernel ridge regression (the JAX package's
``core/solvers/least_squares.py``): (K + lambda n I) c = y on the training
coordinates; one eigendecomposition sweeps the whole lambda path as a
diagonal rescale.  With M = diag(train_mask), eigh(M K M + I - M) solves
the fold subproblem exactly: the masked block is the identity and
decouples from the trained block, and y is 0 there, so masked coordinates
get c = 0.  The unit diagonal keeps the decomposition well posed (M K M
alone has exact zero rows, on which LAPACK's f32 eigh can fail to
converge at one thread)."""
from __future__ import annotations

from typing import Optional

import torch


def _masked(k_mat: torch.Tensor, train_mask: Optional[torch.Tensor]
            ) -> torch.Tensor:
    if train_mask is None:
        return k_mat
    m = train_mask.to(k_mat.dtype)
    return k_mat * m[..., :, None] * m[..., None, :]


def krr_eigh_path(k_mat: torch.Tensor, y: torch.Tensor, lam_n: torch.Tensor,
                  train_mask: torch.Tensor) -> torch.Tensor:
    """Batched: k_mat (..., n, n); y (..., n, P) (already masked); lam_n
    (..., P) = lambda * n_eff per column.  Returns c (..., n, P)."""
    m = train_mask.to(torch.float32)
    km = _masked(k_mat.to(torch.float32), m) + torch.diag_embed(1.0 - m)
    s, u = torch.linalg.eigh(km)
    s = torch.clamp(s, min=0.0)
    uty = u.transpose(-1, -2) @ y
    return u @ (uty / (s[..., :, None] + lam_n[..., None, :]))


def solve_krr_eigh(k_mat: torch.Tensor, y: torch.Tensor,
                   lambdas: torch.Tensor, n_eff,
                   train_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """All-lambda KRR path via one eigh.  Returns c (n, P)."""
    y = y.to(torch.float32)
    if train_mask is not None:
        y = y * train_mask.to(torch.float32)
    else:
        train_mask = torch.ones_like(y)
    n_eff = torch.clamp(torch.as_tensor(n_eff, dtype=torch.float32), min=1.0)
    lam_n = lambdas.to(torch.float32) * n_eff
    return krr_eigh_path(k_mat, y[:, None].expand(-1, lam_n.shape[0]),
                         lam_n, train_mask)


def solve_krr_chol(k_mat: torch.Tensor, y: torch.Tensor, lam, n_eff,
                   train_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Single-lambda Cholesky path."""
    km = _masked(k_mat.to(torch.float32), train_mask)
    y = y.to(torch.float32)
    if train_mask is not None:
        y = y * train_mask.to(torch.float32)
    n = km.shape[0]
    dev = km.device
    n_eff = torch.clamp(torch.as_tensor(n_eff, dtype=torch.float32,
                                        device=dev), min=1.0)
    lam = torch.as_tensor(lam, dtype=torch.float32, device=dev)
    a = km + (lam * n_eff) * torch.eye(n, dtype=torch.float32, device=dev)
    return torch.cholesky_solve(y[:, None], torch.linalg.cholesky(a))[:, 0]
