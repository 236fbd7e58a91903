"""Asymmetric least-squares (expectile) solver by IRLS (the JAX package's
``core/solvers/expectile.py``):

    W_i = tau if y_i > f_i else (1 - tau);   (K + lambda n W^-1) c = y

a fixed number of sweeps, one Cholesky per column and sweep.  A warm start
``c0`` only sets the first sweep's weights; the fixed point is unchanged.
"""
from __future__ import annotations

from typing import Optional

import torch


def expectile_loss(y: torch.Tensor, f: torch.Tensor, tau) -> torch.Tensor:
    r = y - f
    return torch.where(r >= 0, tau * r * r, (1.0 - tau) * r * r)


def irls_path(km: torch.Tensor, y: torch.Tensor, taus: torch.Tensor,
              lam_n: torch.Tensor, mask: torch.Tensor, c0: torch.Tensor,
              sweeps: int = 12) -> torch.Tensor:
    """Batched IRLS: km (..., n, n) masked Gram; y (..., n) masked target;
    taus, lam_n (..., P); mask (..., n); c0 (..., n, P).  Columns run one
    at a time, each batched over the leading axes."""
    eye = torch.eye(km.shape[-1], dtype=km.dtype, device=km.device)
    cols = []
    for p in range(c0.shape[-1]):
        tau = taus[..., p, None]
        c = c0[..., p]
        for _ in range(sweeps):
            f = (km @ c[..., None])[..., 0]
            w = torch.where(y - f > 0, tau, 1.0 - tau)
            w = torch.where(mask > 0, w, torch.ones_like(w))
            a = km + eye * (lam_n[..., p, None] / w)[..., None, :]
            c = torch.cholesky_solve(y[..., None],
                                     torch.linalg.cholesky(a))[..., 0]
        cols.append(c)
    return torch.stack(cols, dim=-1)


def solve_expectile(k_mat: torch.Tensor, y: torch.Tensor, taus: torch.Tensor,
                    lambdas: torch.Tensor, n_eff,
                    train_mask: Optional[torch.Tensor] = None,
                    sweeps: int = 12,
                    c0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Returns c (n, P)."""
    k_mat = k_mat.to(torch.float32)
    n = k_mat.shape[0]
    dev = k_mat.device
    mask = (torch.ones(n, device=dev) if train_mask is None
            else train_mask.to(torch.float32))
    km = k_mat * mask[:, None] * mask[None, :]
    y = y.to(torch.float32) * mask
    n_eff = torch.clamp(torch.as_tensor(n_eff, dtype=torch.float32,
                                        device=dev), min=1.0)
    lam_n = lambdas.to(torch.float32) * n_eff
    if c0 is None:
        c0 = torch.zeros((n, taus.shape[0]), device=dev)
    return irls_path(km, y, taus.to(torch.float32), lam_n, mask,
                     c0.to(torch.float32), sweeps)
