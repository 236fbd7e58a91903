"""Plain PyTorch version of the fused multi-cell predict (Gram materialized).

The serving-engine contract: a batch of cells, each with its own SV table
and P = n_tasks * n_sub coefficient columns where every column may carry a
DIFFERENT selected gamma.  D² is computed once per cell and each column
replays only the per-gamma epilogue.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.kernel_matrix.ref import (gram_from_d2_ref,
                                                  kernel_matrix_ref,
                                                  sq_dists_ref)


def svm_predict_ref(x_test: torch.Tensor, sv: torch.Tensor,
                    coefs: torch.Tensor, gamma: float,
                    kind: str = "gauss_rbf") -> torch.Tensor:
    """f = K(x_test, sv) @ coefs, one gamma: (nt, d), (ns, d), (ns, P) ->
    (nt, P); 1-D coefs -> (nt, 1)."""
    if coefs.dim() == 1:
        coefs = coefs[:, None]
    return kernel_matrix_ref(x_test, sv, gamma, kind) @ coefs.to(torch.float32)


def svm_predict_cells_ref(xt: torch.Tensor, sv: torch.Tensor,
                          coefs: torch.Tensor, gammas: torch.Tensor,
                          kind: str = "gauss_rbf") -> torch.Tensor:
    """xt (C, m, d), sv (C, k, d), coefs (C, k, P), gammas (C, P) -> (C, m, P)."""
    d2 = sq_dists_ref(xt, sv)                                    # (C, m, k)
    k = gram_from_d2_ref(d2[:, None], gammas[:, :, None, None], kind)
    cols = coefs.to(torch.float32).transpose(1, 2)[..., None]    # (C, P, k, 1)
    return torch.matmul(k, cols)[..., 0].transpose(1, 2)         # (C, m, P)
