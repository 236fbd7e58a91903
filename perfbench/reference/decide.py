"""Plain reference of the test phase: held-out rows routed to their cell's
model and scored by it, sum_j c_j exp(-|x - x_j|^2 / gamma^2).

The models (coefficients, gammas) are the program's output under judgement;
the reference scales and routes the rows and builds every kernel value
itself, from its own scaled training rows of each cell.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from perfbench.reference.fit import gauss, sq_dists
from perfbench.reference.numerics import Numerics

# two centers closer than this share of the nearer distance tie to
# rounding: the row is scored by both cells and the nearer score counts
_TIE = 1e-5


def route(nm: Numerics, xt: torch.Tensor, centers: torch.Tensor
          ) -> Tuple[np.ndarray, np.ndarray]:
    """Nearest and second-nearest center of each row: (m,) ids each; the
    second is -1 unless the two tie to rounding."""
    d2 = sq_dists(nm, xt, centers)
    two = torch.topk(d2, min(2, d2.shape[1]), dim=1, largest=False)
    first = two.indices[:, 0].cpu().numpy()
    second = np.full_like(first, -1)
    if d2.shape[1] > 1:
        gap = (two.values[:, 1] - two.values[:, 0]).cpu().numpy()
        near = two.values[:, 0].cpu().numpy()
        tie = gap <= _TIE * np.maximum(near, 1.0)
        second[tie] = two.indices[tie, 1].cpu().numpy()
    return first, second


def cell_scores(nm: Numerics, xt: torch.Tensor, sv: torch.Tensor,
                coefs: torch.Tensor, gamma: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decisions of one cell's models and their scale: xt (m, d), sv (k, d),
    coefs (k, P), gamma (P,) -> (m, P) sum_j c_j K_j and sum_j |c_j| K_j."""
    d2 = sq_dists(nm, xt, sv)                                   # (m, k)
    kk = gauss(d2[None], gamma[:, None, None])                  # (P, m, k)
    dec = nm.mm(kk, coefs.T[:, :, None])[..., 0].T
    scale = nm.mm(kk, coefs.abs().T[:, :, None])[..., 0].T
    return dec, scale


def decision_gaps(nm: Numerics, xs_held: np.ndarray, centers: np.ndarray,
                  slot_of_cell: np.ndarray, xs_train: np.ndarray,
                  indices: np.ndarray, mask: np.ndarray, coefs: np.ndarray,
                  gamma: np.ndarray, dec: np.ndarray, device,
                  block: int = 4096) -> np.ndarray:
    """Per held-out row, the largest |program - reference| over its
    (task, sub) columns, as a share of sum_j |c_j| K_j.

    xs_held (m, d) the reference's scaled held-out rows; xs_train (n, d)
    its scaled training rows; indices, mask the partition; coefs
    (slots, k, T, Sub), gamma (slots, T, Sub) the program's models; dec
    (m, T, Sub) the program's decisions."""
    m = xs_held.shape[0]
    cols = coefs.shape[2] * coefs.shape[3]
    dec = dec.reshape(m, cols)
    gaps = np.full(m, np.inf)
    for lo in range(0, m, block):
        xt = nm.tensor(xs_held[lo:lo + block], device)
        first, second = route(nm, xt, nm.tensor(centers, device))
        for pick in (first, second):
            for cid in np.unique(pick[pick >= 0]):
                rows = np.flatnonzero(pick == cid)
                slot = int(slot_of_cell[cid])
                live = mask[cid] > 0
                sv = nm.tensor(xs_train[indices[cid][live]], device)
                co = nm.tensor(coefs[slot][live].reshape(-1, cols), device)
                ga = nm.tensor(gamma[slot].reshape(cols), device)
                want, scale = cell_scores(nm, xt[rows], sv, co, ga)
                got = torch.as_tensor(dec[lo + rows]).to(want)
                err = ((got - want).abs()
                       / torch.clamp(scale, min=1e-30)).amax(dim=1)
                at = lo + rows
                gaps[at] = np.minimum(gaps[at], err.double().cpu().numpy())
    return gaps


def decisions(nm: Numerics, xs_held: np.ndarray, centers: np.ndarray,
              slot_of_cell: np.ndarray, xs_train: np.ndarray,
              indices: np.ndarray, mask: np.ndarray, coefs: np.ndarray,
              gamma: np.ndarray, device) -> np.ndarray:
    """The reference's own test phase in ``nm``: (m, T, Sub) decisions of
    the models for rows routed to their nearest center (the control puts
    this in the program's place)."""
    m = xs_held.shape[0]
    cols = coefs.shape[2] * coefs.shape[3]
    out = np.zeros((m, cols))
    xt = nm.tensor(xs_held, device)
    first, _ = route(nm, xt, nm.tensor(centers, device))
    for cid in np.unique(first):
        rows = np.flatnonzero(first == cid)
        slot = int(slot_of_cell[cid])
        live = mask[cid] > 0
        sv = nm.tensor(xs_train[indices[cid][live]], device)
        co = nm.tensor(coefs[slot][live].reshape(-1, cols), device)
        ga = nm.tensor(gamma[slot].reshape(cols), device)
        out[rows] = cell_scores(nm, xt[rows], sv, co, ga)[0].double().cpu(
            ).numpy()
    return out.reshape((m,) + coefs.shape[2:])
