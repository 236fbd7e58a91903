"""Plain PyTorch reference of liquidSVM's cell fit: per-cell gamma grids,
k-fold CV over the (gamma, lambda) grid, the solves and the selection.

It follows liquidSVM's published algorithm step by step, as the
benchmarked program runs it, so that the two agree to rounding and the
comparison is tight:

* the per-cell gamma grid from the median pairwise distance of a strided
  subsample (``liquid_grid``: 5x the median down to the fold's spacing),
  the lambda grid 1 ... 1 / (4 n_fold^2) from the padded cell size;
* the folds from jax's threefry stream (``perfbench.reference.prng``):
  one key per slot split from the configuration's seed, a uniform draw per
  row, rows dealt to folds by rank;
* the hinge dual  min 0.5 c'Kc - c'y  over the box  0 <= y_i c_i <= C,
  C = 1 / (2 lambda n_train), by FISTA with gradient restart, step 1/L from
  32 power iterations (start vector from the stream), stopped by the
  box-scaled projected-gradient residual checked every 10 steps, then
  ``cd_polish`` Gauss-Seidel sweeps; the gamma scan warm-starts each gamma
  from the previous one's solution;
* least squares: (K + lambda n_train I) c = y on each fold's rows, by one
  symmetric eigendecomposition per fold and gamma;
* validation loss per (gamma, task, lambda): the 0-1 loss of the hinge
  models, the squared error of the least-squares ones, averaged over folds.

Padding positions of a slot (the partition's index 0 again, masked out:
a zero-width box, no fold) are kept as the program keeps them: they enter
the Gram, hence the power iteration's step.

Nothing here imports the program: the reference gets raw rows, labels,
the cell partition (checked on its own by ``perfbench.reference.staging``)
and the configuration's settings, and works out everything else again.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from perfbench.reference import prng
from perfbench.reference.numerics import Numerics

_EPS = 1e-12
_GRID_SIZES = {0: (10, 10), 1: (15, 15), 2: (20, 20)}


# the least-squares grid points whose solves the surface compares: where
# float32's eigh is off by at most ~eps_32 x 100 ~ 1e-5, below what a
# product in TF32 moves (~5e-4); past it the float32 eigh's own error is as
# large as the control's
KAPPA_MAX = 1e2


@dataclasses.dataclass
class Mirror:
    """The reference's fit of some slots.  slots (S',); gammas (S', G);
    lambdas (L,); surface (S', G, T, L, Sub) mean validation loss;
    coefs (S', G, k, T, L, Sub) fold-averaged models at every grid point;
    posed (S', G, T, L, Sub): every fold's solve of the grid point is well
    posed in float32 (always, for the hinge solver; least squares: the
    condition number (s_max + lambda n) / (lambda n) at most
    ``KAPPA_MAX``)."""
    slots: np.ndarray
    gammas: np.ndarray
    lambdas: np.ndarray
    surface: np.ndarray
    coefs: np.ndarray
    posed: np.ndarray


def sq_dists(nm: Numerics, x: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Squared distances in GEMM form, max(|x|^2 + |z|^2 - 2 x.z, 0)."""
    xx = (x * x).sum(-1)[..., :, None]
    zz = (z * z).sum(-1)[..., None, :]
    return torch.clamp(xx + zz - 2.0 * nm.mm(x, z.transpose(-1, -2)), min=0.0)


def gauss(d2: torch.Tensor, gamma) -> torch.Tensor:
    """liquidSVM's Gaussian kernel exp(-d^2 / gamma^2)."""
    return torch.exp(-d2 / (gamma * gamma))


def median_distance(nm: Numerics, x: torch.Tensor, mask: torch.Tensor,
                    max_points: int = 512) -> float:
    """Median pairwise distance of a strided subsample of the padded cell
    (pairs of live, distinct rows); an even count takes the mean of the two
    middle values."""
    stride = max(1, x.shape[0] // max_points)
    xs, ms = x[::stride], mask[::stride] > 0
    d2 = sq_dists(nm, xs, xs)
    valid = ~torch.eye(xs.shape[0], dtype=torch.bool, device=x.device)
    valid &= ms[:, None] & ms[None, :]
    v = torch.sort(d2[valid].reshape(-1).double().cpu()).values
    q = 0.5 * (v.numel() - 1)
    lo, hi = int(np.floor(q)), int(np.ceil(q))
    w = q - np.floor(q)
    med = float(v[lo]) * (1.0 - w) + float(v[hi]) * w
    return float(np.sqrt(max(med, _EPS)))


def gamma_grid(n: int, dim: int, median: float, grid_choice: int,
               cell_size: int) -> np.ndarray:
    """liquidSVM's geometric gamma grid of a cell of ``n`` live rows."""
    n_gamma = _GRID_SIZES[grid_choice][0]
    n_fold = max(int(n * 0.8), 2)
    k = min(cell_size, n_fold)
    g_max = 5.0 * median
    g_min = median * (max(k, 2) / n_fold) ** (1.0 / dim) / n_fold ** (
        1.0 / max(dim, 1))
    g_min = min(g_min, g_max / 8.0)
    return g_max * (g_min / g_max) ** np.linspace(0.0, 1.0, n_gamma)


def lambda_grid(k: int, grid_choice: int) -> np.ndarray:
    """liquidSVM's lambda grid 1 ... 1 / (4 n_fold^2), n_fold from the padded
    cell size ``k``."""
    n_lambda = _GRID_SIZES[grid_choice][1]
    n_fold = max(int(k * 0.8), 2)
    return (1.0 / (4.0 * float(n_fold) ** 2)) ** np.linspace(0.0, 1.0,
                                                             n_lambda)


def fold_masks(key: np.ndarray, n_live: int, k: int, n_folds: int
               ) -> np.ndarray:
    """(F, k) bool validation masks of a slot whose first ``n_live`` of
    ``k`` rows are live: the rows sorted by a uniform draw (stable), the
    r-th in that order to fold r mod F."""
    u = prng.uniform(np.asarray(key, np.uint32), n_live)
    rank = np.empty(n_live, np.int64)
    rank[np.argsort(u, kind="stable")] = np.arange(n_live)
    out = np.zeros((n_folds, k), bool)
    out[rank % n_folds, np.arange(n_live)] = True
    return out


def power_l(nm: Numerics, k_mat: torch.Tensor, iters: int = 32
            ) -> torch.Tensor:
    """1.05 x the largest eigenvalue of each slot's Gram (S, n, n) -> (S,),
    by power iteration from jax's normal(PRNGKey(0), n)."""
    n = k_mat.shape[-1]
    v0 = torch.from_numpy(prng.normal(prng.PRNGKey(0), n)).to(k_mat)
    v = v0.expand(k_mat.shape[0], n)[..., None]
    for _ in range(iters):
        w = nm.mm(k_mat, v)
        v = w / torch.clamp(torch.linalg.vector_norm(w, dim=(-2, -1),
                                                     keepdim=True), min=1e-30)
    lam = (v * nm.mm(k_mat, v)).sum(dim=(-2, -1))
    return torch.clamp(lam, min=_EPS) * 1.05


def _kc(nm: Numerics, k_mat: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """(S, n, n) x (S, F, n, P) -> (S, F, n, P)."""
    return nm.mm(k_mat[:, None], c)


def _kkt(c, g, lo, hi) -> torch.Tensor:
    """Box-scaled projected-gradient residual per (S, F, P)."""
    r = c - torch.clamp(c - g, min=lo, max=hi)
    width = torch.clamp((hi - lo).amax(dim=-2), min=1e-30)
    return r.abs().amax(dim=-2) / width


def fista(nm: Numerics, k_mat, y, lo, hi, c0, l_est, tol: float,
          max_iters: int, check_every: int = 10) -> torch.Tensor:
    """FISTA with gradient restart on every (slot, fold), each with its own
    momentum, restart test (one sum over its whole iterate) and stop."""
    step = (1.0 / l_est).reshape(-1, 1, 1, 1)
    c = z = torch.clamp(c0, min=lo, max=hi)
    s, f = y.shape[:2]
    t = torch.ones((s, f), dtype=y.dtype, device=y.device)
    active = torch.ones((s, f), dtype=torch.bool, device=y.device)
    for it in range(max_iters):
        g = _kc(nm, k_mat, z) - y
        c_new = torch.clamp(z - step * g, min=lo, max=hi)
        restart = (g * (c_new - c)).sum(dim=(-2, -1)) > 0.0
        t_new = torch.where(restart, torch.ones_like(t),
                            0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * t * t)))
        beta = torch.where(restart, torch.zeros_like(t), (t - 1.0) / t_new)
        z_new = c_new + beta[..., None, None] * (c_new - c)
        a4 = active[..., None, None]
        c = torch.where(a4, c_new, c)
        z = torch.where(a4, z_new, z)
        t = torch.where(active, t_new, t)
        if (it + 1) % check_every == 0:
            res = _kkt(c, _kc(nm, k_mat, c) - y, lo, hi)
            active &= res.amax(dim=-1) > tol
            if not bool(active.any()):
                break
    return c


def gauss_seidel(nm: Numerics, k_mat, y, lo, hi, c, epochs: int
                 ) -> torch.Tensor:
    """``epochs`` exact sweeps over coordinates 0..n-1, each coordinate of
    every column at once, the gradient kept by rank-1 updates."""
    c = torch.clamp(c, min=lo, max=hi).clone()
    g = _kc(nm, k_mat, c) - y
    diag = torch.clamp(torch.diagonal(k_mat, dim1=-2, dim2=-1), min=_EPS)
    for _ in range(epochs):
        for i in range(k_mat.shape[-1]):
            ci = c[:, :, i]
            target = torch.clamp(ci - g[:, :, i] / diag[:, i, None, None],
                                 min=lo[:, :, i], max=hi[:, :, i])
            delta = target - ci
            c[:, :, i] = target
            g += k_mat[:, None, :, i, None] * delta[:, :, None, :]
    return c


def krr_folds(nm: Numerics, k_mat, y, lam_n, train):
    """(K_TT + lambda n I) c = y on each fold's rows T, zero elsewhere:
    k_mat (S, n, n); y (S, F, n, P) zero off T; lam_n (S, F, P); train
    (S, F, n) -> c (S, F, n, P) and each column's condition number
    (S, F, P), by one eigh per (slot, fold) of ``nm``'s operand."""
    m = train.to(k_mat.dtype)
    km = (k_mat[:, None] * m[..., :, None] * m[..., None, :]
          + torch.diag_embed(1.0 - m))
    s, u = torch.linalg.eigh(nm.eigh_operand(km))
    s = torch.clamp(s, min=0.0)
    uty = nm.mm(u.transpose(-1, -2), y)
    kappa = (s[..., -1:] + lam_n) / lam_n
    return nm.mm(u, uty / (s[..., :, None] + lam_n[..., None, :])), kappa


def fit_slots(nm: Numerics, xs: np.ndarray, labels: np.ndarray,
              task_mask: np.ndarray, indices: np.ndarray, mask: np.ndarray,
              order: np.ndarray, n_slots: int, settings: Dict,
              slots: Sequence[int], device,
              n_gammas: Optional[int] = None) -> Mirror:
    """The reference's CV fit of ``slots`` over the first ``n_gammas`` of
    each slot's gammas (default: all).

    xs (n, d) the reference's scaled rows; labels, task_mask (T, n); the
    partition: indices, mask (cells, k) and order (slots,) the cell of each
    slot (-1: empty); ``settings`` the configuration's liquidSVM keys."""
    solver = settings["solver"]
    n_folds, grid_choice = settings["n_folds"], settings["grid_choice"]
    k, d = indices.shape[1], xs.shape[1]
    n_tasks = labels.shape[0]
    subs = np.asarray(settings.get("weights", (1.0,)), np.float64)
    keys = prng.split(prng.PRNGKey(settings.get("seed", 0)), n_slots)

    lambdas = lambda_grid(k, grid_choice)
    n_lam, n_sub = len(lambdas), len(subs)
    lam_c = np.tile(np.repeat(lambdas, n_sub), n_tasks)          # (P,)
    sub_c = np.tile(subs, n_lam * n_tasks)
    task_c = np.repeat(np.arange(n_tasks), n_lam * n_sub)

    x_w, m_w, y_w, tm_w, val_w, gam_w = [], [], [], [], [], []
    for s in slots:
        cid = int(order[s])
        xp = np.zeros((k, d))
        mp = np.zeros(k)
        yp = np.zeros((n_tasks, k))
        tp = np.zeros((n_tasks, k))
        n_live = 0
        if cid >= 0:
            ids = indices[cid]
            mp = (mask[cid] > 0).astype(np.float64)
            n_live = int(mp.sum())
            xp = xs[ids]                  # padding positions hold row 0
            yp = labels[:, ids] * mp
            tp = task_mask[:, ids] * mp
        xt, mt = nm.tensor(xp, device), nm.tensor(mp, device)
        med = median_distance(nm, xt, mt) if n_live else 1.0
        gam_w.append(gamma_grid(max(n_live, 1), d, med, grid_choice,
                                settings["cell_size"]))
        x_w.append(xt)
        m_w.append(mt)
        y_w.append(yp)
        tm_w.append(tp)
        val_w.append(fold_masks(keys[s], n_live, k, n_folds))
    x = torch.stack(x_w)
    msk = torch.stack(m_w)                                        # (S, k)
    val = torch.as_tensor(np.stack(val_w), device=device)         # (S, F, k)
    train = ~val & (msk > 0)[:, None, :]
    y_cols = nm.tensor(np.stack(y_w)[:, task_c].transpose(0, 2, 1),
                       device)[:, None]                           # (S,1,k,P)
    colmask = (nm.tensor(np.stack(tm_w)[:, task_c].transpose(0, 2, 1),
                         device) * msk[:, :, None])[:, None]
    tr = train.to(nm.dtype)[..., None] * colmask                  # (S,F,k,P)
    va = val.to(nm.dtype)[..., None] * colmask
    n_eff = torch.clamp(tr.sum(dim=-2), min=1.0)                  # (S, F, P)
    lam_t, sub_t = nm.tensor(lam_c, device), nm.tensor(sub_c, device)
    gammas = np.stack(gam_w)                                      # (S, G)

    d2 = sq_dists(nm, x, x)
    d2 = 0.5 * (d2 + d2.transpose(-1, -2))
    s_cnt, p = len(slots), lam_c.shape[0]
    c_prev = torch.zeros((s_cnt, n_folds, k, p), dtype=nm.dtype,
                         device=device)
    surf: List[np.ndarray] = []
    coefs: List[np.ndarray] = []
    posed: List[np.ndarray] = []
    for gi in range(gammas.shape[1] if n_gammas is None else n_gammas):
        k_mat = gauss(d2, nm.tensor(gammas[:, gi], device)[:, None, None])
        ok = np.ones((s_cnt, p), bool)
        if solver == "hinge":
            cost = (1.0 / (2.0 * lam_t * n_eff))[..., None, :]    # (S,F,1,P)
            w = torch.where(y_cols > 0, sub_t, torch.ones_like(sub_t))
            edge = y_cols * cost * w * tr
            lo, hi = torch.clamp(edge, max=0.0), torch.clamp(edge, min=0.0)
            y_eff = y_cols * tr
            c = fista(nm, k_mat, y_eff, lo, hi, c_prev, power_l(nm, k_mat),
                      settings["tol"], settings["max_iters"])
            if settings.get("cd_polish", 0) > 0:
                c = gauss_seidel(nm, k_mat, y_eff, lo, hi, c,
                                 settings["cd_polish"])
        elif solver == "ls":
            y_ls = (y_cols * tr[..., :1]).expand_as(tr)
            c, kappa = krr_folds(nm, k_mat, y_ls, lam_t * n_eff, train)
            ok = (kappa.amax(dim=1) <= KAPPA_MAX).cpu().numpy()
        else:
            raise ValueError(f"reference fit: solver {solver!r}")
        f_val = _kc(nm, k_mat, c)
        if solver == "hinge":
            loss = ((f_val * y_cols) <= 0.0).to(nm.dtype)
        else:
            loss = (y_cols - f_val) ** 2
        vl = (loss * va).sum(-2) / torch.clamp(va.sum(-2), min=1.0)
        surf.append((vl.sum(1) / n_folds).reshape(
            s_cnt, n_tasks, n_lam, n_sub).cpu().numpy())
        coefs.append((c.sum(1) / n_folds).reshape(
            s_cnt, k, n_tasks, n_lam, n_sub).cpu().numpy())
        posed.append(ok.reshape(s_cnt, n_tasks, n_lam, n_sub))
        c_prev = c
    return Mirror(slots=np.asarray(slots), gammas=gammas[:, :len(surf)],
                  lambdas=lambdas,
                  surface=np.stack(surf, 1), coefs=np.stack(coefs, 1),
                  posed=np.stack(posed, 1))
