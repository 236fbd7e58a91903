"""k-fold cross-validation over a wave of cells (the JAX package's
``core/cv.py``).

Execution shape, for a (S, n, d) wave of padded cells:

    D2 = sq_dists(X, X, symmetric)         # B1: one launch for the wave
    for gamma in the per-cell grids:       # the gamma scan, warm-started
        K = epilogue(D2, gamma)            # B2: one launch, (S, n, n)
        solve all (fold, task, lambda, sub) columns as one batched box QP
                                           # FISTA: cuBLAS products, the
                                           # folds share their slot's K
        [cd_polish epochs]                 # B4: one launch per epoch
        validation decisions = K @ C; streaming selection per (task, sub)

Where the reference vmaps ``cv_cell`` over slots and folds, the port
carries both as explicit leading axes: every launch covers the whole
wave, and no Python loop runs over slots or folds.  Columns are
task-major, ``col = t * (n_lam * n_sub) + l * n_sub + s``.  Folds are
boolean masks; padding and task exclusion are zero-width boxes.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import kernel_fns, prng
from repro_torch.core.grids import GridSpec
from repro_torch.core.solvers import base as qp
from repro_torch.core.solvers import expectile as exp_solver
from repro_torch.core.solvers import least_squares as ls_solver
from repro_torch.core.solvers import quantile as q_solver
from repro_torch.kernels import runtime
from repro_torch.kernels.cd_solver import ops as cd_ops


@dataclasses.dataclass(frozen=True)
class CVConfig:
    solver: str = "hinge"           # hinge | ls | quantile | expectile
    kernel: str = "gauss_rbf"
    n_folds: int = 5
    fold_scheme: str = "random"     # random | stratified | blocks
    tol: float = 1e-3
    max_iters: int = 1000
    val_loss: str = "auto"          # auto: 0-1 for hinge, mse for ls, ...
    shared_lipschitz: bool = True   # one L per slot and gamma (False: per
                                    # fold, from the fold's masked Gram)
    gram_dtype: str = "f32"         # f32 | bf16 Gram for hinge/quantile
    keep_surface: bool = False      # also count validation false alarms
                                    # and detections (hinge)
    taus: Tuple[float, ...] = (0.5,)
    weights: Tuple[float, ...] = (1.0,)
    cd_polish: int = 0              # Gauss-Seidel epochs after each box QP

    @property
    def n_sub(self) -> int:
        if self.solver in ("quantile", "expectile"):
            return len(self.taus)
        return len(self.weights)


class CVSelected(NamedTuple):
    """Streaming-selection output of a wave, per (slot, task, sub)."""
    coefs: torch.Tensor      # (S, F, n, T, Sub) fold models at the argmin
    gamma: torch.Tensor      # (S, T, Sub)
    lam: torch.Tensor        # (S, T, Sub)
    tau: torch.Tensor        # (S, T, Sub)
    weight: torch.Tensor     # (S, T, Sub)
    val_loss: torch.Tensor   # (S, T, Sub) best mean validation loss
    val_grid: torch.Tensor   # (S, G, T, L, Sub) full CV surface
    fa_grid: torch.Tensor    # (S, G, T, L, Sub) validation false alarms
    det_grid: torch.Tensor   # (S, G, T, L, Sub) validation detections
    iters: torch.Tensor      # (S, G, F) box-QP iterations per solve


def make_fold_masks(keys: np.ndarray, mask: torch.Tensor, n_folds: int,
                    scheme: str = "random",
                    y: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Validation masks, True = in the validation part.

    ``keys`` (2,) uint32 with ``mask`` (n,) -> (n_folds, n), or (S, 2) with
    (S, n) -> (S, n_folds, n).  The uniforms are the reference's
    ``jax.random.uniform(key, (n,))`` bit for bit; masked rows sort last
    as +inf ties, in a stable order, as ``jnp.argsort`` does."""
    single = mask.dim() == 1
    keys = np.asarray(keys, np.uint32).reshape(-1, 2)
    mask = mask[None] if single else mask
    if y is not None and single:
        y = y[None]
    s, n = mask.shape
    valid = mask > 0
    if scheme == "blocks":
        idx = torch.cumsum(valid.to(torch.int64), dim=-1) - 1
        n_valid = torch.clamp(valid.sum(-1, keepdim=True), min=1)
        fold_of = (idx * n_folds) // n_valid
    else:
        u = torch.from_numpy(prng.uniform(keys, n)).to(mask.device)
        if scheme == "stratified" and y is not None:
            u = u + 10.0 * (y > 0).to(torch.float32)
        u = torch.where(valid, u, torch.inf)
        order = torch.argsort(u, dim=-1, stable=True)
        rank = torch.argsort(order, dim=-1, stable=True)
        fold_of = rank % n_folds
    fold_of = torch.where(valid, fold_of, -1)
    folds = torch.arange(n_folds, device=mask.device)
    out = fold_of[:, None, :] == folds[None, :, None]
    return out[0] if single else out


def grid_columns(grid: GridSpec, cfg: CVConfig, n_tasks: int):
    """Task-major flattened columns: (lam_c, sub_c, task_c, n_lam, n_sub),
    each column array (P,)."""
    lam = grid.lambdas.to(torch.float32).cpu()
    n_lam = lam.shape[0]
    sub = torch.tensor(cfg.taus if cfg.solver in ("quantile", "expectile")
                       else cfg.weights, dtype=torch.float32)
    n_sub = sub.shape[0]
    lam_c = torch.repeat_interleave(lam, n_sub).repeat(n_tasks)
    sub_c = sub.repeat(n_lam * n_tasks)
    task_c = torch.repeat_interleave(torch.arange(n_tasks),
                                     n_lam * n_sub)
    return lam_c, sub_c, task_c, n_lam, n_sub


def _val_losses(f_val: torch.Tensor, y_cols: torch.Tensor,
                val_mask_cols: torch.Tensor, cfg: CVConfig,
                sub_c: torch.Tensor) -> torch.Tensor:
    """Masked mean validation loss per column: (..., n, P) -> (..., P)."""
    denom = torch.clamp(val_mask_cols.sum(dim=-2), min=1.0)
    if cfg.solver == "hinge":
        if cfg.val_loss in ("auto", "zero_one"):
            losses = ((f_val * y_cols) <= 0.0).to(torch.float32)
        else:
            losses = torch.clamp(1.0 - y_cols * f_val, min=0.0)
    elif cfg.solver == "ls":
        losses = (y_cols - f_val) ** 2
    elif cfg.solver == "quantile":
        losses = q_solver.pinball_loss(y_cols, f_val, sub_c)
    elif cfg.solver == "expectile":
        losses = exp_solver.expectile_loss(y_cols, f_val, sub_c)
    else:
        raise ValueError(cfg.solver)
    return (losses * val_mask_cols).sum(dim=-2) / denom


def _solve_columns(k_full: torch.Tensor, y_cols: torch.Tensor,
                   train_cols: torch.Tensor, lam_c: torch.Tensor,
                   sub_c: torch.Tensor, n_eff_cols: torch.Tensor,
                   cfg: CVConfig, c0: torch.Tensor,
                   l_est: Optional[torch.Tensor]):
    """One gamma step's solve for the whole wave.

    k_full (S, n, n); y_cols (S, 1, n, P); train_cols (S, F, n, P) (1 =
    in the column's training set); n_eff_cols (S, F, P); c0 (S, F, n, P);
    l_est (S,) per slot or (S, F) per fold; lam_c, sub_c (P,) shared by
    the slots, or (S, 1, P) per slot.  Returns ``(c, iters)``: c
    (S, F, n, P) and the box-QP iterations (S, F) (0 for the direct
    ls/expectile solves).  ``cfg.cd_polish > 0`` appends that many Gauss-Seidel epochs
    after the box QP, warm-started from its iterate (B4)."""
    s, f = train_cols.shape[:2]
    dev = k_full.device
    zero_iters = torch.zeros((s, f), dtype=torch.int64, device=k_full.device)
    if cfg.solver in ("hinge", "quantile"):
        cost = 1.0 / (2.0 * lam_c * torch.clamp(n_eff_cols, min=1.0))
        cost = cost[..., None, :]                                # (S,F,1,P)
        sub_n = sub_c[..., None, :]              # (1, P) or (S, 1, 1, P)
        if cfg.solver == "hinge":
            w = torch.where(y_cols > 0, sub_n, torch.ones_like(sub_n))
            edge = y_cols * cost * w * train_cols
            lo = torch.clamp(edge, max=0.0)
            hi = torch.clamp(edge, min=0.0)
        else:
            lo = cost * (sub_n - 1.0) * train_cols
            hi = cost * sub_n * train_cols
        y_eff = y_cols * train_cols
        with obs.tracer.span("train.fista", dev):
            res = qp.box_qp_batched(k_full, y_eff, lo, hi, c0=c0,
                                    tol=cfg.tol, max_iters=cfg.max_iters,
                                    l_est=l_est)
        c = res.c
        if cfg.cd_polish > 0:
            with obs.tracer.span("train.polish", dev):
                c = cd_ops.cd_polish(k_full, y_eff, lo, hi, c, cfg.cd_polish)
        return c, res.iters
    if cfg.solver == "ls":
        # every column shares its fold's train mask (task_mask == 1): one
        # eigh per (slot, fold), the lambda path a diagonal rescale
        tm = train_cols[..., 0]                                  # (S, F, n)
        lam_n = lam_c * torch.clamp(n_eff_cols, min=1.0)         # (S, F, P)
        y = (y_cols * train_cols[..., :1]).expand_as(train_cols)
        return (ls_solver.krr_eigh_path(k_full[:, None], y, lam_n, tm),
                zero_iters)
    if cfg.solver == "expectile":
        tm = train_cols[..., 0]
        k = k_full.to(torch.float32)[:, None]
        km = k * tm[..., :, None] * tm[..., None, :]
        y = y_cols[..., 0] * tm
        lam_n = lam_c * torch.clamp(n_eff_cols[..., :1], min=1.0)
        taus = sub_c.expand_as(lam_n)
        return exp_solver.irls_path(km, y, taus, lam_n, tm, c0), zero_iters
    raise ValueError(cfg.solver)


def _lipschitz(k_full: torch.Tensor, train_folds: torch.Tensor,
               cfg: CVConfig) -> torch.Tensor:
    """The FISTA step's L: (S,) from each slot's K (lambda_max(M K M) <=
    lambda_max(K) for a 0/1 mask M, so one L per slot is a valid step for
    every fold), or (S, F) from each fold's masked Gram
    (``shared_lipschitz=False``, the baseline)."""
    if cfg.shared_lipschitz:
        return qp.power_iteration_l(k_full)
    s, f, n = train_folds.shape
    mt = train_folds.to(torch.float32)
    km = k_full[:, None] * mt[..., :, None] * mt[..., None, :]   # (S,F,n,n)
    return qp.power_iteration_l(km.reshape(s * f, n, n)).reshape(s, f)


def cv_cell(x: torch.Tensor, y_tasks: torch.Tensor, task_mask: torch.Tensor,
            mask: torch.Tensor, gammas: torch.Tensor, lam_c: torch.Tensor,
            sub_c: torch.Tensor, task_c: torch.Tensor, fold_keys: np.ndarray,
            cfg: CVConfig, n_lam: int, n_sub: int) -> CVSelected:
    """Fused train + select CV over a wave of cells, all tasks at once.

    x (S, n, d); y_tasks, task_mask (S, T, n); mask (S, n); gammas (S, G)
    per-cell grids; lam_c, sub_c, task_c (P,) columns; fold_keys (S, 2)
    uint32.  The device is x's."""
    dev = x.device
    s, n, _ = x.shape
    n_tasks = y_tasks.shape[1]
    n_gamma = gammas.shape[1]
    f = cfg.n_folds
    lam_c, sub_c = lam_c.to(dev), sub_c.to(dev)
    task_c = task_c.to(dev)

    y_strat = y_tasks[:, 0] if cfg.solver == "hinge" else None
    val_folds = make_fold_masks(fold_keys, mask, f, cfg.fold_scheme, y_strat)
    train_folds = ~val_folds & (mask > 0)[:, None, :]             # (S, F, n)
    y_cols = y_tasks[:, task_c].transpose(1, 2)[:, None]          # (S,1,n,P)
    colmask = (task_mask[:, task_c].transpose(1, 2)
               * mask[:, :, None])[:, None]                       # (S,1,n,P)
    tr_cols = train_folds.to(torch.float32)[..., None] * colmask  # (S,F,n,P)
    va_cols = val_folds.to(torch.float32)[..., None] * colmask
    n_eff_cols = tr_cols.sum(dim=-2)                              # (S, F, P)

    spec = kernel_fns.get_spec(cfg.kernel)
    want_bf16 = cfg.gram_dtype == "bf16" and cfg.solver in ("hinge",
                                                            "quantile")
    gram_dtype = "bf16" if want_bf16 else "f32"
    track_rates = cfg.keep_surface and cfg.solver == "hinge"
    needs_l = cfg.solver in ("hinge", "quantile")
    cg = None
    if spec.factors_through_d2:
        with obs.tracer.span("train.d2", dev):
            cg = kernel_fns.CachedGram.build(x, name=cfg.kernel)

    p = lam_c.shape[0]
    best_val = torch.full((s, n_tasks, n_sub), torch.inf, device=dev)
    best_cfs = torch.zeros((s, f, n, n_tasks, n_sub), device=dev)
    best_g = torch.zeros((s, n_tasks, n_sub), device=dev)
    best_l = torch.zeros((s, n_tasks, n_sub), device=dev)
    c0_all = torch.zeros((s, f, n, p), device=dev)
    t_idx = torch.arange(n_tasks, device=dev)[:, None]
    s_idx = torch.arange(n_sub, device=dev)[None, :]
    vl_all, fa_all, det_all, it_all = [], [], [], []
    for gi in range(n_gamma):
        gamma = gammas[:, gi].to(dev)                               # (S,)
        with obs.tracer.span("train.epilogue", dev):
            if cg is not None:
                k_full = cg.gram(gamma[:, None].contiguous(), gram_dtype)[:, 0]
            else:
                # a user kernel registered without a D² epilogue
                k_full = kernel_fns.cast_out(spec.fn(x, x, gamma[:, None, None]),
                                             gram_dtype)
        l_est = None
        if needs_l:
            with obs.tracer.span("train.fista", dev):
                l_est = _lipschitz(k_full, train_folds, cfg)
        coefs, iters = _solve_columns(k_full, y_cols, tr_cols, lam_c,
                                      sub_c, n_eff_cols, cfg, c0_all, l_est)
        with obs.tracer.span("train.select", dev):
            f_val = cd_ops.slot_matmul(k_full.to(torch.float32), coefs)
            vl = _val_losses(f_val, y_cols, va_cols, cfg, sub_c)  # (S, F, P)
            if track_rates:
                pred_pos = (f_val > 0) & (va_cols > 0)
                fa = (pred_pos & (y_cols < 0)).to(torch.float32).sum(-2)
                det = (pred_pos & (y_cols > 0)).to(torch.float32).sum(-2)
            else:
                fa = det = torch.zeros_like(vl)
            # the fold mean as jnp.mean forms it (sum times 1/F): zero-one
            # losses tie, and a last-bit difference flips the argmin
            vl_tls = (vl.sum(dim=1) * (1.0 / f)).reshape(s, n_tasks, n_lam,
                                                        n_sub)
            # streaming selection: the first strict improvement wins, gamma
            # outer and lambda inner, as the reference's scan
            val_star = torch.amin(vl_tls, dim=2)                      # (S,T,S)
            lam_star = torch.argmin(vl_tls, dim=2)   # first minimum
            flat = (t_idx * n_lam + lam_star) * n_sub + s_idx         # (S,T,S)
            idx = flat.reshape(s, 1, 1, -1).expand(s, f, n, -1)
            cand = torch.gather(coefs, 3, idx).reshape(
                s, f, n, n_tasks, n_sub)
            improved = val_star < best_val
            best_val = torch.where(improved, val_star, best_val)
            best_cfs = torch.where(improved[:, None, None], cand, best_cfs)
            best_g = torch.where(improved, gamma[:, None, None], best_g)
            best_l = torch.where(improved, lam_c[flat], best_l)
            c0_all = coefs
            vl_all.append(vl_tls)
            fa_all.append(fa.sum(1).reshape(s, n_tasks, n_lam, n_sub))
            det_all.append(det.sum(1).reshape(s, n_tasks, n_lam, n_sub))
            it_all.append(iters)

    sub_grid = sub_c[:n_sub]
    if cfg.solver in ("quantile", "expectile"):
        tau = sub_grid[None, None, :].expand(s, n_tasks, n_sub)
        weight = torch.ones((s, n_tasks, n_sub), device=dev)
    else:
        tau = torch.full((s, n_tasks, n_sub), 0.5, device=dev)
        weight = sub_grid[None, None, :].expand(s, n_tasks, n_sub)
    return CVSelected(coefs=best_cfs, gamma=best_g, lam=best_l, tau=tau,
                      weight=weight, val_loss=best_val,
                      val_grid=torch.stack(vl_all, 1),
                      fa_grid=torch.stack(fa_all, 1),
                      det_grid=torch.stack(det_all, 1),
                      iters=torch.stack(it_all, 1))


def solve_columns_batched(x: torch.Tensor, y_tasks: torch.Tensor,
                          task_mask: torch.Tensor, mask: torch.Tensor,
                          gamma: torch.Tensor, lam_cols: torch.Tensor,
                          sub_cols: torch.Tensor, task_cols: torch.Tensor,
                          fold_keys: np.ndarray, c0: Optional[torch.Tensor],
                          cfg: CVConfig):
    """Targeted re-solve of given columns at one gamma per cell, all
    folds, for a group of cells in one batch: the select stage's "one
    targeted wave" for every moved cell that shares a gamma-grid index.

    x (C, n, d); y_tasks, task_mask (C, T, n); mask (C, n); gamma (C,);
    lam_cols, sub_cols, task_cols (C, P'); fold_keys (C, 2) uint32, each
    cell's training key, so the folds (and the models the surface scored)
    are the train stage's.  ``c0`` warm-starts the solve, box-clipped per
    column: (C, n, P') one start shared by every fold (the cached argmin
    model of the same column), or (C, F, n, P') per-fold starts (a
    previous solve's fold coefficients: the re-solve then collapses to a
    KKT check).  The Gram is the full kernel of each cell with itself (B1
    and its epilogue, one launch each for the group), not the train scan's
    symmetric D², as in the reference.

    Returns ``(fold-mean coefs (C, n, P'), box-QP iterations summed over
    the folds (C,), per-fold coefs (C, F, n, P'))``.
    """
    dev = x.device
    c, n, _ = x.shape
    f = cfg.n_folds
    p_cols = lam_cols.shape[1]
    y_strat = y_tasks[:, 0] if cfg.solver == "hinge" else None
    val_folds = make_fold_masks(fold_keys, mask, f, cfg.fold_scheme, y_strat)
    train_folds = ~val_folds & (mask > 0)[:, None, :]             # (C, F, n)
    tc = task_cols.to(device=dev, dtype=torch.int64)[:, :, None].expand(
        c, p_cols, n)
    y_cols = torch.gather(y_tasks, 1, tc).transpose(1, 2)[:, None]
    colmask = (torch.gather(task_mask, 1, tc).transpose(1, 2)
               * mask[:, :, None])[:, None]                       # (C,1,n,P')

    spec = kernel_fns.get_spec(cfg.kernel)
    k_full = spec.fn(x, x, gamma.to(device=dev, dtype=torch.float32))
    if cfg.gram_dtype == "bf16" and cfg.solver in ("hinge", "quantile"):
        k_full = k_full.to(torch.bfloat16)
    l_est = None
    if cfg.solver in ("hinge", "quantile"):
        l_est = _lipschitz(k_full, train_folds, cfg)
    if c0 is None:
        c0 = torch.zeros((c, f, n, p_cols), device=dev)
    elif c0.dim() == 3:
        # one shared start (the nearest cached grid column, solved at a
        # possibly different (gamma, lambda)) for every fold; the solver
        # clips it into each column's box
        c0 = c0.to(torch.float32)[:, None].expand(c, f, n, p_cols)
    else:
        c0 = c0.to(torch.float32)
    tr_cols = train_folds.to(torch.float32)[..., None] * colmask  # (C,F,n,P')
    n_eff_cols = tr_cols.sum(dim=-2)                              # (C, F, P')
    coefs, iters = _solve_columns(
        k_full, y_cols, tr_cols, lam_cols.to(dev, torch.float32)[:, None],
        sub_cols.to(dev, torch.float32)[:, None], n_eff_cols, cfg, c0, l_est)
    return coefs.sum(dim=1) * (1.0 / f), iters.sum(dim=1), coefs


def solve_columns_at(x: torch.Tensor, y_tasks: torch.Tensor,
                     task_mask: torch.Tensor, mask: torch.Tensor,
                     gamma, lam_cols: torch.Tensor, sub_cols: torch.Tensor,
                     task_cols: torch.Tensor, fold_key: np.ndarray,
                     cfg: CVConfig, c0: Optional[torch.Tensor] = None):
    """:func:`solve_columns_batched` for one cell: x (n, d), y_tasks,
    task_mask (T, n), mask (n,), a scalar gamma, (P',) columns, a (2,)
    key, c0 (n, P') or (F, n, P').  Returns ``(coefs (n, P'), iterations
    (), fold coefs (F, n, P'))``."""
    g = torch.as_tensor(gamma, dtype=torch.float32, device=x.device)
    mean, iters, folds = solve_columns_batched(
        x[None], y_tasks[None], task_mask[None], mask[None], g.reshape(1),
        lam_cols[None], sub_cols[None], task_cols[None],
        np.asarray(fold_key, np.uint32).reshape(1, 2),
        None if c0 is None else c0[None], cfg)
    return mean[0], iters[0], folds[0]


def resolve_group(x: np.ndarray, y_tasks: np.ndarray, task_mask: np.ndarray,
                  mask: np.ndarray, fold_keys: np.ndarray, gamma: np.ndarray,
                  cols: list, lam: np.ndarray, sub_grid: np.ndarray,
                  c0: np.ndarray, cfg: CVConfig, device: torch.device):
    """The re-solve's column layout, shared by the select stage and the
    drift refresh: re-solve the (task, sub) columns ``cols[i]`` ((m_i, 2)
    indices) of each cell i of a group at its gamma ``gamma[i]``, in one
    :func:`solve_columns_batched` call on ``device``.

    Each cell's columns are padded to T*S by repeating its first (one
    width whatever moved, so the iterations count the same work as the
    reference's) and warm-started from ``c0`` at the same (task, sub),
    box-clipped in the solver.  x (C, k, d); y_tasks, task_mask (C, T, k);
    mask (C, k); fold_keys (C, 2); gamma (C,); lam (C, T, S) every
    column's lambda; sub_grid (S,) the weights or taus; c0 (C, k, T, S).
    Returns ``(per cell its (k, m_i) new columns, box-QP iterations
    summed over cells and folds)``.
    """
    n_cols = lam.shape[1] * lam.shape[2]
    pads = [np.concatenate([ts, np.repeat(ts[:1], n_cols - len(ts), axis=0)])
            for ts in cols]
    lam_b = np.stack([lam[i][p[:, 0], p[:, 1]] for i, p in enumerate(pads)])
    c0_b = np.stack([c0[i][:, p[:, 0], p[:, 1]] for i, p in enumerate(pads)])

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32)).to(device)

    with runtime.full_fp32():
        out, iters, _ = solve_columns_batched(
            f32(x), f32(y_tasks), f32(task_mask), f32(mask), f32(gamma),
            f32(lam_b), f32(np.stack([sub_grid[p[:, 1]] for p in pads])),
            torch.as_tensor(np.stack([p[:, 0] for p in pads])).to(device),
            np.asarray(fold_keys), f32(c0_b), cfg)
        out = out.cpu().numpy()                            # (C, k, T*S)
    return [out[i, :, :len(ts)] for i, ts in enumerate(cols)], \
        int(iters.sum())
