"""Batched box-constrained QP engine (the JAX package's
``core/solvers/base.py``).

Every non-smooth liquidSVM dual (hinge, weighted hinge, pinball) is

    min_c   0.5 c^T K c  -  c^T y      s.t.   lo <= c <= hi      (coordinatewise)

in coefficient space; lambda and the weights only move the box, so the
whole hyper-parameter grid is solved as columns of one iteration, one GEMM
``K @ C`` per step.  The iteration is FISTA with gradient-based adaptive
restart, step 1/L with L from a power iteration, stopped by the scaled
projected-gradient (KKT) residual checked every ``check_every`` steps.

Batched layout: ``k`` (S, n, n) per slot; ``y``, ``lo``, ``hi``, ``c0``
(S, F, n, P): F problems per slot (the CV folds) share their slot's Gram,
which is never copied per problem.  Where the reference vmaps its
``while_loop`` over folds and slots, each (slot, fold) here keeps its own
``t``, restart test (one scalar over the whole (n, P) iterate), iteration
count and stopping state: a finished problem is frozen, not run on to the
slowest one.  The K products are ``torch`` matmuls (cuBLAS on the card, in
full fp32), as the reference leaves them to XLA.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core import prng
from repro_torch.kernels.cd_solver.ops import slot_matmul


class BoxQPResult(NamedTuple):
    c: torch.Tensor        # (S, F, n, P) solution ((n, P) for box_qp)
    kkt: torch.Tensor      # (S, F, P) final KKT residual per column
    iters: torch.Tensor    # (S, F) iterations used per problem
    l_est: torch.Tensor    # (S,) or (S, F) Lipschitz estimate


def kdot(k: torch.Tensor, c: torch.Tensor, bf16_cols: bool = False
         ) -> torch.Tensor:
    """K @ C with f32 output.  k (S, n, n); c (S, F, n, P) or (S, n, P).

    A bf16 Gram reads bf16-rounded columns and accumulates in f32, as the
    reference's ``_kdot``: both operands are widened exactly to f32, so
    the f32 product of the bf16 values is what the matmul sees (a bf16
    ``torch.matmul`` would round its output to bf16).  Callers that widen
    a bf16 K once pass the f32 copy with ``bf16_cols=True``."""
    if k.dtype == torch.bfloat16:
        k, bf16_cols = k.to(torch.float32), True
    if bf16_cols:
        c = c.to(torch.bfloat16).to(torch.float32)
    if c.dim() == 4:
        return slot_matmul(k, c)
    return torch.bmm(k, c)


def _widen(k: torch.Tensor):
    """(f32 Gram, whether its columns read bf16-rounded) for a K in any
    float dtype, widened once per solve."""
    if k.dtype == torch.bfloat16:
        return k.to(torch.float32), True
    return k.to(torch.float32), False


def power_iteration_l(k: torch.Tensor, iters: int = 32, seed: int = 0
                      ) -> torch.Tensor:
    """Largest eigenvalue of each slot's PSD K, times 1.05: (S, n, n) ->
    (S,), or (n, n) -> ().  The start vector is the reference's
    ``jax.random.normal(PRNGKey(seed), (n,))``."""
    single = k.dim() == 2
    kb, bf16 = _widen(k[None] if single else k)
    n = kb.shape[-1]
    v0 = torch.from_numpy(prng.normal(prng.PRNGKey(seed), n)).to(kb.device)
    v = v0.expand(kb.shape[0], n)[..., None]                  # (S, n, 1)
    for _ in range(iters):
        w = kdot(kb, v, bf16)
        v = w / torch.clamp(torch.linalg.vector_norm(w, dim=(-2, -1),
                                                     keepdim=True),
                            min=1e-30)
    lam = (v * kdot(kb, v, bf16)).sum(dim=(-2, -1))
    out = torch.clamp(lam, min=1e-12) * 1.05
    return out[0] if single else out


def kkt_residual(c: torch.Tensor, g: torch.Tensor, lo: torch.Tensor,
                 hi: torch.Tensor) -> torch.Tensor:
    """Projected-gradient residual per column, scaled by the box width:
    (..., n, P) -> (..., P)."""
    r = c - torch.clamp(c - g, min=lo, max=hi)
    width = torch.clamp((hi - lo).amax(dim=-2), min=1e-30)
    return r.abs().amax(dim=-2) / width


def clip_warm_start(c0: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor
                    ) -> torch.Tensor:
    """Project a warm start into a column's feasible box (from a feasible
    start the FISTA and Gauss-Seidel descents are monotone)."""
    return torch.clamp(c0, min=lo, max=hi)


def box_qp_batched(k: torch.Tensor, y: torch.Tensor, lo: torch.Tensor,
                   hi: torch.Tensor, c0: Optional[torch.Tensor] = None,
                   tol: float = 1e-3, max_iters: int = 2000,
                   l_est: Optional[torch.Tensor] = None,
                   check_every: int = 10) -> BoxQPResult:
    """Solve every (slot, problem, column) at once.

    k (S, n, n) f32 or bf16; y, lo, hi, c0 (S, F, n, P); l_est (S,) per
    slot or (S, F) per problem.  The
    loop runs while any problem is active; all active problems share the
    iteration count, so the KKT check falls on the same step for all of
    them and a problem whose residual is within ``tol`` is frozen from then
    on, exactly as under the reference's vmapped ``while_loop``.
    """
    f32 = torch.float32
    if l_est is None:
        l_est = power_iteration_l(k)
    k, bf16 = _widen(k)
    y, lo, hi = (t.to(f32) for t in (y, lo, hi))
    c0 = torch.zeros_like(y) if c0 is None else c0.to(f32)
    c0 = clip_warm_start(c0, lo, hi)
    s, f = y.shape[:2]
    l_est = l_est.to(f32)
    step = (1.0 / l_est).reshape(s, -1, 1, 1)         # (S, 1 or F, 1, 1)

    def grad(c):
        return kdot(k, c, bf16) - y

    c, z = c0, c0
    t = torch.ones((s, f), dtype=f32, device=y.device)
    iters = torch.zeros((s, f), dtype=torch.int64, device=y.device)
    active = torch.ones((s, f), dtype=torch.bool, device=y.device)
    for it in range(max_iters):
        g = grad(z)
        c_new = torch.clamp(z - step * g, min=lo, max=hi)
        restart = (g * (c_new - c)).sum(dim=(-2, -1)) > 0.0       # (S, F)
        t_new = torch.where(restart, torch.ones_like(t),
                            0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * t * t)))
        beta = torch.where(restart, torch.zeros_like(t), (t - 1.0) / t_new)
        z_new = c_new + beta[..., None, None] * (c_new - c)
        a4 = active[..., None, None]
        c = torch.where(a4, c_new, c)
        z = torch.where(a4, z_new, z)
        t = torch.where(active, t_new, t)
        iters = iters + active.to(torch.int64)
        if (it + 1) % check_every == 0:
            res = kkt_residual(c, grad(c), lo, hi)                 # (S, F, P)
            active = active & (res.amax(dim=-1) > tol)
            if not bool(active.any()):
                break
    final = kkt_residual(c, grad(c), lo, hi)
    return BoxQPResult(c=c, kkt=final, iters=iters, l_est=l_est)


def box_qp(k_mat: torch.Tensor, y: torch.Tensor, lo: torch.Tensor,
           hi: torch.Tensor, c0: Optional[torch.Tensor] = None,
           tol: float = 1e-3, max_iters: int = 2000,
           l_est: Optional[torch.Tensor] = None, check_every: int = 10
           ) -> BoxQPResult:
    """One problem, the reference's signature: k_mat (n, n); y (n,) or
    (n, P); lo, hi broadcastable to (n, P); c0 (n, P).  Returns c (n, P),
    kkt (P,), iters () and l_est ()."""
    if y.dim() == 1:
        y = y[:, None]
    n = k_mat.shape[0]
    p = max(y.shape[1], lo.shape[1] if lo.dim() == 2 else 1,
            hi.shape[1] if hi.dim() == 2 else 1)
    shape = (n, p)
    cols = [t.to(torch.float32).expand(shape)[None, None]
            for t in (y, lo, hi)]
    c0b = None if c0 is None else c0.to(torch.float32).expand(shape)[None,
                                                                   None]
    l_b = None if l_est is None else torch.as_tensor(l_est).reshape(1)
    res = box_qp_batched(k_mat[None], *cols, c0=c0b, tol=tol,
                         max_iters=max_iters, l_est=l_b,
                         check_every=check_every)
    return BoxQPResult(c=res.c[0, 0], kkt=res.kkt[0, 0],
                       iters=res.iters[0, 0], l_est=res.l_est[0])


def dual_objective(k_mat: torch.Tensor, y: torch.Tensor, c: torch.Tensor
                   ) -> torch.Tensor:
    """-(0.5 c^T K c - c^T y) per column."""
    if y.dim() == 1:
        y = y[:, None]
    kc = k_mat @ c
    return (c * y).sum(0) - 0.5 * (c * kc).sum(0)
