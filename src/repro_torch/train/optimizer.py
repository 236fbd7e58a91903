"""AdamW with dtype policies and learning-rate schedules (the JAX
package's ``train/optimizer.py``).

Policies:
  "fp32"      — fp32 master copy + fp32 moments (the default)
  "bf16_mom"  — fp32 master + bf16 moments
  "pure_bf16" — bf16 master + bf16 moments; the update math still runs
                in f32.

Trees are the model's nested dicts of tensors (DTensors when sharded:
the master copy and the moments take their parameter's placements, and
the global gradient norm sums every rank's shards).  The optimizer state
is a tree congruent with the parameters and lives on their device; its step
counter is a 0-d int32 CPU tensor, so the schedule and the bias
corrections are computed on the host in f32 (as the reference computes
them) and no step waits on the card.  ``OptState`` checkpoints in the
reference's layout (``train.checkpoint``: ``.step``, ``.master/...``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch.models.layers import tree_items, tree_map

_POLICIES = {
    "fp32": (torch.float32, torch.float32),
    "bf16_mom": (torch.float32, torch.bfloat16),
    "pure_bf16": (torch.bfloat16, torch.bfloat16),
}


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    policy: str = "fp32"
    warmup_steps: int = 100
    total_steps: int = 10000
    schedule: str = "cosine"     # cosine | linear | constant
    min_lr_frac: float = 0.1


class OptState(NamedTuple):
    step: torch.Tensor   # () int32, on the CPU
    master: Any          # params in the master dtype
    m: Any
    v: Any


def init_opt_state(params, cfg: OptConfig) -> OptState:
    mdt, sdt = _POLICIES[cfg.policy]
    return OptState(
        step=torch.zeros((), dtype=torch.int32),
        master=tree_map(lambda p: p.detach().to(mdt, copy=True), params),
        m=tree_map(lambda p: _zeros_like(p, sdt), params),
        v=tree_map(lambda p: _zeros_like(p, sdt), params),
    )


def _zeros_like(p: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Dense zeros of ``p``'s shape on its device; a DTensor's keep its
    placements."""
    return torch.zeros_like(p, dtype=dtype,
                            memory_format=torch.contiguous_format)


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def schedule_lr(cfg: OptConfig, step) -> torch.Tensor:
    """The learning rate at ``step``, a 0-d f32 tensor (f32 math)."""
    s = _f32(step)
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    if cfg.schedule == "constant":
        decay = _f32(1.0)
    else:
        frac = torch.clamp((s - cfg.warmup_steps)
                           / max(cfg.total_steps - cfg.warmup_steps, 1),
                           0.0, 1.0)
        if cfg.schedule == "cosine":
            decay = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
                1.0 + torch.cos(math.pi * frac))
        else:
            decay = 1.0 - (1 - cfg.min_lr_frac) * frac
    return cfg.lr * warm * decay


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32, the leaves summed
    one after the other in the reference's order."""
    total = None
    for _, leaf in tree_items(tree):
        sq = torch.sum(torch.square(leaf.float()))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def adamw_step(grads, state: OptState, cfg: OptConfig
               ) -> Tuple[Any, OptState, Dict[str, torch.Tensor]]:
    """Returns (new compute-dtype params, new state, metrics)."""
    step = state.step + 1
    lr = float(schedule_lr(cfg, step))
    gnorm = global_norm(grads)
    scale = (torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12),
                         max=1.0)
             if cfg.grad_clip > 0 else torch.ones_like(gnorm))

    b1, b2 = cfg.beta1, cfg.beta2
    bc1 = float(1.0 - _f32(b1) ** step.float())
    bc2 = float(1.0 - _f32(b2) ** step.float())

    def upd(g, mast, m, v):
        gf = g.float() * scale
        mf = m.float() * b1 + (1 - b1) * gf
        vf = v.float() * b2 + (1 - b2) * gf * gf
        u = (mf / bc1) / (torch.sqrt(vf / bc2) + cfg.eps)
        wd = cfg.weight_decay if mast.dim() >= 2 else 0.0  # no decay on norms
        mf32 = mast.float()
        new_master = mf32 - lr * (u + wd * mf32)
        return new_master.to(mast.dtype), mf.to(m.dtype), vf.to(v.dtype)

    new = tree_map(upd, grads, state.master, state.m, state.v)
    master, m, v = (tree_map(lambda t, i=i: t[i], new) for i in range(3))
    new_state = OptState(step=step, master=master, m=m, v=v)
    # compute-dtype params come from the master copy
    compute = tree_map(lambda ma, g: ma.to(g.dtype), master, grads)
    metrics = {"lr": lr, "grad_norm": gnorm, "clip_scale": scale}
    return compute, new_state, metrics
