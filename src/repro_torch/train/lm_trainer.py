"""LM training loop on one device: train step with gradient accumulation,
checkpoint every N steps, and resume (the JAX package's
``train/lm_trainer.py``).

  * ``make_train_step`` builds ``(params, opt_state, batch) -> (params,
    opt_state, metrics)``: the loss and its gradients through autograd
    (``models.model.loss_fn``: attention on the plain blocked executor,
    never the kernels), averaged over ``grad_accum`` micro-batches, then
    one ``adamw_step``;
  * ``Trainer`` checkpoints ``(params, OptState)`` every ``ckpt_every``
    steps through ``train.checkpoint`` (the reference's on-disk format,
    so either package resumes the other's run) and replays the data by
    step (``batch = f(seed, step)``), so a run killed anywhere resumes
    from its last checkpoint to the same parameters.

On the card a resumed run equals the uninterrupted one bitwise when
``torch.use_deterministic_algorithms(True)`` is on (the embedding's and
the gather's backward accumulate with atomics otherwise).  One device
only: ``mesh`` and ``param_shardings`` raise (several cards wait).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional, Union

import torch

from repro_torch.kernels import runtime
from repro_torch.models import model as model_mod
from repro_torch.models.layers import tree_from_items, tree_items, tree_map
from repro_torch.models.model import ModelConfig
from repro_torch.train import checkpoint as ckpt_mod
from repro_torch.train.optimizer import (OptConfig, OptState, adamw_step,
                                         init_opt_state)


@dataclasses.dataclass(frozen=True)
class TrainLoopConfig:
    total_steps: int = 100
    grad_accum: int = 1
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None
    keep_last: int = 3
    log_every: int = 10


def value_and_grad(cfg: ModelConfig, params, batch: Dict[str, torch.Tensor]):
    """(loss, grads): the loss at ``params`` and its gradient tree, each
    leaf in its parameter's dtype."""
    paths = [p for p, _ in tree_items(params)]
    leaves = [leaf.detach().requires_grad_(True)
              for _, leaf in tree_items(params)]
    with torch.enable_grad():
        loss = model_mod.loss_fn(cfg, tree_from_items(zip(paths, leaves)),
                                 batch)
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), tree_from_items(zip(paths, grads))


def make_train_step(model_cfg: ModelConfig, opt_cfg: OptConfig,
                    grad_accum: int = 1) -> Callable:
    """``(params, opt_state, batch) -> (params, opt_state, metrics)``.

    With ``grad_accum > 1`` the batch's leading dim is (accum x
    micro_batch); the micro-batches run one after the other and their
    gradients are summed in f32 and averaged."""

    def step(params, opt_state: OptState, batch: Dict[str, torch.Tensor]):
        if grad_accum == 1:
            loss, grads = value_and_grad(model_cfg, params, batch)
        else:
            micro = {k: v.reshape((grad_accum, v.shape[0] // grad_accum)
                                  + tuple(v.shape[1:]))
                     for k, v in batch.items()}
            gsum = tree_map(lambda p: torch.zeros(p.shape,
                                                  dtype=torch.float32,
                                                  device=p.device), params)
            lsum = None
            for i in range(grad_accum):
                l, g = value_and_grad(model_cfg, params,
                                      {k: v[i] for k, v in micro.items()})
                gsum = tree_map(torch.add, gsum, g)
                lsum = l if lsum is None else lsum + l
            grads = tree_map(lambda g, p: (g / grad_accum).to(p.dtype),
                             gsum, params)
            loss = lsum / grad_accum
        new_params, new_opt, metrics = adamw_step(grads, opt_state, opt_cfg)
        metrics["loss"] = loss
        return new_params, new_opt, metrics

    return step


class Trainer:
    """Host-side loop with fault tolerance, on one device (``device=None``
    is the current card and raises without one; ``"cpu"`` runs the plain
    path)."""

    def __init__(self, model_cfg: ModelConfig, opt_cfg: OptConfig,
                 loop_cfg: TrainLoopConfig, pipeline,
                 param_shardings=None, mesh=None,
                 device: Union[None, str, torch.device] = None):
        if mesh is not None or param_shardings is not None:
            raise NotImplementedError(
                "Trainer: mesh / param_shardings are not ported: the port "
                "trains on one device (several cards wait, ROADMAP A4)")
        self.model_cfg = model_cfg
        self.opt_cfg = opt_cfg
        self.loop_cfg = loop_cfg
        self.pipeline = pipeline
        self.device = runtime.resolve_device(device)
        self._step_fn = make_train_step(model_cfg, opt_cfg,
                                        loop_cfg.grad_accum)

    def init_state(self, seed: int = 0):
        gen = torch.Generator(device=self.device).manual_seed(seed)
        params = model_mod.init_params(self.model_cfg, gen)
        return params, init_opt_state(params, self.opt_cfg)

    def restore_or_init(self, seed: int = 0):
        """Fresh state from ``seed``, or the newest complete checkpoint's
        (copied into the fresh tensors in place: no second copy of the
        state on the device)."""
        lc = self.loop_cfg
        params, opt = self.init_state(seed)
        start = 0
        if lc.ckpt_dir and ckpt_mod.latest_step(lc.ckpt_dir) is not None:
            target = (params, opt)
            stored, start, _ = ckpt_mod.restore_checkpoint(lc.ckpt_dir,
                                                           target)
            for dst, src in zip(ckpt_mod.tree_leaves(target),
                                ckpt_mod.tree_leaves(stored)):
                dst.copy_(torch.as_tensor(src))
        return params, opt, start

    def _batch(self, step: int) -> Dict[str, torch.Tensor]:
        return {k: v.to(self.device)
                for k, v in self.pipeline.batch(step).items()}

    def run(self, seed: int = 0, fail_at: Optional[int] = None
            ) -> Dict[str, Any]:
        """Train to ``total_steps``; ``fail_at`` raises before that step
        runs (a kill, for the restart path).  ``history`` holds, every
        ``log_every`` steps and at the last, the step's loss, gradient
        norm and learning rate, and the seconds since the run began."""
        lc = self.loop_cfg
        params, opt, start = self.restore_or_init(seed)
        history = []
        t0 = time.perf_counter()
        saved = None
        for step in range(start, lc.total_steps):
            if fail_at is not None and step == fail_at:
                raise RuntimeError(f"injected failure at step {step}")
            params, opt, metrics = self._step_fn(params, opt,
                                                 self._batch(step))
            if step % lc.log_every == 0 or step == lc.total_steps - 1:
                history.append({"step": step,
                                "loss": float(metrics["loss"]),
                                "grad_norm": float(metrics["grad_norm"]),
                                "lr": float(metrics["lr"]),
                                "elapsed_s": time.perf_counter() - t0})
            if lc.ckpt_dir and (step + 1) % lc.ckpt_every == 0:
                ckpt_mod.save_checkpoint(lc.ckpt_dir, step + 1, (params, opt),
                                         keep_last=lc.keep_last)
                saved = step + 1
        if lc.ckpt_dir and saved != lc.total_steps:
            ckpt_mod.save_checkpoint(lc.ckpt_dir, lc.total_steps,
                                     (params, opt), keep_last=lc.keep_last)
        return {"params": params, "opt": opt, "history": history,
                "wall_s": time.perf_counter() - t0}
