"""LM training loop: train step with gradient accumulation, checkpoint
every N steps, and resume, on one device or sharded over a mesh (the JAX
package's ``train/lm_trainer.py``).

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
the gather's backward accumulate with atomics otherwise).

Sharded (``Trainer(mesh=...)``): the parameters are DTensors placed by
the templates' partition specs (``layers.sharding_tree``, or
``param_shardings``), drawn in full from the seed and then split, so
they are the unsharded run's; the optimizer state takes their
placements; each rank feeds its rows of the batch (``Shard(0)`` over the
config's ``batch_axes``); the model runs on DTensors (``models.model``:
``_constrain`` at the layer boundaries); each gradient is reduced to its
parameter's placements; checkpoints hold the full arrays in the
reference's format and restore into any mesh (the elastic re-shard).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional, Union

import torch

from repro_torch.kernels import runtime
from repro_torch.launch.mesh import is_dtensor
from repro_torch.models import layers
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
    with torch.enable_grad(), layers.mesh_context(batch["inputs"]):
        loss = model_mod.loss_fn(cfg, tree_from_items(zip(paths, leaves)),
                                 batch)
        grads = torch.autograd.grad(loss, leaves)
    # a sharded gradient comes out partial or in another layout: it takes
    # its parameter's placements (the sum over the ranks happens here)
    grads = [g.redistribute(p.device_mesh, p.placements)
             if is_dtensor(g) else g for g, p in zip(grads, leaves)]
    return loss.detach(), tree_from_items(zip(paths, grads))


def _micro(v: torch.Tensor, accum: int, i: int) -> torch.Tensor:
    """Micro-batch ``i`` of ``accum`` along the leading dim.  A sharded
    batch is cut on each rank's own rows (``Trainer`` lays the rows out
    so that these are the global micro-batch's: :func:`micro_layout`)."""
    if not is_dtensor(v):
        return v.reshape((accum, v.shape[0] // accum) + tuple(v.shape[1:]))[i]
    from torch.distributed.tensor import DTensor
    loc = v.to_local()
    loc = loc.reshape((accum, loc.shape[0] // accum) + tuple(loc.shape[1:]))
    return DTensor.from_local(loc[i], v.device_mesh, v.placements,
                              run_check=False)


def micro_layout(n_rows: int, accum: int, n_shards: int) -> torch.Tensor:
    """Row order of a batch split over ``n_shards`` ranks such that each
    rank's block, cut in ``accum`` pieces, holds its share of the global
    micro-batches in order: block r = micro 0's r-th share, micro 1's r-th
    share, ..."""
    if n_rows % (accum * n_shards):
        raise ValueError(f"a batch of {n_rows} rows does not split into "
                         f"{accum} micro-batches over {n_shards} ranks")
    mb, share = n_rows // accum, n_rows // accum // n_shards
    return torch.tensor([i * mb + r * share + j for r in range(n_shards)
                         for i in range(accum) for j in range(share)])


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
            gsum = tree_map(lambda p: torch.zeros_like(
                p, dtype=torch.float32, memory_format=torch.contiguous_format),
                params)
            lsum = None
            for i in range(grad_accum):
                l, g = value_and_grad(model_cfg, params, {
                    k: _micro(v, grad_accum, i) for k, v in batch.items()})
                gsum = tree_map(torch.add, gsum, g)
                lsum = l if lsum is None else lsum + l
            grads = tree_map(lambda g, p: (g / grad_accum).to(p.dtype),
                             gsum, params)
            loss = lsum / grad_accum
        new_params, new_opt, metrics = adamw_step(grads, opt_state, opt_cfg)
        metrics["loss"] = loss
        return new_params, new_opt, metrics

    return step


def _scalar(x) -> float:
    return float(x.full_tensor() if is_dtensor(x) else x)


class Trainer:
    """Host-side loop with fault tolerance (``device=None`` is the current
    card, or the rank's, and raises without one; ``"cpu"`` runs the plain
    path).  ``mesh`` (a ``DeviceMesh`` over every rank) shards the run:
    ``param_shardings`` is a tree of placements congruent with the
    parameters (default: ``layers.sharding_tree`` of the config's
    template), and the batch splits over the config's ``batch_axes``."""

    def __init__(self, model_cfg: ModelConfig, opt_cfg: OptConfig,
                 loop_cfg: TrainLoopConfig, pipeline,
                 param_shardings=None, mesh=None,
                 device: Union[None, str, torch.device] = None):
        if param_shardings is not None and mesh is None:
            raise ValueError("Trainer: param_shardings are placements on a "
                             "mesh; pass the mesh too")
        self.model_cfg = model_cfg
        self.opt_cfg = opt_cfg
        self.loop_cfg = loop_cfg
        self.pipeline = pipeline
        self.device = runtime.resolve_device(device)
        self.mesh = mesh
        if mesh is not None:
            if mesh.device_type != self.device.type:
                raise ValueError(f"a {mesh.device_type} mesh for a run on "
                                 f"{self.device}")
            if param_shardings is None:
                param_shardings = layers.sharding_tree(
                    model_mod.build_template(model_cfg), mesh)
        self.param_shardings = param_shardings
        self._step_fn = make_train_step(model_cfg, opt_cfg,
                                        loop_cfg.grad_accum)

    def init_state(self, seed: int = 0):
        """Parameters from ``seed`` (drawn in full on the device, then
        split per ``param_shardings`` with no communication: every rank
        draws the same) and a fresh optimizer state."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        params = model_mod.init_params(self.model_cfg, gen)
        if self.mesh is not None:
            from torch.distributed.tensor import distribute_tensor
            params = tree_map(lambda p, pl: distribute_tensor(
                p, self.mesh, pl, src_data_rank=None), params,
                self.param_shardings)
        return params, init_opt_state(params, self.opt_cfg)

    def restore_or_init(self, seed: int = 0):
        """Fresh state from ``seed``, or the newest complete checkpoint's,
        copied into the fresh tensors in place (on one device no second
        copy of the state stays on it).  Sharded, each rank reads the full
        arrays and keeps its shard of each, whatever mesh wrote them."""
        lc = self.loop_cfg
        params, opt = self.init_state(seed)
        start = 0
        if lc.ckpt_dir and ckpt_mod.latest_step(lc.ckpt_dir) is not None:
            target = (params, opt)
            stored, start, _ = ckpt_mod.restore_checkpoint(lc.ckpt_dir,
                                                           target)
            for dst, src in zip(ckpt_mod.tree_leaves(target),
                                ckpt_mod.tree_leaves(stored)):
                dst.copy_(src if is_dtensor(src)
                          else torch.as_tensor(src))
        return params, opt, start

    def _batch(self, step: int) -> Dict[str, torch.Tensor]:
        batch = self.pipeline.batch(step)
        if self.mesh is None:
            return {k: v.to(self.device) for k, v in batch.items()}
        from torch.distributed.tensor import distribute_tensor
        from repro_torch.launch import mesh as mesh_mod
        axes = self.model_cfg.batch_axes
        pl = layers.placements((axes,) if axes else (), self.mesh)
        accum = self.loop_cfg.grad_accum
        if accum > 1:
            order = micro_layout(next(iter(batch.values())).shape[0], accum,
                                 mesh_mod.mesh_size(self.mesh, axes))
            batch = {k: v[order] for k, v in batch.items()}
        return {k: distribute_tensor(v.to(self.device), self.mesh, pl,
                                     src_data_rank=None)
                for k, v in batch.items()}

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
                                "loss": _scalar(metrics["loss"]),
                                "grad_norm": _scalar(metrics["grad_norm"]),
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
