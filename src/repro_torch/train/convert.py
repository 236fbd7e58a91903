"""Take over a selection made by the JAX package.

A ``SelectResult`` is plain arrays plus a config, so state passes between
the two packages exactly: the reference's cell models (``x_cells``,
``mask_cells``, ``coefs``, ``gamma``, ``lam``, ``tau``, ``val_loss``), its
routing state (the plan's ``centers``, ``packed.order``), its scaler and
its task combiner (``classes``, ``pairs``) in, the port's
``SelectResult`` out.  Both packages can then be held to the same
decisions on one model.
"""
from __future__ import annotations

from typing import Dict, Union

import numpy as np
import torch

from repro_torch.api.session import SelectResult, _cfg_from_json
from repro_torch.cells.builder import CellPlan
from repro_torch.core import cv as cv_mod
from repro_torch.data.scaling import Scaler
from repro_torch.distributed.planner import PackedCells
from repro_torch.kernels import runtime
from repro_torch.tasks.builder import TaskSet
from repro_torch.train.svm_trainer import SVMTrainerConfig

ARRAYS = ("x_cells", "mask_cells", "coefs", "gamma", "lam", "tau",
          "val_loss", "centers", "order", "scaler_mean", "scaler_std",
          "classes", "pairs")


def select_result_from_reference(
        arrays: Dict[str, np.ndarray], meta: dict,
        device: Union[None, str, torch.device] = None) -> SelectResult:
    """``arrays``: the fields named in :data:`ARRAYS`, numpy.  ``meta``:
    ``config`` (the reference's ``SVMTrainerConfig`` as a dict), and
    optionally ``cv_cfg`` (its ``CVConfig`` as a dict) and ``rule``."""
    missing = [k for k in ARRAYS if k not in arrays]
    if missing:
        raise ValueError(f"select_result_from_reference: missing arrays "
                         f"{missing}")
    config = _cfg_from_json(SVMTrainerConfig, meta["config"])
    cv_cfg = _cfg_from_json(cv_mod.CVConfig, meta.get("cv_cfg", {}))
    order = np.asarray(arrays["order"], np.int64)
    centers = np.asarray(arrays["centers"], np.float32)
    slot_of = np.full(centers.shape[0], -1, np.int64)
    for s, cid in enumerate(order):
        if cid >= 0:
            slot_of[cid] = s
    plan = CellPlan(indices=np.zeros((centers.shape[0], 0), np.int32),
                    mask=np.zeros((centers.shape[0], 0), np.float32),
                    owner=np.zeros(0, np.int32), centers=centers,
                    coarse_of=np.zeros(centers.shape[0], np.int32))
    packed = PackedCells(order=order, slot_of_cell=slot_of, n_devices=1,
                         slots_per_device=order.shape[0])
    tasks = TaskSet(kind=config.scenario, labels=np.zeros((0, 0), np.float32),
                    task_mask=np.zeros((0, 0), np.float32),
                    classes=np.asarray(arrays["classes"]),
                    pairs=np.asarray(arrays["pairs"], np.int32),
                    taus=np.asarray(config.taus, np.float32),
                    weights=np.asarray(config.weights, np.float32))
    scaler = Scaler(mean=np.asarray(arrays["scaler_mean"], np.float32),
                    std=np.asarray(arrays["scaler_std"], np.float32))
    f32 = {k: np.asarray(arrays[k], np.float32)
           for k in ("x_cells", "mask_cells", "coefs", "gamma", "lam", "tau",
                     "val_loss")}
    return SelectResult(rule=meta.get("rule", "argmin"), config=config,
                        cv_cfg=cv_cfg, scaler=scaler, plan=plan,
                        packed=packed, tasks=tasks,
                        device=runtime.resolve_device(device), **f32)
