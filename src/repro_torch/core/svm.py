"""Single-working-set SVM: the train / select / test cycle for one
(possibly multi-task) working set (the JAX package's ``core/svm.py``)."""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import cv as cv_mod
from repro_torch.core import grids, kernel_fns, prng, select
from repro_torch.kernels.kernel_matrix import ops as km_ops
from repro_torch.tasks.builder import combine_decisions


class TrainedSVM(NamedTuple):
    """Everything the test phase needs.  coefs (n, T, S); per-(task, sub)
    hyper-parameters (T, S)."""
    sv_x: torch.Tensor
    sv_mask: torch.Tensor
    coefs: torch.Tensor
    gamma: torch.Tensor
    lam: torch.Tensor
    tau: torch.Tensor
    val_loss: torch.Tensor
    kernel: str = "gauss_rbf"

    def decision_function(self, x_test) -> torch.Tensor:
        """(m, d) -> (m, T, S): one cross D² (B1), the per-(task, sub)
        epilogues in one launch (B2), one batched product."""
        xt = torch.as_tensor(np.asarray(x_test, np.float32)).to(
            self.sv_x.device)
        t, s = self.gamma.shape
        coefs = self.coefs.reshape(self.coefs.shape[0], t * s)   # (n, P)
        spec = kernel_fns.get_spec(self.kernel)
        if spec.factors_through_d2:
            d2 = km_ops.sq_dists(xt, self.sv_x)
            k = spec.d2_epilogue(d2[None], self.gamma.reshape(1, -1),
                                 "f32")[0]                        # (P, m, n)
        else:
            k = torch.stack([spec.fn(xt, self.sv_x, float(g))
                             for g in self.gamma.reshape(-1)])
        out = torch.matmul(k, coefs.T[:, :, None])[..., 0]       # (P, m)
        return out.T.reshape(xt.shape[0], t, s)

    def predict_label(self, x_test, scenario: str = "binary",
                      classes: Optional[np.ndarray] = None,
                      pairs: Optional[np.ndarray] = None,
                      sub: int = 0) -> np.ndarray:
        return combine_decisions(self.decision_function(x_test).cpu().numpy(),
                                 scenario, classes=classes, pairs=pairs,
                                 sub=sub)


def train_select(x, y=None, mask=None, cfg: cv_mod.CVConfig = cv_mod.CVConfig(),
                 grid: Optional[grids.GridSpec] = None, y_tasks=None,
                 task_mask=None, seed: int = 0,
                 device: Optional[torch.device] = None) -> TrainedSVM:
    """Train + select on one working set (a wave of one slot).  Single
    task by default (``y``); pass ``y_tasks`` / ``task_mask`` (T, n) for
    OvA/AvA working sets."""
    from repro_torch.kernels import runtime
    dev = runtime.resolve_device(device)
    x = torch.as_tensor(np.asarray(x, np.float32)).to(dev)
    n, d = x.shape
    mask = (torch.ones(n, device=dev) if mask is None
            else torch.as_tensor(np.asarray(mask, np.float32)).to(dev))
    if y_tasks is None:
        y_tasks = torch.as_tensor(np.asarray(y, np.float32))[None].to(dev)
        task_mask = torch.ones_like(y_tasks)
    else:
        y_tasks = torch.as_tensor(np.asarray(y_tasks, np.float32)).to(dev)
        task_mask = (torch.ones_like(y_tasks) if task_mask is None else
                     torch.as_tensor(np.asarray(task_mask, np.float32)).to(dev))
    if grid is None:
        med = kernel_fns.median_heuristic(x.cpu(), mask.cpu())
        grid = grids.liquid_grid(n=int(n), dim=int(d), median_dist=med)
    lam_c, sub_c, task_c, n_lam, n_sub = cv_mod.grid_columns(
        grid, cfg, y_tasks.shape[0])
    key = prng.PRNGKey(seed)[None]
    sel = cv_mod.cv_cell(x[None], y_tasks[None], task_mask[None], mask[None],
                         grid.gammas[None].to(dev), lam_c, sub_c, task_c,
                         key, cfg, n_lam, n_sub)
    combined = select.combine_fold_models(sel.coefs[0])          # (n, T, S)
    return TrainedSVM(sv_x=x, sv_mask=mask, coefs=combined,
                      gamma=sel.gamma[0], lam=sel.lam[0], tau=sel.tau[0],
                      val_loss=sel.val_loss[0], kernel=cfg.kernel)


def test_error(model: TrainedSVM, x_test, y_test, task: str = "classify",
               classes: Optional[np.ndarray] = None,
               pairs: Optional[np.ndarray] = None, sub: int = 0) -> float:
    """"classify"/"mse" read the (0, sub) decision column; "ova"/"ava"
    combine the task axis into class values first."""
    y_test = np.asarray(y_test)
    if task in ("ova", "ava"):
        pred = model.predict_label(x_test, scenario=task, classes=classes,
                                   pairs=pairs, sub=sub)
        return float(np.mean(pred != y_test))
    f = model.decision_function(x_test)[:, 0, sub].cpu().numpy()
    if task == "classify":
        return float(np.mean(f * y_test <= 0))
    if task == "mse":
        return float(np.mean((f - y_test) ** 2))
    raise ValueError(task)
