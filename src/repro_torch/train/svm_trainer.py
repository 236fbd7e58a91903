"""The estimator-style entry point of the full liquidSVM cycle (the JAX
package's ``train/svm_trainer.py``).

``LiquidSVM(config, device=None).fit(x, y)`` is ``SVM.train()`` followed
by ``select()`` with the CV-loss argmin (the validation-surface
Neyman-Pearson rule for ``scenario="npsvm"``); the test-phase methods and
``to_bank()`` delegate to the resulting ``SelectResult``.  It trains on
the current CUDA card unless the caller passes ``device="cpu"``, and
raises when there is no card.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SVMTrainerConfig:
    scenario: str = "binary"        # binary | ova | ava | weighted | npsvm |
                                    # quantile | expectile | ls
    solver: str = "auto"            # auto: hinge for classification, else
                                    # ls/quantile/expectile
    kernel: str = "gauss_rbf"
    cell_method: str = "none"       # none | random | voronoi | overlap |
                                    # recursive | coarse_fine
    cell_size: int = 2000
    n_folds: int = 5
    fold_scheme: str = "random"
    grid_choice: int = 0
    adaptivity_control: int = 0
    taus: Tuple[float, ...] = (0.05, 0.5, 0.95)
    weights: Tuple[float, ...] = (1.0,)
    np_alpha: float = 0.05          # npsvm: false-alarm budget on class -1
    tol: float = 1e-3
    max_iters: int = 1000
    cd_polish: int = 0              # Gauss-Seidel polish epochs after each
                                    # box-QP solve (B4); 0 = off
    seed: int = 0
    scale: bool = True              # train-statistics feature scaling
    n_slots_per_wave: Optional[int] = None   # None: all slots in one wave
    chunk_size: int = 65536                  # streaming chunk rows

    def resolve_solver(self) -> str:
        if self.solver != "auto":
            return self.solver
        return {"binary": "hinge", "ova": "hinge", "ava": "hinge",
                "weighted": "hinge", "npsvm": "hinge", "quantile": "quantile",
                "expectile": "expectile", "ls": "ls"}[self.scenario]


class LiquidSVM:
    """Fit -> select -> test over cells, on ``device`` (None: the card).
    ``mesh`` and ``mesh_axes`` split the cells over the ranks of a
    ``DeviceMesh`` (``api.session.SVM``)."""

    def __init__(self, config: SVMTrainerConfig = SVMTrainerConfig(),
                 device: Union[None, str, torch.device] = None,
                 mesh=None, mesh_axes: Optional[Tuple[str, ...]] = None):
        from repro_torch.kernels import runtime
        self.config = config
        self.device = runtime.resolve_device(device)
        self.mesh = mesh
        self.mesh_axes = mesh_axes
        self._fitted = False

    def fit(self, x, y: np.ndarray, ckpt_dir: Optional[str] = None
            ) -> "LiquidSVM":
        """Fit from an (n, d) array or a ChunkSource: ``SVM.train()`` +
        ``select("argmin")`` (scenario ``npsvm``: the ``"npl"`` rule, whose
        rates come from the retained validation surface)."""
        from repro_torch.api.session import SVM
        cfg = self.config
        sess = SVM(x, y, config=cfg, device=self.device, mesh=self.mesh,
                   mesh_axes=self.mesh_axes)
        tr = sess.train(ckpt_dir=ckpt_dir)
        rule = "npl" if cfg.scenario == "npsvm" else "argmin"
        sel = sess.select(rule)
        self.session, self.train_result, self.select_result = sess, tr, sel
        self.scaler, self.tasks = tr.scaler, tr.tasks
        self.plan, self.packed, self.cv_cfg = tr.plan, tr.packed, tr.cv_cfg
        self.x_cells, self.mask_cells = tr.x_cells, tr.mask_cells
        self.coefs, self.gamma = sel.coefs, sel.gamma
        self.lam, self.tau = sel.lam, sel.tau
        self.val_loss = sel.val_loss
        if cfg.scenario == "npsvm":
            self.np_fa = np.asarray(sel.extras["np_fa"])[0]
            self.np_det = np.asarray(sel.extras["np_det"])[0]
            self.np_weight_idx = sel.default_sub
        self._fitted = True
        return self

    def _check_fitted(self) -> None:
        if not self._fitted:
            raise RuntimeError("call fit() first")

    def to_bank(self, drop_tol: Optional[float] = 0.0, dtype: str = "f32",
                dedup: bool = True):
        """Compact the fitted cell models into a serving ModelBank."""
        self._check_fitted()
        return self.select_result.to_bank(drop_tol=drop_tol, dtype=dtype,
                                          dedup=dedup)

    def decision_function(self, x_test: np.ndarray) -> np.ndarray:
        """(m, d) -> (m, T, S) via nearest-center routing to the cells."""
        self._check_fitted()
        return self.select_result.decision_function(x_test)

    def predict(self, x_test: np.ndarray) -> np.ndarray:
        self._check_fitted()
        return self.select_result.predict(x_test)

    def error(self, x_test: np.ndarray, y_test: np.ndarray) -> float:
        self._check_fitted()
        return float(self.select_result.test(x_test, y_test).error)
