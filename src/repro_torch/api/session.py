"""Staged train -> select -> test sessions (the JAX package's
``api/session.py``), the argmin part.

    sess = SVM(x, y, config)            # device=None: the current card
    tr   = sess.train()                 # TrainResult: models + CV surface
    sel  = sess.select()                # SelectResult (argmin rule)
    res  = sel.test(x_test, y_test)     # TestResult

``train()`` scales the data, builds the cell plan (numpy, bit-identical to
the reference's), packs the cells into slots and solves them in waves on
the device (``distributed.cell_trainer``), retaining the validation
surface.  ``select()`` applies the CV-loss argmin, which reuses the models
the train stage cached, so nothing is re-solved.  ``SelectResult`` owns
the test phase and the hand-off to the serving engine (``to_bank``).

Not ported yet: the re-solve of moved winners (``solve_columns_at``, which
only the ``npl`` / ``roc`` rules need), ``save`` / ``load``, the string
config keys and the CLI.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.cells.builder import CellPlan
from repro_torch.core import cv as cv_mod
from repro_torch.core import grids, kernel_fns, prng
from repro_torch.core import select as select_mod
from repro_torch.data.scaling import Scaler
from repro_torch.distributed.cell_trainer import (predict_cells,
                                                  train_cells_waves)
from repro_torch.distributed.planner import PackedCells, group_rows, pack_cells
from repro_torch.kernels import runtime
from repro_torch.pipeline.cell_stream import build_cells_stream
from repro_torch.pipeline.dataset import (ArraySource, ChunkSource,
                                          ScaledSource, as_source)
from repro_torch.tasks.builder import TaskSet, combine_decisions, make_tasks
from repro_torch.train.svm_trainer import SVMTrainerConfig

# scenario -> the selection rule its select() stage defaults to
_DEFAULT_RULES = {"npsvm": "npl", "quantile": "quantile",
                  "expectile": "expectile"}

Device = Union[None, str, torch.device]


@dataclasses.dataclass
class TestResult:
    """Streamed test-stage output."""
    error: float
    n: int
    details: Dict[str, float] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class TrainResult:
    """Everything the train stage produced: cell models at the CV-loss
    argmin plus the retained validation surface and the staged cells."""
    config: SVMTrainerConfig
    cv_cfg: cv_mod.CVConfig
    scaler: Scaler
    plan: CellPlan
    packed: PackedCells
    tasks: TaskSet
    lambdas: np.ndarray        # (L,)
    gammas_cells: np.ndarray   # (slots, G) per-cell gamma grids
    fold_keys: np.ndarray      # (slots, 2) uint32 per-cell fold keys
    x_cells: np.ndarray        # (slots, k, d) staged (scaled) rows
    mask_cells: np.ndarray     # (slots, k)
    y_cells: np.ndarray        # (slots, T, k)
    tmask_cells: np.ndarray    # (slots, T, k)
    coefs: np.ndarray          # (slots, k, T, S) fold-averaged argmin models
    gamma: np.ndarray          # (slots, T, S)
    lam: np.ndarray
    tau: np.ndarray
    val_loss: np.ndarray
    surf_loss: np.ndarray      # (slots, G, T, L, S)
    surf_fa: np.ndarray
    surf_det: np.ndarray
    iters: np.ndarray          # (slots, G, F) box-QP iterations
    n: int
    d: int
    device: torch.device = torch.device("cpu")

    def class_counts(self) -> Tuple[np.ndarray, np.ndarray]:
        on = (self.tmask_cells > 0) & (self.mask_cells[:, None, :] > 0)
        neg = ((self.y_cells < 0) & on).sum(-1).astype(np.float32)
        pos = ((self.y_cells > 0) & on).sum(-1).astype(np.float32)
        return neg, pos

    def surface(self) -> select_mod.Surface:
        neg, pos = self.class_counts()
        return select_mod.Surface(loss=self.surf_loss, fa=self.surf_fa,
                                  det=self.surf_det, neg=neg, pos=pos,
                                  gammas=self.gammas_cells,
                                  lambdas=self.lambdas)

    def select(self, rule: Optional[str] = None, **rule_kwargs
               ) -> "SelectResult":
        """Apply a selection rule over the retained surface.  The ported
        rules (argmin and its aliases) pick the train-time winners, whose
        models are cached: nothing is re-solved."""
        cfg = self.config
        rule = rule or _DEFAULT_RULES.get(cfg.scenario, "argmin")
        ctx = select_mod.SelectContext(
            scenario=cfg.scenario,
            weights=np.asarray(cfg.weights, np.float32),
            taus=np.asarray(cfg.taus, np.float32),
            alpha=float(rule_kwargs.pop("alpha", cfg.np_alpha)),
            npl_class=int(rule_kwargs.pop("npl_class", -1)))
        if rule_kwargs:
            raise TypeError(f"unknown select() options {sorted(rule_kwargs)}")
        surface = self.surface()
        res = select_mod.get_rule(rule)(surface, ctx)
        base_g, base_l = select_mod.argmin_winners(self.surf_loss)
        nonempty = self.mask_cells.sum(-1) > 0
        need = (((res.g_idx != base_g) | (res.l_idx != base_l))
                & nonempty[:, None, None])
        if need.any():
            raise NotImplementedError(
                f"rule {rule!r} moved {int(need.sum())} winners off the "
                f"train-time argmin; their re-solve (solve_columns_at) is "
                f"not ported yet")
        stats = {"rule": rule, "grid_columns": surface.grid_columns,
                 "winners_moved": 0, "columns_resolved": 0,
                 "resolve_calls": 0, "solver_iters": 0}
        return SelectResult(
            rule=rule, config=cfg, cv_cfg=self.cv_cfg, scaler=self.scaler,
            plan=self.plan, packed=self.packed, tasks=self.tasks,
            x_cells=self.x_cells, mask_cells=self.mask_cells,
            coefs=self.coefs.copy(), gamma=self.gamma.copy(),
            lam=self.lam.copy(), tau=self.tau.copy(),
            val_loss=self.val_loss.copy(), extras=dict(res.extras),
            stats=stats, device=self.device)


@dataclasses.dataclass
class SelectResult:
    """One selection outcome: final per-cell models + rule extras.  Owns
    the test phase (``decision_function`` / ``predict`` / ``test``) and
    the serving hand-off (``to_bank``)."""
    rule: str
    config: SVMTrainerConfig
    cv_cfg: cv_mod.CVConfig
    scaler: Scaler
    plan: CellPlan
    packed: PackedCells
    tasks: TaskSet
    x_cells: np.ndarray
    mask_cells: np.ndarray
    coefs: np.ndarray          # (slots, k, T, S)
    gamma: np.ndarray          # (slots, T, S)
    lam: np.ndarray
    tau: np.ndarray
    val_loss: np.ndarray
    extras: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)
    stats: Dict[str, Any] = dataclasses.field(default_factory=dict)
    device: torch.device = torch.device("cpu")

    @property
    def default_sub(self) -> int:
        if "np_weight_idx" in self.extras:
            return int(np.asarray(self.extras["np_weight_idx"]).reshape(-1)[0])
        return 0

    def _models(self):
        """The cell models on the device, uploaded once."""
        cache = self.__dict__.setdefault("_dev_models", {})
        if not cache:
            for k in ("x_cells", "coefs", "gamma"):
                cache[k] = torch.as_tensor(
                    np.asarray(getattr(self, k), np.float32)).to(self.device)
        return cache["x_cells"], cache["coefs"], cache["gamma"]

    def decision_function(self, x_test: np.ndarray) -> np.ndarray:
        """(m, d) raw features -> (m, T, S) via nearest-center routing."""
        xt = self.scaler.transform(np.asarray(x_test, np.float32))
        cell_of = self.plan.route(xt)
        slot_of = self.packed.slot_of_cell[cell_of]
        n_slots = self.packed.n_slots
        g = group_rows(slot_of, n_slots)
        m_pad = -(-g.m_max // 8) * 8
        xt_cells = np.zeros((n_slots, m_pad, xt.shape[1]), np.float32)
        xt_cells[g.slot, g.pos] = xt[g.rows]
        sv, coefs, gamma = self._models()
        with runtime.full_fp32():
            dec = predict_cells(torch.as_tensor(xt_cells).to(self.device),
                                sv, coefs, gamma,
                                kernel=self.config.kernel).cpu().numpy()
        out = np.zeros((xt.shape[0],) + dec.shape[2:], np.float32)
        out[g.rows] = dec[g.slot, g.pos]
        return out

    def predict(self, x_test: np.ndarray) -> np.ndarray:
        return combine_decisions(
            self.decision_function(x_test), self.config.scenario,
            classes=self.tasks.classes, pairs=self.tasks.pairs,
            sub=self.default_sub)

    def test(self, x_test, y_test, chunk_size: Optional[int] = None
             ) -> TestResult:
        """The scenario error, streamed over an array or ChunkSource."""
        sc = self.config.scenario
        src: ChunkSource = as_source(x_test)
        y = np.asarray(y_test)
        chunk = int(chunk_size or self.config.chunk_size)
        taus = np.asarray(self.config.taus, np.float32)
        err_sum, den = 0.0, 0
        fa = det = neg = pos = 0
        for lo, block in src.iter_chunks(chunk):
            pred = self.predict(block)
            yc = y[lo:lo + block.shape[0]]
            if sc in ("binary", "weighted", "npsvm"):
                err_sum += float((pred != np.sign(yc)).sum())
                den += yc.shape[0]
                fa += int(((pred > 0) & (yc < 0)).sum())
                det += int(((pred > 0) & (yc > 0)).sum())
                neg += int((yc < 0).sum())
                pos += int((yc > 0).sum())
            elif sc in ("ova", "ava"):
                err_sum += float((pred != yc).sum())
                den += yc.shape[0]
            elif sc == "quantile":
                r = yc[:, None] - pred
                err_sum += float(np.where(r >= 0, taus * r,
                                          (taus - 1) * r).sum())
                den += r.size
            elif sc == "expectile":
                r = yc[:, None] - pred
                err_sum += float(np.where(r >= 0, taus * r * r,
                                          (1 - taus) * r * r).sum())
                den += r.size
            elif sc == "ls":
                err_sum += float(((pred - yc) ** 2).sum())
                den += yc.shape[0]
            else:
                raise ValueError(sc)
        details: Dict[str, float] = {}
        if neg + pos:
            details = {"false_alarm": fa / max(neg, 1),
                       "detection": det / max(pos, 1)}
        return TestResult(error=err_sum / max(den, 1), n=src.n_rows,
                          details=details)

    def to_bank(self, drop_tol: Optional[float] = 0.0, dtype: str = "f32",
                dedup: bool = True, version: int = 0):
        """Compact into a serving ModelBank (cold-starts ``SVMEngine``).
        Empty slots get a far-away center that no query routes to."""
        from repro_torch.serve.model_bank import _FAR, ModelBank
        n_slots = self.packed.n_slots
        d = self.x_cells.shape[2]
        centers = np.full((n_slots, d), _FAR, np.float32)
        for s, cid in enumerate(self.packed.order):
            if cid >= 0:
                centers[s] = self.plan.centers[cid]
        routing = ("overlap" if self.config.cell_method == "overlap"
                   else "nearest")
        return ModelBank.from_cells(
            self.x_cells, self.mask_cells, self.coefs, self.gamma, centers,
            kernel=self.config.kernel, drop_tol=drop_tol, dtype=dtype,
            dedup=dedup,
            feat_mean=np.asarray(self.scaler.mean, np.float32),
            feat_std=np.asarray(self.scaler.std, np.float32),
            classes=self.tasks.classes, pairs=self.tasks.pairs,
            scenario=self.config.scenario, default_sub=self.default_sub,
            routing=routing, version=version)


class SVM:
    """A staged session over one training set (an (n, d) array or a
    ChunkSource).  ``y=None`` takes the labels from a source that carries
    them (``repro_torch.embed.LabeledSource``, or an ``EmbeddingSource``
    built with ``labels=``).  ``device=None`` trains on the current card
    and raises without one; ``device="cpu"`` runs the plain PyTorch path."""

    def __init__(self, x, y: Optional[np.ndarray] = None,
                 config: Optional[SVMTrainerConfig] = None,
                 device: Device = None):
        self.config = config or SVMTrainerConfig()
        self.device = runtime.resolve_device(device)
        self._x, self._y = x, y
        self.train_result: Optional[TrainResult] = None
        self.select_result: Optional[SelectResult] = None

    def train(self, ckpt_dir: Optional[str] = None) -> TrainResult:
        """Solve the full fold x grid over all cells, wave by wave, and
        retain the validation surface."""
        if ckpt_dir is not None:
            raise NotImplementedError("per-wave checkpoints (ckpt_dir) are "
                                      "not ported yet")
        cfg = self.config
        y = self._y
        if y is None:
            if not hasattr(self._x, "labels_vector"):
                raise ValueError(
                    "SVM(y=None) needs a label-carrying x source "
                    "(repro_torch.embed.LabeledSource, or an EmbeddingSource "
                    "built with labels=...) — plain feature sources "
                    "require an explicit y")
            # labels stream from the source: O(n) scalars, chunk by chunk
            y = self._x.labels_vector(cfg.chunk_size)
        raw_src: ChunkSource = as_source(self._x)
        if cfg.scale:
            scaler = Scaler.fit_stream(raw_src, cfg.chunk_size)
        else:
            scaler = Scaler(mean=np.zeros(raw_src.dim, np.float32),
                            std=np.ones(raw_src.dim, np.float32))
        if isinstance(raw_src, ArraySource):
            xs_src: ChunkSource = ArraySource(
                scaler.transform(raw_src.materialize()))
        else:
            xs_src = ScaledSource(raw_src, scaler.mean, scaler.std)
        n, d = xs_src.shape

        scenario = ("weighted" if cfg.scenario in ("weighted", "npsvm")
                    else cfg.scenario)
        tasks = make_tasks(y, scenario, taus=cfg.taus,
                           weights=cfg.weights)
        plan = build_cells_stream(xs_src, cell_size=cfg.cell_size,
                                  method=cfg.cell_method, seed=cfg.seed,
                                  chunk_size=cfg.chunk_size)
        packed = pack_cells(plan, 1)
        k, n_slots, t_count = plan.k_max, packed.n_slots, tasks.n_tasks
        cv_cfg = cv_mod.CVConfig(
            solver=cfg.resolve_solver(), kernel=cfg.kernel,
            n_folds=cfg.n_folds, fold_scheme=cfg.fold_scheme, tol=cfg.tol,
            max_iters=cfg.max_iters, taus=cfg.taus, weights=cfg.weights,
            keep_surface=True, cd_polish=cfg.cd_polish)

        base_grid = grids.liquid_grid(n=k, dim=d, median_dist=1.0,
                                      grid_choice=cfg.grid_choice,
                                      cell_size=cfg.cell_size)
        if cfg.adaptivity_control > 0:
            base_grid = grids.adaptive_subgrid(base_grid,
                                               cfg.adaptivity_control)
        n_gamma = len(base_grid.gammas)
        keys_all = prng.split(prng.PRNGKey(cfg.seed), n_slots)

        x_cells = np.zeros((n_slots, k, d), np.float32)
        mask_cells = np.zeros((n_slots, k), np.float32)
        y_cells = np.zeros((n_slots, t_count, k), np.float32)
        tmask_cells = np.zeros((n_slots, t_count, k), np.float32)
        gam_cells = np.ones((n_slots, n_gamma), np.float32)

        def cell_gammas(x_c: np.ndarray, m: np.ndarray) -> np.ndarray:
            # per-cell gamma grid from the cell's median distance, on the
            # host, as the reference's staging computes it
            med = float(kernel_fns.median_heuristic(torch.from_numpy(x_c),
                                                    torch.from_numpy(m)))
            g = grids.liquid_grid(n=int(m.sum()), dim=d, median_dist=med,
                                  grid_choice=cfg.grid_choice,
                                  cell_size=cfg.cell_size)
            if cfg.adaptivity_control > 0:
                g = grids.adaptive_subgrid(g, cfg.adaptivity_control)
            return g.gammas.numpy()

        def stage(lo: int, hi: int):
            """Host arrays for slots [lo, hi) only; wave padding slots stay
            empty (zero masks, unit gammas, zero keys)."""
            w = hi - lo
            x_w = np.zeros((w, k, d), np.float32)
            mask_w = np.zeros((w, k), np.float32)
            y_w = np.zeros((w, t_count, k), np.float32)
            tmask_w = np.zeros((w, t_count, k), np.float32)
            gam_w = np.ones((w, n_gamma), np.float32)
            keys_w = np.zeros((w, 2), np.uint32)
            keys_w[: max(min(hi, n_slots) - lo, 0)] = keys_all[lo:hi]
            for j, s in enumerate(range(lo, min(hi, n_slots))):
                cid = packed.order[s]
                if cid < 0:
                    continue
                ids = plan.indices[cid]
                m = plan.mask[cid]
                x_w[j] = xs_src.gather(ids)
                mask_w[j] = m
                y_w[j] = tasks.labels[:, ids] * m[None, :]
                tmask_w[j] = tasks.task_mask[:, ids] * m[None, :]
                gam_w[j] = cell_gammas(x_w[j], m)
                x_cells[s], mask_cells[s] = x_w[j], m
                y_cells[s], tmask_cells[s] = y_w[j], tmask_w[j]
                gam_cells[s] = gam_w[j]
            return x_w, y_w, tmask_w, mask_w, gam_w, keys_w

        lam_c, sub_c, task_c, n_lam, n_sub = cv_mod.grid_columns(
            base_grid, cv_cfg, t_count)
        with runtime.full_fp32():
            (coefs, gamma, lam, tau, val, surf_loss, surf_fa, surf_det,
             iters) = train_cells_waves(
                stage, n_slots, cfg.n_slots_per_wave, lam_c, sub_c, task_c,
                cv_cfg, n_lam, n_sub, self.device)

        self.train_result = TrainResult(
            config=cfg, cv_cfg=cv_cfg, scaler=scaler, plan=plan,
            packed=packed, tasks=tasks,
            lambdas=base_grid.lambdas.numpy(), gammas_cells=gam_cells,
            fold_keys=keys_all, x_cells=x_cells, mask_cells=mask_cells,
            y_cells=y_cells, tmask_cells=tmask_cells, coefs=coefs,
            gamma=gamma, lam=lam, tau=tau, val_loss=val,
            surf_loss=surf_loss, surf_fa=surf_fa, surf_det=surf_det,
            iters=iters, n=n, d=d, device=self.device)
        self.select_result = None
        return self.train_result

    def select(self, rule: Optional[str] = None, **rule_kwargs
               ) -> SelectResult:
        if self.train_result is None:
            raise RuntimeError("call train() before select()")
        self.select_result = self.train_result.select(rule, **rule_kwargs)
        return self.select_result
