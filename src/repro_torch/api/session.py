"""Staged train -> select -> test sessions (the JAX package's
``api/session.py``).

    sess = SVM(x, y, config)            # device=None: the current card
    tr   = sess.train()                 # TrainResult: models + CV surface
    sel  = sess.select("npl", alpha=.05)   # SelectResult: one targeted wave
    res  = sess.test(x_test, y_test)    # TestResult: streamed errors

``train()`` scales the data, builds the cell plan (numpy, bit-identical to
the reference's), packs the cells into slots and solves them in waves on
the device (``distributed.cell_trainer``), retaining the validation
surface.  ``select(rule)`` applies a :mod:`repro_torch.core.select` rule
over the surface and re-solves ONLY the (task, sub) columns whose winning
grid coordinates moved off the train-time argmin: every moved cell that
shares a winning gamma index goes into one batched re-solve
(``core.cv.solve_columns_batched``), warm-started from its cached argmin
model.  Under "argmin" nothing is re-solved, so ``train() ->
select("argmin")`` gives the fused fit's models bitwise.

Stage artifacts persist through ``repro_torch.train.checkpoint`` in the
JAX package's format (``save`` / ``load``): each package loads the
other's ``TrainResult``, ``SelectResult`` and ``ModelBank`` directories,
so the stages can run as separate processes (``python -m
repro_torch.cli``) and a server cold-starts from the select output.
``SelectResult`` owns the test phase and the hand-off to the serving
engine (``to_bank``); ``SVM.engine()`` / ``SVM.monitor()`` build the
engine and its health monitor with the session's serve and monitor keys.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch import obs
from repro_torch.cells.builder import CellPlan
from repro_torch.core import cv as cv_mod
from repro_torch.core import grids, kernel_fns, prng
from repro_torch.core import select as select_mod
from repro_torch.data.scaling import Scaler
from repro_torch.distributed.cell_trainer import (predict_cells,
                                                  train_cells_waves)
from repro_torch.distributed.planner import PackedCells, group_rows, pack_cells
from repro_torch.kernels import runtime
from repro_torch.launch import mesh as mesh_mod
from repro_torch.pipeline.cell_stream import build_cells_stream
from repro_torch.pipeline.dataset import (ArraySource, ChunkSource,
                                          ScaledSource, as_source)
from repro_torch.tasks.builder import TaskSet, combine_decisions, make_tasks
from repro_torch.train import checkpoint as ckpt_mod
from repro_torch.train.svm_trainer import SVMTrainerConfig

_TRAIN_FORMAT = "svm_train_result_v1"
_SELECT_FORMAT = "svm_select_result_v1"

# scenario -> the selection rule its select() stage defaults to
_DEFAULT_RULES = {"npsvm": "npl", "quantile": "quantile",
                  "expectile": "expectile"}

Device = Union[None, str, torch.device]


# ----------------------------------------------------------- serialization
def _cfg_to_json(cfg) -> dict:
    return dataclasses.asdict(cfg)


def _cfg_from_json(cls, d: dict):
    """A config dataclass from its saved dict.  Fields the port does not
    have are dropped: the reference's CVConfig also records ``cache_d2``,
    its switch to the uncached baseline scan (the port's scan always
    caches D², and a re-solve builds its own Gram either way)."""
    names = {f.name for f in dataclasses.fields(cls)}
    kw = {k: v for k, v in d.items() if k in names}
    for k in ("taus", "weights"):
        if kw.get(k) is not None:
            kw[k] = tuple(kw[k])
    return cls(**kw)


def _ctx_tree(plan: CellPlan, packed: PackedCells, scaler: Scaler,
              tasks: TaskSet) -> Dict[str, np.ndarray]:
    """The shared stage context (routing + scaling + tasks) as a flat tree.
    Index arrays are stored int32, as the reference stores them (its
    32-bit restore would narrow int64 leaves), and widened on load."""
    return {
        "plan_indices": plan.indices, "plan_mask": plan.mask,
        "plan_owner": np.asarray(plan.owner, np.int32),
        "plan_centers": plan.centers,
        "plan_coarse_of": plan.coarse_of,
        "packed_order": np.asarray(packed.order, np.int32),
        "packed_slot_of_cell": np.asarray(packed.slot_of_cell, np.int32),
        "scaler_mean": np.asarray(scaler.mean),
        "scaler_std": np.asarray(scaler.std),
        "tasks_labels": tasks.labels, "tasks_task_mask": tasks.task_mask,
        "tasks_classes": np.asarray(tasks.classes, np.float32),
        "tasks_pairs": np.asarray(tasks.pairs, np.int32),
        "tasks_taus": np.asarray(tasks.taus, np.float32),
        "tasks_weights": np.asarray(tasks.weights, np.float32),
    }


def _ctx_from_tree(t: Dict[str, np.ndarray], extra: dict):
    plan = CellPlan(indices=t["plan_indices"], mask=t["plan_mask"],
                    owner=np.asarray(t["plan_owner"], np.int32),
                    centers=t["plan_centers"],
                    coarse_of=t["plan_coarse_of"])
    packed = PackedCells(order=np.asarray(t["packed_order"], np.int64),
                         slot_of_cell=np.asarray(t["packed_slot_of_cell"],
                                                 np.int64),
                         n_devices=int(extra["packed_n_devices"]),
                         slots_per_device=int(
                             extra["packed_slots_per_device"]))
    scaler = Scaler(mean=t["scaler_mean"], std=t["scaler_std"])
    tasks = TaskSet(kind=extra["tasks_kind"], labels=t["tasks_labels"],
                    task_mask=t["tasks_task_mask"], classes=t["tasks_classes"],
                    pairs=t["tasks_pairs"], taus=t["tasks_taus"],
                    weights=t["tasks_weights"])
    return plan, packed, scaler, tasks


def _ctx_extra(config, cv_cfg, tasks: TaskSet, packed: PackedCells) -> dict:
    return {"config": _cfg_to_json(config), "cv_cfg": _cfg_to_json(cv_cfg),
            "tasks_kind": tasks.kind,
            "packed_n_devices": int(packed.n_devices),
            "packed_slots_per_device": int(packed.slots_per_device)}


def _save_step0(ckpt_dir: str, tree: Dict[str, Any], extra: dict,
                mesh) -> str:
    """Step 0 of ``ckpt_dir``: written by this process, or in a meshed
    job by global rank 0 while the others wait at a barrier."""
    if mesh_mod.writes(mesh):
        ckpt_mod.save_checkpoint(ckpt_dir, 0, tree, extra=extra,
                                 keep_last=0)
    mesh_mod.barrier(mesh)
    return ckpt_mod.step_dir(ckpt_dir, 0)


def _load_tree(ckpt_dir: str, want_format: str):
    got = ckpt_mod.peek_manifest(ckpt_dir)["extra"].get("format")
    if got != want_format:
        raise ValueError(f"{ckpt_dir} is not a {want_format} checkpoint "
                         f"(format={got!r})")
    return ckpt_mod.restore_self_describing(ckpt_dir)


@dataclasses.dataclass
class TestResult:
    """Streamed test-stage output."""
    error: float
    n: int
    details: Dict[str, float] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class TrainResult:
    """Everything the train stage produced: cell models at the CV-loss
    argmin plus the retained validation surface and the staged cells
    needed to re-solve the columns a different rule moves.  ``select``
    is re-runnable; ``save`` / ``load`` make the stage a process
    boundary."""
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
    iters: Optional[np.ndarray]  # (slots, G, F) box-QP iterations (None:
                                 # loaded from a reference checkpoint)
    n: int
    d: int
    device: torch.device = torch.device("cpu")
    mesh: Any = None           # DeviceMesh of the test phase, or None
    mesh_axes: Optional[Tuple[str, ...]] = None

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
        """Apply a selection rule over the retained surface.

        Columns whose winning (gamma, lambda) equals the train-time argmin
        keep the cached models bitwise; the rest are re-solved by
        :func:`repro_torch.core.cv.resolve_group`, one call for
        all moved cells sharing a winning gamma-grid index, each cell's
        columns padded to T*S by repeating its first (so ``solver_iters``
        counts the same work as the reference's), each warm-started from
        its cell's cached argmin model of the same column.  ``stats``
        reports how little was solved (``resolve_calls`` calls,
        ``solver_iters`` box-QP iterations summed over cells and folds).
        """
        cfg = self.config
        rule = rule or _DEFAULT_RULES.get(cfg.scenario, "argmin")
        if rule in ("npl", "roc") and self.cv_cfg.solver != "hinge":
            raise ValueError(f"rule {rule!r} needs the hinge solver "
                             f"(validation FA/detection counts); "
                             f"got {self.cv_cfg.solver!r}")
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
        nonempty = self.mask_cells.sum(-1) > 0                 # (slots,)
        need = (((res.g_idx != base_g) | (res.l_idx != base_l))
                & nonempty[:, None, None])                     # (slots, T, S)

        coefs = self.coefs.copy()
        gamma, lam = self.gamma.copy(), self.lam.copy()
        val = self.val_loss.copy()
        if self.cv_cfg.solver in ("quantile", "expectile"):
            sub_grid = np.asarray(cfg.taus, np.float32)
        else:
            sub_grid = np.asarray(cfg.weights, np.float32)
        stats = {"rule": rule, "grid_columns": surface.grid_columns,
                 "winners_moved": int(need.sum()),
                 "columns_resolved": 0, "resolve_calls": 0,
                 "solver_iters": 0}

        m_resolved = obs.metrics.counter("select.columns_resolved")
        dev = self.device
        groups: Dict[int, list] = {}
        for c in np.flatnonzero(need.any(axis=(1, 2))):
            for g in np.unique(res.g_idx[c][need[c]]):
                groups.setdefault(int(g), []).append(int(c))
        for g, cells in sorted(groups.items()):
            ts_of = [np.argwhere(need[c] & (res.g_idx[c] == g))  # (m, 2)
                     for c in cells]
            with obs.tracer.span("select.resolve", dev) as sp:
                sp.set(gamma_idx=int(g), cells=len(cells),
                       columns=int(sum(len(ts) for ts in ts_of)))
                # warm start: each cell's cached argmin model of the same
                # (task, sub) column
                outs, n_iters = cv_mod.resolve_group(
                    self.x_cells[cells], self.y_cells[cells],
                    self.tmask_cells[cells], self.mask_cells[cells],
                    self.fold_keys[cells], self.gammas_cells[cells, g],
                    ts_of, self.lambdas[res.l_idx[cells]], sub_grid,
                    self.coefs[cells], self.cv_cfg, dev)
            for c, ts, out in zip(cells, ts_of, outs):
                for j, (t, s) in enumerate(ts):
                    coefs[c, :, t, s] = out[:, j]
                    gamma[c, t, s] = self.gammas_cells[c, g]
                    lam[c, t, s] = self.lambdas[res.l_idx[c, t, s]]
                    val[c, t, s] = self.surf_loss[c, g, t,
                                                  res.l_idx[c, t, s], s]
                stats["columns_resolved"] += len(ts)
                m_resolved.inc(len(ts))
            stats["resolve_calls"] += 1
            stats["solver_iters"] += n_iters

        return SelectResult(
            rule=rule, config=cfg, cv_cfg=self.cv_cfg, scaler=self.scaler,
            plan=self.plan, packed=self.packed, tasks=self.tasks,
            x_cells=self.x_cells, mask_cells=self.mask_cells,
            coefs=coefs, gamma=gamma, lam=lam, tau=self.tau.copy(),
            val_loss=val, extras=dict(res.extras), stats=stats,
            device=self.device, mesh=self.mesh, mesh_axes=self.mesh_axes)

    # ------------------------------------------------------ persistence
    _ARRAYS = ("lambdas", "gammas_cells", "fold_keys", "x_cells",
               "mask_cells", "y_cells", "tmask_cells", "coefs", "gamma",
               "lam", "tau", "val_loss", "surf_loss", "surf_fa", "surf_det")

    def save(self, ckpt_dir: str) -> str:
        """One checkpoint step in the reference's format (``iters`` rides
        along as one more leaf, which the reference ignores)."""
        tree = {k: getattr(self, k) for k in self._ARRAYS}
        if self.iters is not None:
            tree["iters"] = np.asarray(self.iters, np.int32)
        tree.update(_ctx_tree(self.plan, self.packed, self.scaler, self.tasks))
        extra = _ctx_extra(self.config, self.cv_cfg, self.tasks, self.packed)
        extra.update(format=_TRAIN_FORMAT, n=int(self.n), d=int(self.d))
        return _save_step0(ckpt_dir, tree, extra, self.mesh)

    @classmethod
    def load(cls, ckpt_dir: str, device: Device = None, mesh=None,
             mesh_axes: Optional[Tuple[str, ...]] = None) -> "TrainResult":
        """A TrainResult saved by either package; ``device=None``: its
        re-solves run on the current card; ``mesh`` splits its test phase
        (as ``SVM(mesh=...)``)."""
        tree, extra = _load_tree(ckpt_dir, _TRAIN_FORMAT)
        plan, packed, scaler, tasks = _ctx_from_tree(tree, extra)
        return cls(config=_cfg_from_json(SVMTrainerConfig, extra["config"]),
                   cv_cfg=_cfg_from_json(cv_mod.CVConfig, extra["cv_cfg"]),
                   scaler=scaler, plan=plan, packed=packed, tasks=tasks,
                   n=int(extra["n"]), d=int(extra["d"]),
                   iters=tree.get("iters"),
                   device=runtime.resolve_device(device), mesh=mesh,
                   mesh_axes=mesh_axes,
                   **{k: tree[k] for k in cls._ARRAYS})


@dataclasses.dataclass
class SelectResult:
    """One selection outcome: final per-cell models + rule extras.  Owns
    the test phase (``decision_function`` / ``predict`` / ``test``), the
    serving hand-off (``to_bank``) and persistence (``save`` / ``load``)."""
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
    mesh: Any = None           # DeviceMesh the test phase splits over
    mesh_axes: Optional[Tuple[str, ...]] = None

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
                                sv, coefs, gamma, kernel=self.config.kernel,
                                mesh=self.mesh,
                                axis_names=self.mesh_axes).cpu().numpy()
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


    # ------------------------------------------------------ persistence
    _ARRAYS = ("x_cells", "mask_cells", "coefs", "gamma", "lam", "tau",
               "val_loss")
    _CELL_ARRAYS = ("x_cells", "mask_cells")   # the O(n·d) staged rows

    def save(self, ckpt_dir: str, train_ref: Optional[str] = None) -> str:
        """Persist the selection outcome.  ``train_ref`` (a path relative
        to ``ckpt_dir``, e.g. ``"../train"``) skips re-writing the staged
        cell rows and records a reference to the TrainResult checkpoint
        that holds them (the CLI's layout)."""
        skip = self._CELL_ARRAYS if train_ref is not None else ()
        tree = {k: getattr(self, k) for k in self._ARRAYS if k not in skip}
        tree.update(_ctx_tree(self.plan, self.packed, self.scaler, self.tasks))
        tree.update({f"extra_{k}": np.asarray(v)
                     for k, v in self.extras.items()})
        extra = _ctx_extra(self.config, self.cv_cfg, self.tasks, self.packed)
        extra.update(format=_SELECT_FORMAT, rule=self.rule, stats=self.stats,
                     train_ref=train_ref)
        return _save_step0(ckpt_dir, tree, extra, self.mesh)

    @classmethod
    def load(cls, ckpt_dir: str, device: Device = None, mesh=None,
             mesh_axes: Optional[Tuple[str, ...]] = None) -> "SelectResult":
        """A SelectResult saved by either package; ``device=None``: its
        test phase runs on the current card, split over ``mesh`` when
        given."""
        tree, extra = _load_tree(ckpt_dir, _SELECT_FORMAT)
        plan, packed, scaler, tasks = _ctx_from_tree(tree, extra)
        extras = {k[len("extra_"):]: v for k, v in tree.items()
                  if k.startswith("extra_")}
        if extra.get("train_ref"):                 # cells live in train/
            ref = os.path.normpath(os.path.join(ckpt_dir, extra["train_ref"]))
            ref_tree, _ = _load_tree(ref, _TRAIN_FORMAT)
            for k in cls._CELL_ARRAYS:
                tree[k] = ref_tree[k]
        return cls(rule=extra["rule"],
                   config=_cfg_from_json(SVMTrainerConfig, extra["config"]),
                   cv_cfg=_cfg_from_json(cv_mod.CVConfig, extra["cv_cfg"]),
                   scaler=scaler, plan=plan, packed=packed, tasks=tasks,
                   extras=extras, stats=dict(extra.get("stats", {})),
                   device=runtime.resolve_device(device), mesh=mesh,
                   mesh_axes=mesh_axes,
                   **{k: tree[k] for k in cls._ARRAYS})


class SVM:
    """A staged session over one training set (an (n, d) array or a
    ChunkSource).  ``y=None`` takes the labels from a source that carries
    them (``repro_torch.embed.LabeledSource``, or an ``EmbeddingSource``
    built with ``labels=``).  ``device=None`` trains on the current card
    and raises without one; ``device="cpu"`` runs the plain PyTorch path.

    String config keys (``repro_torch.api.config``) may be passed
    directly: ``SVM(x, y, FOLDS=3, NPL_CONSTRAINT=0.01)``.  Select-stage
    keys become ``select()`` defaults, serve and monitor keys carry
    through to :meth:`engine` and :meth:`monitor`, observability keys
    configure ``repro_torch.obs``, and ``EMBED_ARCH`` (with the other
    ``EMBED_*`` keys) flags ``x`` as a token corpus, embedded lazily
    through ``repro_torch.embed.embed_source`` on the session's device.

    Several devices: ``mesh`` (a ``DeviceMesh``, ``launch.mesh``) with
    ``mesh_axes`` packs the cells for the ranks over those dims
    (``pack_cells(plan, n_dev)``), splits each wave's slots and the test
    phase's over them, and returns the whole result on every rank.  Every
    rank builds the session from the same data and seed; ``device`` is
    the rank's own (``None``: its card).  ``select`` re-solves on each
    rank alone, as the reference does; ``save`` writes on rank 0 only.
    """

    def __init__(self, x, y: Optional[np.ndarray] = None,
                 config: Optional[SVMTrainerConfig] = None,
                 device: Device = None,
                 mesh=None, mesh_axes: Optional[Tuple[str, ...]] = None,
                 select_rule: Optional[str] = None,
                 select_kwargs: Optional[dict] = None,
                 serve_kwargs: Optional[dict] = None,
                 monitor_kwargs: Optional[dict] = None,
                 **config_keys):
        cfg = config or SVMTrainerConfig()
        self.device = runtime.resolve_device(device)
        sel_kw = dict(select_kwargs or {})
        srv_kw = dict(serve_kwargs or {})
        mon_kw = dict(monitor_kwargs or {})
        if config_keys:
            from repro_torch.api.config import (apply_keys, split_embed_keys,
                                                split_monitor_keys,
                                                split_obs_keys,
                                                split_serve_keys)
            config_keys, key_obs = split_obs_keys(config_keys)
            if key_obs:
                obs.configure(**key_obs)
            config_keys, key_emb = split_embed_keys(config_keys)
            if key_emb:
                from repro_torch.embed import embed_source
                x = embed_source(x, device=self.device, **key_emb)
            config_keys, key_mon = split_monitor_keys(config_keys)
            mon_kw = {**key_mon, **mon_kw}
            config_keys, key_srv = split_serve_keys(config_keys)
            srv_kw = {**key_srv, **srv_kw}
            cfg, key_sel = apply_keys(cfg, config_keys)
            sel_kw.update(key_sel)
        self.config = cfg
        self.mesh, self.mesh_axes = mesh, mesh_axes
        self.select_rule = select_rule
        self.select_kwargs = sel_kw
        self.serve_kwargs = srv_kw
        self.monitor_kwargs = mon_kw
        self._x, self._y = x, y
        self.train_result: Optional[TrainResult] = None
        self.select_result: Optional[SelectResult] = None

    def train(self, ckpt_dir: Optional[str] = None) -> TrainResult:
        """Solve the full fold x grid over all cells, wave by wave, and
        retain the validation surface.  ``ckpt_dir`` checkpoints each wave
        and restores the waves a killed run left there (matched on this
        fit's fingerprint), bitwise equal to an uninterrupted fit."""
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
        n_dev = (1 if self.mesh is None or not self.mesh_axes
                 else mesh_mod.mesh_size(self.mesh, self.mesh_axes))
        packed = pack_cells(plan, n_dev)
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
        staged = np.zeros(n_slots, bool)

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
                staged[s] = True
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
        fingerprint = self._fingerprint(cv_cfg, plan, tasks, n, d)
        with runtime.full_fp32():
            (coefs, gamma, lam, tau, val, surf_loss, surf_fa, surf_det,
             iters) = train_cells_waves(
                stage, n_slots, cfg.n_slots_per_wave, lam_c, sub_c, task_c,
                cv_cfg, n_lam, n_sub, self.device, mesh=self.mesh,
                axis_names=self.mesh_axes, ckpt_dir=ckpt_dir,
                fingerprint=fingerprint)

        for s in np.flatnonzero(~staged):   # slots of restored waves
            cid = packed.order[s]
            if cid >= 0:
                ids = plan.indices[cid]
                m = plan.mask[cid]
                x_cells[s] = xs_src.gather(ids)
                mask_cells[s] = m
                y_cells[s] = tasks.labels[:, ids] * m[None, :]
                tmask_cells[s] = tasks.task_mask[:, ids] * m[None, :]
                gam_cells[s] = cell_gammas(x_cells[s], m)

        self.train_result = TrainResult(
            config=cfg, cv_cfg=cv_cfg, scaler=scaler, plan=plan,
            packed=packed, tasks=tasks,
            lambdas=base_grid.lambdas.numpy(), gammas_cells=gam_cells,
            fold_keys=keys_all, x_cells=x_cells, mask_cells=mask_cells,
            y_cells=y_cells, tmask_cells=tmask_cells, coefs=coefs,
            gamma=gamma, lam=lam, tau=tau, val_loss=val,
            surf_loss=surf_loss, surf_fa=surf_fa, surf_det=surf_det,
            iters=iters, n=n, d=d, device=self.device, mesh=self.mesh,
            mesh_axes=self.mesh_axes)
        self.select_result = None
        return self.train_result

    def _fingerprint(self, cv_cfg: cv_mod.CVConfig, plan: CellPlan,
                     tasks: TaskSet, n: int, d: int) -> str:
        """Identity of this fit for wave-checkpoint resume: config, data
        layout (the cell plan) and labels, so that a directory left by
        another run is ignored, not restored.  The reference's recipe over
        this package's config reprs (resume across packages is not
        promised)."""
        h = hashlib.blake2b(digest_size=16)
        h.update(repr(self.config).encode())
        h.update(repr(cv_cfg).encode())
        h.update(np.int64([n, d]).tobytes())
        h.update(np.ascontiguousarray(plan.indices).tobytes())
        h.update(np.ascontiguousarray(plan.mask).tobytes())
        h.update(np.ascontiguousarray(plan.centers).tobytes())
        h.update(np.ascontiguousarray(tasks.labels).tobytes())
        return h.hexdigest()

    def select(self, rule: Optional[str] = None, **rule_kwargs
               ) -> SelectResult:
        """Pick hyper-parameters over the retained surface (re-runnable);
        the session's select keys are the defaults."""
        if self.train_result is None:
            raise RuntimeError("call train() before select()")
        merged = {**self.select_kwargs, **rule_kwargs}
        self.select_result = self.train_result.select(
            rule or self.select_rule, **merged)
        return self.select_result

    def test(self, x_test, y_test,
             chunk_size: Optional[int] = None) -> TestResult:
        """Streamed scenario error; selects with the session's default
        rule first if select() has not been called."""
        if self.select_result is None:
            self.select()
        return self.select_result.test(x_test, y_test, chunk_size=chunk_size)

    def engine(self, **engine_kwargs):
        """Compact the selection into a bank and build an ``SVMEngine`` on
        the session's device.  Serve keys given at construction
        (``SERVE_OVERLAP``, ``DEADLINE_MS``, ``MAX_QUEUE``) carry through;
        explicit ``engine_kwargs`` win.  ``SWAP_POLL_MS`` is the CLI serve
        loop's bank watcher, which a session has not: it is dropped."""
        if self.select_result is None:
            self.select()
        from repro_torch.serve.svm_engine import SVMEngine
        srv = {k: v for k, v in self.serve_kwargs.items()
               if k != "swap_poll_ms"}
        return SVMEngine(self.select_result.to_bank(),
                         **{"device": self.device, **srv, **engine_kwargs})

    def monitor(self, engine, **monitor_kwargs):
        """Attach a :class:`repro_torch.serve.monitor.HealthMonitor` to an
        engine.  Monitor keys given at construction (``SLO_P99_MS``,
        ``DRIFT_WINDOW``, ``DRIFT_REFRESH_THRESHOLD``) carry through;
        explicit ``monitor_kwargs`` win."""
        from repro_torch.serve.monitor import HealthMonitor
        return HealthMonitor(engine,
                             **{**self.monitor_kwargs, **monitor_kwargs})
