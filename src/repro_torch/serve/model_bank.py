"""Model bank: compacted cell-SVM storage for the serving engine.

liquidSVM's test phase ships every trained cell model to the predict
workers; at serving scale (the Rgtsvm observation: batched prediction is
where large-SVM deployments spend their time) the resident model set is a
first-class artifact.  The bank ingests a trained ``(n_slots, k, ...)``
cell batch and compacts it:

  * **zero-row dropping** — the hinge duals are sparse (box-projected
    coordinate descent leaves exact zeros), so SV rows whose coefficients
    vanish across ALL (task, sub) columns are dropped;
  * **SV dedup** — one SV table per cell, shared by every task, fold and
    gamma: the per-(task, sub) models are coefficient COLUMNS over that
    table, and exact-duplicate SV rows are merged by summing their
    coefficient rows (k(x, u) is identical for identical u, so the
    decision function is unchanged);
  * **bf16 storage** — optional 2-byte SV/coefficient tables (decisions are
    always computed in f32; storage-only downcast).  numpy has no bf16, so
    those two tables are then CPU ``torch.bfloat16`` tensors; every other
    field is a numpy array, bit-for-bit the JAX package's.

Layout (C = number of cells, P = n_tasks * n_sub, column p = t * n_sub + s
— the task-major flattening of the (task, sub) decision block):

  sv        (C, k, d)   compacted, padded SV tables
  coefs     (C, k, P)   per-(task, sub) coefficient columns
  gammas    (C, P)      per-column selected gamma
  sv_count  (C,)        live rows per cell (rows beyond carry zero coefs)
  centers   (C, d)      Voronoi routing centers (empty slots pushed to inf)

A trained model compacts into one through ``SelectResult.to_bank``.
``bank.save(dir)`` / ``ModelBank.load(dir)`` go through
``repro_torch.train.checkpoint`` in the JAX package's format
(``svm_model_bank_v1``), so a server of either package cold-starts from a
bank the other saved; in memory, ``repro_torch.serve.convert`` takes over
the reference's arrays.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core.svm import TrainedSVM
from repro_torch.distributed.planner import _round_up
from repro_torch.train import checkpoint as ckpt_mod

Table = Union[np.ndarray, torch.Tensor]

# routing center of an empty slot: farther than any scaled query, so the
# slot never receives traffic
_FAR = np.float32(1.0e18)


def _route_baseline(sv_cells: np.ndarray, mask_cells: np.ndarray,
                    centers: np.ndarray) -> dict:
    """Per-cell squared-distance quantiles of the training rows that BUILT
    each cell, measured to the cell's own routing center — the reference
    distribution a health monitor scores live traffic against.  Computed
    from the pre-compaction staged rows (``from_cells`` inputs), so it
    reflects the training data, not the surviving SVs.  Cells with no live
    rows (or non-finite padding centers) record n=0 and are skipped by the
    drift scorer."""
    c_count = sv_cells.shape[0]
    q50 = np.zeros((c_count,), np.float64)
    q90 = np.zeros((c_count,), np.float64)
    n = np.zeros((c_count,), np.int64)
    for c in range(c_count):
        live = mask_cells[c] > 0
        center = centers[c]
        if not live.any() or not np.all(np.isfinite(center)):
            continue
        d2 = ((sv_cells[c][live] - center[None, :]) ** 2).sum(axis=1)
        lo, hi = np.quantile(d2, (0.5, 0.9))
        if not (np.isfinite(lo) and np.isfinite(hi)):
            continue
        q50[c], q90[c], n[c] = float(lo), float(hi), int(live.sum())
    return {"q50": q50.tolist(), "q90": q90.tolist(), "n": n.tolist()}


def _dedup_rows(sv: np.ndarray, coefs: np.ndarray):
    """Merge exact-duplicate SV rows, first-occurrence order preserved.

    sv (k, d), coefs (k, P) -> smaller (k', d), (k', P) with coefficient
    rows of duplicates summed into the first occurrence.
    """
    _, first, inverse = np.unique(sv, axis=0, return_index=True,
                                  return_inverse=True)
    if first.shape[0] == sv.shape[0]:
        return sv, coefs                      # no duplicates: exact identity
    # remap unique-group ids to first-occurrence order
    order = np.argsort(first, kind="stable")
    rank = np.empty_like(order)
    rank[order] = np.arange(order.shape[0])
    g = rank[inverse.reshape(-1)]             # (k,) group id, order-preserving
    out_sv = sv[np.sort(first)]
    out_coefs = np.zeros((first.shape[0], coefs.shape[1]), coefs.dtype)
    np.add.at(out_coefs, g, coefs)
    return out_sv, out_coefs


def _dtype_name(t: Table) -> str:
    return "bfloat16" if t.dtype == torch.bfloat16 else str(t.dtype)


@dataclasses.dataclass(frozen=True)
class ModelBank:
    sv: Table                 # (C, k, d) f32 ndarray or bf16 CPU tensor
    coefs: Table              # (C, k, P) f32 ndarray or bf16 CPU tensor
    gammas: np.ndarray        # (C, P) f32
    sv_count: np.ndarray      # (C,) int32
    centers: np.ndarray       # (C, d) f32
    feat_mean: np.ndarray     # (d,) f32 — input scaling baked into the bank
    feat_std: np.ndarray      # (d,) f32
    classes: np.ndarray       # (n_classes,) f32 (empty for regression)
    pairs: np.ndarray         # (n_tasks, 2) int32 AvA pairs (or -1)
    kernel: str = "gauss_rbf"
    n_tasks: int = 1
    n_sub: int = 1
    scenario: str = "binary"
    raw_sv_total: int = 0     # pre-compaction SV rows (for stats)
    default_sub: int = 0      # sub column label combination reads by default
    routing: str = "nearest"  # "nearest" (1-NN) | "overlap" (voronoi=5
                              # banks: route to the 2 nearest centers and
                              # blend decisions; the engine reads this)
    version: int = 0          # monotonic bank version: the serving engine
                              # only accepts hot swaps to a strictly newer
                              # version, and tags every response with the
                              # version that served it
    route_baseline: Optional[dict] = None
                              # train-time routing-distance baseline:
                              # {"q50": [C], "q90": [C], "n": [C]} — per-cell
                              # quantiles of the squared distance from the
                              # cell's own (scaled) training rows to its
                              # center; None for banks that predate it.

    # the non-array fields, in the JAX package's checkpoint meta order
    FORMAT = "svm_model_bank_v1"
    META_KEYS = ("kernel", "n_tasks", "n_sub", "scenario", "raw_sv_total",
                 "default_sub", "routing", "version", "route_baseline")

    # ------------------------------------------------------------ properties
    @property
    def n_cells(self) -> int:
        return self.sv.shape[0]

    @property
    def k_max(self) -> int:
        return self.sv.shape[1]

    @property
    def n_columns(self) -> int:
        return self.coefs.shape[2]

    @property
    def nbytes(self) -> int:
        return self.sv.nbytes + self.coefs.nbytes + self.gammas.nbytes

    def stats(self) -> dict:
        live = int(self.sv_count.sum())
        return {
            "n_cells": self.n_cells,
            "k_max": self.k_max,
            "sv_live": live,
            "sv_raw": int(self.raw_sv_total),
            "compaction": live / max(int(self.raw_sv_total), 1),
            "bytes": self.nbytes,
            "dtype": _dtype_name(self.sv),
            "routing": self.routing,
            "version": int(self.version),
            "drift_baseline": bool(self.route_baseline),
        }

    def with_version(self, version: int) -> "ModelBank":
        """Same bank, new version tag (arrays shared, not copied)."""
        return dataclasses.replace(self, version=int(version))

    def route_baseline_arrays(self):
        """(q50, q90, n) f64/int arrays from the recorded baseline, or
        ``None`` when the bank predates drift baselines."""
        rb = self.route_baseline
        if not rb:
            return None
        return (np.asarray(rb["q50"], np.float64),
                np.asarray(rb["q90"], np.float64),
                np.asarray(rb["n"], np.int64))

    # ---------------------------------------------------------- construction
    @classmethod
    def from_cells(
        cls,
        sv_cells: np.ndarray,       # (C, k, d)
        mask_cells: np.ndarray,     # (C, k)
        coef_cells: np.ndarray,     # (C, k, T, S)
        gamma_cells: np.ndarray,    # (C, T, S)
        centers: np.ndarray,        # (C, d)
        *,
        kernel: str = "gauss_rbf",
        drop_tol: Optional[float] = 0.0,
        dedup: bool = True,
        dtype: str = "f32",
        feat_mean: Optional[np.ndarray] = None,
        feat_std: Optional[np.ndarray] = None,
        classes: Optional[np.ndarray] = None,
        pairs: Optional[np.ndarray] = None,
        scenario: str = "binary",
        default_sub: int = 0,
        routing: str = "nearest",
        version: int = 0,
        pad_multiple: int = 8,
        route_baseline: Optional[dict] = None,
    ) -> "ModelBank":
        """Compact a trained cell batch into a bank.

        ``drop_tol``: SV rows with ``max_p |coef| <= drop_tol`` are dropped
        (0.0 drops the exact zeros of the sparse hinge duals; ``None``
        disables dropping).  Row order is preserved, so with no droppable
        rows and no duplicates the compacted tables are bitwise identical
        to the inputs.

        ``dtype="bf16"`` rounds the SV and coefficient tables to bf16
        (round to nearest even, the same bits as the JAX package).

        ``route_baseline``: pass a precomputed drift baseline to carry it
        through; ``None`` (the default) computes it here from the
        pre-compaction rows.
        """
        sv_cells = np.asarray(sv_cells, np.float32)
        mask_cells = np.asarray(mask_cells, np.float32)
        coef_cells = np.asarray(coef_cells, np.float32)
        c_count, _, t_count, s_count = coef_cells.shape
        p = t_count * s_count
        coef_flat = coef_cells.reshape(c_count, -1, p)

        kept_sv, kept_coefs = [], []
        for c in range(c_count):
            live = mask_cells[c] > 0
            if drop_tol is not None:
                live &= np.abs(coef_flat[c]).max(axis=1) > drop_tol
            sv_c, coef_c = sv_cells[c][live], coef_flat[c][live]
            if dedup and sv_c.shape[0] > 1:
                sv_c, coef_c = _dedup_rows(sv_c, coef_c)
            kept_sv.append(sv_c)
            kept_coefs.append(coef_c)

        k_max = _round_up(max((s.shape[0] for s in kept_sv), default=1),
                          pad_multiple)
        d = sv_cells.shape[2]
        sv = np.zeros((c_count, k_max, d), np.float32)
        coefs = np.zeros((c_count, k_max, p), np.float32)
        counts = np.zeros((c_count,), np.int32)
        for c, (s, co) in enumerate(zip(kept_sv, kept_coefs)):
            sv[c, : s.shape[0]] = s
            coefs[c, : s.shape[0]] = co
            counts[c] = s.shape[0]

        sv_t: Table = sv
        coefs_t: Table = coefs
        if dtype == "bf16":
            sv_t = torch.from_numpy(sv).to(torch.bfloat16)
            coefs_t = torch.from_numpy(coefs).to(torch.bfloat16)
        elif dtype != "f32":
            raise ValueError(f"dtype must be f32|bf16, got {dtype!r}")
        if routing not in ("nearest", "overlap"):
            raise ValueError(f"routing must be nearest|overlap, got {routing!r}")
        centers = np.asarray(centers, np.float32)
        if route_baseline is None:
            route_baseline = _route_baseline(sv_cells, mask_cells, centers)

        if feat_mean is None:
            feat_mean = np.zeros((d,), np.float32)
        if feat_std is None:
            feat_std = np.ones((d,), np.float32)
        return cls(
            sv=sv_t, coefs=coefs_t,
            gammas=np.asarray(gamma_cells, np.float32).reshape(c_count, p),
            sv_count=counts,
            centers=centers,
            feat_mean=np.asarray(feat_mean, np.float32),
            feat_std=np.asarray(feat_std, np.float32),
            classes=(np.zeros((0,), np.float32) if classes is None
                     else np.asarray(classes, np.float32)),
            pairs=(-np.ones((t_count, 2), np.int32) if pairs is None
                   else np.asarray(pairs, np.int32)),
            kernel=kernel, n_tasks=t_count, n_sub=s_count, scenario=scenario,
            raw_sv_total=int((mask_cells > 0).sum()),
            default_sub=int(default_sub), routing=routing,
            version=int(version), route_baseline=route_baseline,
        )

    @classmethod
    def from_trained(cls, model: TrainedSVM, **kwargs) -> "ModelBank":
        """Single-cell bank from one working-set model; its routing center
        is the mean of the live rows."""
        sv = model.sv_x.detach().cpu().numpy().astype(np.float32)
        mask = model.sv_mask.detach().cpu().numpy().astype(np.float32)
        coefs = model.coefs.detach().cpu().numpy().astype(np.float32)
        gamma = model.gamma.detach().cpu().numpy().astype(np.float32)
        denom = max(float(mask.sum()), 1.0)
        center = (sv * mask[:, None]).sum(0, keepdims=True) / denom
        kwargs.setdefault("kernel", model.kernel)
        return cls.from_cells(sv[None], mask[None], coefs[None],
                              gamma[None], center, **kwargs)

    # -------------------------------------------------------------- adapters
    def cell_model(self, c: int, device: Union[str, torch.device] = "cpu"
                   ) -> TrainedSVM:
        """One cell as a TrainedSVM (the per-cell oracle view), f32 on
        ``device``."""
        k = int(self.sv_count[c])
        sv, coefs = self.cell_arrays_f32(device)
        z = torch.zeros((self.n_tasks, self.n_sub), device=device)
        gamma = torch.as_tensor(np.asarray(self.gammas[c], np.float32)
                                .reshape(self.n_tasks, self.n_sub))
        return TrainedSVM(
            sv_x=sv[c, :k], sv_mask=torch.ones((k,), device=device),
            coefs=coefs[c, :k].reshape(k, self.n_tasks, self.n_sub),
            gamma=gamma.to(device), lam=z, tau=z, val_loss=z,
            kernel=self.kernel)

    # --------------------------------------------------------- serialization
    def save(self, ckpt_dir: str, step: int = 0) -> str:
        """Atomic checkpoint write; a server cold-starts from this alone."""
        tree = {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)
                if f.name not in self.META_KEYS}
        extra = {k: getattr(self, k) for k in self.META_KEYS}
        extra["format"] = self.FORMAT
        return ckpt_mod.save_checkpoint(ckpt_dir, step, tree, extra=extra)

    @classmethod
    def load(cls, ckpt_dir: str, step: Optional[int] = None) -> "ModelBank":
        """A bank saved by either package; meta keys it predates take the
        field defaults."""
        extra = ckpt_mod.peek_manifest(ckpt_dir, step)["extra"]
        if extra.get("format") != cls.FORMAT:
            raise ValueError(f"{ckpt_dir} is not a model-bank checkpoint "
                             f"(format={extra.get('format')!r})")
        arrays, extra = ckpt_mod.restore_self_describing(ckpt_dir, step)
        defaults = {f.name: f.default for f in dataclasses.fields(cls)}
        meta = {k: extra.get(k, defaults[k]) for k in cls.META_KEYS}
        return cls(**arrays, **meta)

    def cell_arrays_f32(self, device: Union[str, torch.device]
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(sv, coefs) as f32 tensors on ``device`` — the compute dtype."""
        return (torch.as_tensor(self.sv).to(device=device, dtype=torch.float32),
                torch.as_tensor(self.coefs).to(device=device,
                                               dtype=torch.float32))
