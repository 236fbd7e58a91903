"""Wave-scheduled cell training and the test-phase cell predict (the JAX
package's ``distributed/cell_trainer.py``).

Fine cells are padded and packed (``planner.pack_cells``) into slots; a
wave of slots is one (S, k, ...) batch on the device, and
``core.cv.cv_cell`` solves the whole wave at once: the slot and fold axes
are explicit leading axes of every launch (the reference vmaps them).
With ``cfg.cd_polish > 0`` each gamma step ends in one Gauss-Seidel launch
per epoch over every slot and fold of the wave (B4).  ``ckpt_dir`` saves
each solved wave and restores it on a re-run (kill-anywhere resume).

Several devices: with a ``mesh`` (``launch.mesh``) and ``axis_names``,
the slot axis of a wave is split in blocks over the product of those
mesh dims, in row-major rank order (the reference's ``P(axis_names)``;
dims not named repeat the work).  Each rank solves its block with the
one-device code on its own device, with no communication during the
solve, and the blocks are gathered so that every rank returns the whole
wave (an all-gather along each named mesh dim).  A slot's result does
not depend on the slots beside it (a converged problem is frozen), so on
the CPU the gathered wave equals the one-process solve bitwise.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import cv as cv_mod
from repro_torch.core import kernel_fns, select
from repro_torch.launch import mesh as mesh_mod
from repro_torch.testing import faults
from repro_torch.train import checkpoint as ckpt_mod

_WAVE_KEYS = ("coefs", "gamma", "lam", "tau", "val")
_SURFACE_KEYS = ("surf_loss", "surf_fa", "surf_det")


def wave_keys(cfg: cv_mod.CVConfig) -> Tuple[str, ...]:
    """Names (in output order) of the arrays one wave produces: the
    reference's, plus ``iters`` (box-QP iterations per (gamma, fold))."""
    return (_WAVE_KEYS + (_SURFACE_KEYS if cfg.keep_surface else ())
            + ("iters",))


def _check_split(n_slots: int, mesh, axis_names) -> int:
    """Ranks the slot axis splits over (1 without a mesh or axes); raises
    unless ``n_slots`` divides over them."""
    if mesh is None or not axis_names:
        return 1
    n_dev = mesh_mod.mesh_size(mesh, axis_names)
    if n_slots % n_dev:
        raise ValueError(f"{n_slots} slots do not divide over {n_dev} "
                         f"devices (mesh axes {tuple(axis_names)})")
    return n_dev


def _block(n_slots: int, mesh, axis_names) -> slice:
    """This rank's slots of a wave split over ``axis_names``."""
    n_dev = _check_split(n_slots, mesh, axis_names)
    if n_dev == 1:
        return slice(0, n_slots)
    i = mesh_mod.block_index(mesh, axis_names)
    per = n_slots // n_dev
    return slice(i * per, (i + 1) * per)


def _gather(block: torch.Tensor, mesh, axis_names) -> torch.Tensor:
    """Every rank's block of the slot axis, concatenated in rank order on
    every rank: an all-gather along each named mesh dim, the last one
    first (so the blocks come out row-major over the dims).  Plain c10d
    collectives: DTensor's functional ones crashed gloo with CUDA tensors
    (two ranks on one card, torch 2.11)."""
    if mesh is None or not axis_names:
        return block
    import torch.distributed as dist
    for a in reversed(tuple(axis_names)):
        n = mesh_mod.mesh_size(mesh, a)
        out = block.new_empty((n * block.shape[0],) + tuple(block.shape[1:]))
        dist.all_gather_into_tensor(out, block.contiguous(),
                                    group=mesh.get_group(a))
        block = out
    return block


def _check_mesh_device(mesh, t: torch.Tensor) -> None:
    if mesh is not None and mesh.device_type != t.device.type:
        raise ValueError(f"a {mesh.device_type} mesh with operands on "
                         f"{t.device}")


def train_cells(x_cells: torch.Tensor, y_cells: torch.Tensor,
                tmask_cells: torch.Tensor, mask_cells: torch.Tensor,
                gammas_cells: torch.Tensor, keys: np.ndarray,
                lam_c: torch.Tensor, sub_c: torch.Tensor,
                task_c: torch.Tensor, cfg: cv_mod.CVConfig, n_lam: int,
                n_sub: int, mesh=None, axis_names=None
                ) -> Tuple[torch.Tensor, ...]:
    """One wave: x (S, k, d), y/tmask (S, T, k), mask (S, k), gammas
    (S, G), keys (S, 2) -> the arrays named by :func:`wave_keys`, coefs
    fold-averaged to (S, k, T, Sub).  With a ``mesh``, this rank solves
    its block of the S slots split over ``axis_names`` and every rank
    returns all S."""
    _check_mesh_device(mesh, x_cells)
    b = _block(x_cells.shape[0], mesh, axis_names)
    sel = cv_mod.cv_cell(x_cells[b], y_cells[b], tmask_cells[b],
                         mask_cells[b], gammas_cells[b], lam_c, sub_c,
                         task_c, np.asarray(keys)[b], cfg, n_lam, n_sub)
    combined = select.combine_fold_models(sel.coefs, dim=1)    # (S,k,T,Sub)
    out = (combined, sel.gamma, sel.lam, sel.tau, sel.val_loss)
    if cfg.keep_surface:
        out = out + (sel.val_grid, sel.fa_grid, sel.det_grid)
    return tuple(_gather(o, mesh, axis_names) for o in out + (sel.iters,))


def _to_host(r: torch.Tensor) -> np.ndarray:
    """A wave output as numpy, 64-bit integers narrowed to 32 bits as a
    checkpoint restore gives them: a restored wave and a solved one then
    hand over the same arrays."""
    a = r.cpu().numpy()
    return a.astype(np.int32) if a.dtype == np.int64 else a


def _restorable_waves(ckpt_dir: str, wave_size: int, n_slots: int,
                      fingerprint: Optional[str]) -> set:
    """Steps under ``ckpt_dir`` that this run may restore: each matched on
    its own manifest (``wave_size``, ``n_slots`` and ``fingerprint``); a
    torn manifest is skipped."""
    out = set()
    for s in ckpt_mod.list_steps(ckpt_dir):
        try:
            extra = ckpt_mod.peek_manifest(ckpt_dir, s)["extra"]
        except ckpt_mod.CheckpointCorruptError:
            continue
        if (extra.get("wave_size") == wave_size
                and extra.get("n_slots") == n_slots
                and extra.get("fingerprint") == fingerprint):
            out.add(s)
    return out


def _restore_wave(ckpt_dir: str, w: int, keys_out: Tuple[str, ...]
                  ) -> Tuple[np.ndarray, ...]:
    """Wave ``w``'s arrays from its step directory (checksums verified;
    :class:`~repro_torch.train.checkpoint.CheckpointCorruptError` on a torn
    or bit-rotted shard)."""
    man = ckpt_mod.peek_manifest(ckpt_dir, w)
    target = {k: np.zeros(shape, np.dtype(dt)) for k, shape, dt in zip(
        sorted(keys_out), man["shapes"], man["dtypes"])}
    tree, _, _ = ckpt_mod.restore_checkpoint(ckpt_dir, target, step=w)
    return tuple(np.asarray(tree[k]) for k in keys_out)


def train_cells_waves(stage: Callable[[int, int], tuple], n_slots: int,
                      wave_size: Optional[int], lam_c: torch.Tensor,
                      sub_c: torch.Tensor, task_c: torch.Tensor,
                      cfg: cv_mod.CVConfig, n_lam: int, n_sub: int,
                      device: torch.device, mesh=None, axis_names=None,
                      ckpt_dir: Optional[str] = None,
                      fingerprint: Optional[str] = None):
    """Wave-scheduled :func:`train_cells` with bounded staging.

    ``stage(lo, hi)`` materializes slots [lo, hi) only, as six host arrays
    ``(x, y, tmask, mask, gammas, keys)`` (slots past ``n_slots`` are empty
    padding: zero masks).  Every wave has the same padded slot count.
    Returns the :func:`wave_keys` arrays as numpy, concatenated over waves
    and cut to ``n_slots``.

    ``ckpt_dir`` saves each solved wave as checkpoint step ``w`` (all waves
    kept) with ``wave_size``, ``n_slots`` and ``fingerprint`` (the
    caller's hash of config and data) in its manifest.  A re-run with the
    same directory matches every wave on its own against those three and
    restores it instead of solving it, so a kill anywhere (mid solve, mid
    checkpoint write, between waves) leaves only complete, checksummed
    waves behind.  A wave whose shard fails its checksum is solved again.
    Each wave's solve is deterministic, so the resumed fit equals an
    uninterrupted one bitwise.

    With a ``mesh``, every rank runs this loop in step: each stages the
    whole wave and solves its block (:func:`train_cells`); global rank 0
    writes each solved wave and the ranks meet at a barrier after it;
    every rank reads the directory (after a barrier, before any write) and
    restores the same waves.  A kill site fires on every rank; a kill
    inside rank 0's write takes the job down, as a real kill does."""
    m_solved = obs.metrics.counter("train.waves_solved")
    m_restored = obs.metrics.counter("train.waves_restored")
    m_corrupt = obs.metrics.counter("train.corrupt_waves")
    keys_out = wave_keys(cfg)
    if wave_size is None or wave_size >= n_slots:
        wave_size = n_slots
    if wave_size <= 0:
        raise ValueError(f"wave_size must be positive, got {wave_size}")
    _check_split(wave_size, mesh, axis_names)
    n_waves = -(-n_slots // wave_size)
    restorable = (set() if ckpt_dir is None else
                  _restorable_waves(ckpt_dir, wave_size, n_slots,
                                    fingerprint))
    if ckpt_dir is not None:
        mesh_mod.barrier(mesh)      # every rank has listed the waves
    outs = []
    for w in range(n_waves):
        lo = w * wave_size
        faults.fire("trainer.wave.start", wave=w)
        res = None
        if w in restorable:
            with obs.tracer.span("train.wave.restore") as sp:
                try:
                    res = _restore_wave(ckpt_dir, w, keys_out)
                    m_restored.inc()
                except ckpt_mod.CheckpointCorruptError:
                    m_corrupt.inc()            # torn or bit-rotted: re-solve
                    sp.set(wave=w, corrupt=True)
        if res is None:
            with obs.tracer.span("train.wave", device) as sp:
                sp.set(wave=w, slots=wave_size, cd_polish=cfg.cd_polish)
                with obs.tracer.span("train.stage", device):
                    x, y, tm, m, g, keys = stage(lo, lo + wave_size)
                    dev_arrays = [torch.as_tensor(a).to(device)
                                  for a in (x, y, tm, m, g)]
                res = train_cells(*dev_arrays, np.asarray(keys, np.uint32),
                                  lam_c, sub_c, task_c, cfg, n_lam, n_sub,
                                  mesh=mesh, axis_names=axis_names)
            res = tuple(_to_host(r) for r in res)
            m_solved.inc()
            faults.fire("trainer.wave.solved", wave=w)
            if ckpt_dir is not None:
                with obs.tracer.span("train.wave.checkpoint"):
                    if mesh_mod.writes(mesh):
                        ckpt_mod.save_checkpoint(
                            ckpt_dir, w, dict(zip(keys_out, res)),
                            extra={"wave": w, "wave_size": wave_size,
                                   "n_slots": n_slots,
                                   "fingerprint": fingerprint},
                            keep_last=0)
                    mesh_mod.barrier(mesh)
        outs.append(res)
    return tuple(np.concatenate([o[i] for o in outs])[:n_slots]
                 for i in range(len(keys_out)))


def predict_cells(xt_cells: torch.Tensor, sv_cells: torch.Tensor,
                  coef_cells: torch.Tensor, gamma_cells: torch.Tensor,
                  kernel: str = "gauss_rbf", mesh=None,
                  axis_names=None) -> torch.Tensor:
    """Routed test rows through their cells' models.

    xt (S, m, d), sv (S, k, d), coefs (S, k, T, Sub), gammas (S, T, Sub)
    -> (S, m, T, Sub): one cross D² for the wave (B1), every (slot, task,
    sub) epilogue in one launch (B2), one batched product.  With a
    ``mesh``, this rank predicts its block of slots (split over
    ``axis_names``) and every rank returns all S."""
    _check_mesh_device(mesh, xt_cells)
    b = _block(xt_cells.shape[0], mesh, axis_names)
    out = _predict_block(xt_cells[b], sv_cells[b], coef_cells[b],
                         gamma_cells[b], kernel)
    return _gather(out, mesh, axis_names)


def _predict_block(xt_cells: torch.Tensor, sv_cells: torch.Tensor,
                   coef_cells: torch.Tensor, gamma_cells: torch.Tensor,
                   kernel: str) -> torch.Tensor:
    s, m = xt_cells.shape[:2]
    t, sub = gamma_cells.shape[1:]
    cols = coef_cells.reshape(s, coef_cells.shape[1], t * sub)   # (S, k, P)
    spec = kernel_fns.get_spec(kernel)
    gam = gamma_cells.reshape(s, t * sub).contiguous()
    if spec.factors_through_d2:
        gram_of = kernel_fns.cross_gram_fn(xt_cells, sv_cells, kernel)
        k = gram_of(gam)                                          # (S,P,m,k)
    else:
        k = torch.stack([spec.fn(xt_cells, sv_cells, gam[:, p, None, None])
                         for p in range(t * sub)], dim=1)
    out = torch.matmul(k, cols.transpose(1, 2)[..., None])[..., 0]
    return out.transpose(1, 2).reshape(s, m, t, sub)
