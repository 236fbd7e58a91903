"""input_specs(): stand-ins with no storage for every (arch x shape) cell.

A *struct* (:class:`Struct`) is a meta tensor of a leaf's global shape
and dtype beside its partition spec and its DTensor placements on the
mesh: what the dry run needs to build the cell's step on fake tensors
(``launch.dryrun``), and nothing is allocated.  This module also owns the
per-(arch, shape, mesh) config adaptation: batch / sequence sharding axes,
activation sharding, the grad-accum factor and the optimizer's dtype
policy (the JAX package's ``launch/shapes.py``, name for name).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs import ArchSpec, get_arch
from repro_torch.configs.common import ShapeSpec
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import layers, model as model_mod
from repro_torch.models.model import ModelConfig
from repro_torch.train.optimizer import OptConfig

# per-arch optimizer dtype policy
OPT_POLICY: Dict[str, str] = {
    "command-r-plus-104b": "bf16_mom",
    "internvl2-76b": "bf16_mom",
    "jamba-v0.1-52b": "bf16_mom",
    "qwen3-moe-235b-a22b": "pure_bf16",
    "llama4-maverick-400b-a17b": "pure_bf16",
}

# microbatch accumulation for train_4k (activation-memory control)
GRAD_ACCUM: Dict[str, int] = {
    "command-r-plus-104b": 4,
    "internvl2-76b": 4,
    "qwen3-moe-235b-a22b": 4,
    "llama4-maverick-400b-a17b": 4,
    "jamba-v0.1-52b": 2,
}


class Struct(NamedTuple):
    """A leaf that allocates nothing: ``meta`` (a meta tensor of the
    global shape and dtype), its partition ``spec`` (the reference's
    ``PartitionSpec`` as a tuple) and its ``placements`` on the mesh."""
    meta: torch.Tensor
    spec: Tuple[Any, ...]
    placements: tuple

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.meta.shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.meta.dtype


def adapt_config(arch: ArchSpec, shape: ShapeSpec, mesh) -> ModelConfig:
    """Mesh/shape-aware copy of the full config.  Reads only the mesh's
    dim names (``mesh_dim_names``) and sizes (``shape``)."""
    cfg = arch.config
    baxes = mesh_mod.batch_axes(mesh)
    n_b = mesh_mod.n_batch_shards(mesh)
    kw: Dict[str, Any] = {}
    if shape.kind == "train":
        kw["batch_axes"] = baxes
        kw["shard_activations"] = True
        kw["remat"] = True
    elif shape.kind in ("prefill", "encode"):
        kw["batch_axes"] = baxes if shape.global_batch % n_b == 0 else ()
        kw["shard_activations"] = shape.global_batch % n_b == 0
        kw["remat"] = False
    else:  # decode
        kw["remat"] = False
        kw["shard_activations"] = False
        if shape.global_batch % n_b == 0:
            kw["batch_axes"] = baxes
            kw["seq_axes"] = ("model",)
        else:  # long_500k batch 1: the sequence over the whole mesh
            kw["batch_axes"] = ()
            kw["seq_axes"] = tuple(mesh.mesh_dim_names)
    return dataclasses.replace(cfg, **kw)


def opt_config(arch_id: str, total_steps: int = 10000) -> OptConfig:
    return OptConfig(policy=OPT_POLICY.get(arch_id, "fp32"),
                     total_steps=total_steps)


def grad_accum(arch_id: str, shape: ShapeSpec) -> int:
    if shape.kind != "train":
        return 1
    return GRAD_ACCUM.get(arch_id, 1)


# --------------------------------------------------------------------------
# struct builders
# --------------------------------------------------------------------------

def _struct(shape, dtype, mesh, spec) -> Struct:
    return Struct(torch.empty(tuple(shape), dtype=dtype, device="meta"),
                  tuple(spec), layers.placements(spec, mesh))


def param_structs(cfg: ModelConfig, mesh):
    tmpl = model_mod.build_template(cfg)
    return layers.tree_map(lambda pair, spec: Struct(pair[0], spec, pair[1]),
                           layers.shape_tree(tmpl, mesh),
                           layers.spec_tree(tmpl))


def param_shardings(cfg: ModelConfig, mesh):
    return layers.sharding_tree(model_mod.build_template(cfg), mesh)


def opt_structs(cfg: ModelConfig, ocfg: OptConfig, mesh):
    """OptState structs congruent with the params tree (the step counter
    is a host scalar, as ``init_opt_state`` makes it)."""
    from repro_torch.train.optimizer import _POLICIES, OptState
    mdt, sdt = _POLICIES[ocfg.policy]
    tmpl = model_mod.build_template(cfg)

    def of(dt):
        return layers.tree_map(lambda ps: _struct(ps.shape, dt, mesh, ps.spec),
                               tmpl)

    return OptState(step=_struct((), torch.int32, mesh, ()),
                    master=of(mdt), m=of(sdt), v=of(sdt))


def _inputs(cfg: ModelConfig, b: int, t: int, mesh) -> Struct:
    bspec = cfg.batch_axes or None
    if cfg.input_kind == "tokens":
        return _struct((b, t), torch.int32, mesh, (bspec, None))
    return _struct((b, t, cfg.d_frontend), torch.bfloat16, mesh,
                   (bspec, None, None))


def batch_structs(cfg: ModelConfig, shape: ShapeSpec, mesh):
    """Training batch {"inputs", "labels", "mask"}."""
    b, t = shape.global_batch, shape.seq_len
    bspec = cfg.batch_axes or None
    return {
        "inputs": _inputs(cfg, b, t, mesh),
        "labels": _struct((b, t), torch.int32, mesh, (bspec, None)),
        "mask": _struct((b, t), torch.float32, mesh, (bspec, None)),
    }


def prefill_structs(cfg: ModelConfig, shape: ShapeSpec, mesh) -> Struct:
    return _inputs(cfg, shape.global_batch, shape.seq_len, mesh)


def cache_structs(cfg: ModelConfig, shape: ShapeSpec, mesh):
    """Decode cache structs: kv leaves, and an int8 cache's scales with
    them, split over the batch and the sequence (flash-decoding: each
    rank holds its block of the ring with the scales of its keys);
    recurrent states over the batch.  (The reference's test of the head
    dim leaves its (B, S, Hk, 1) scales to the recurrent states' rule,
    replicated over the sequence.)"""
    b, s = shape.global_batch, shape.seq_len
    tree = model_mod.cache_struct(cfg, b, s)
    bspec = cfg.batch_axes or None
    sspec = cfg.seq_axes or None

    def one(sd: model_mod.TensorSpec) -> Struct:
        nd = len(sd.shape)
        # kv caches: (..., B, S, Hk, D)
        if nd >= 4 and sd.shape[-1] in (cfg.head_dim, 1) \
                and sd.shape[-2] == cfg.n_kv_heads and sd.shape[-3] == s:
            lead = (None,) * (nd - 4)
            return _struct(sd.shape, sd.dtype, mesh,
                           lead + (bspec, sspec, None, None))
        # O(1) recurrent states: shard batch if possible, else replicate
        spec = [None] * nd
        # batch dim position: stacked states carry it at axis 1, tail at 0
        if bspec is not None and b > 1:
            for cand in (0, 1):
                if cand < nd and sd.shape[cand] == b:
                    spec[cand] = bspec
                    break
        return _struct(sd.shape, sd.dtype, mesh, tuple(spec))

    return layers.tree_map(one, tree)


def decode_token_structs(cfg: ModelConfig, shape: ShapeSpec, mesh) -> Struct:
    return _inputs(cfg, shape.global_batch, 1, mesh)


def input_specs(arch_id: str, shape_name: str, mesh,
                overrides: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Everything needed to build the cell's step function.

    ``overrides``: ModelConfig field overrides (perf-variant runs, e.g.
    {"kv_cache_dtype": "int8"}), and ``grad_accum``.
    Returns {"kind", "cfg", "shape", "args": tuple of structs, ...}; a
    decode cell's last argument is the position, a plain int."""
    arch = get_arch(arch_id)
    shape = arch.shape(shape_name)
    cfg = adapt_config(arch, shape, mesh)
    accum_override = None
    if overrides:
        overrides = dict(overrides)
        accum_override = overrides.pop("grad_accum", None)
        cfg = dataclasses.replace(cfg, **overrides)
    out: Dict[str, Any] = {"kind": shape.kind, "cfg": cfg, "shape": shape}
    params = param_structs(cfg, mesh)
    if shape.kind == "train":
        ocfg = opt_config(arch_id)
        out["opt_cfg"] = ocfg
        out["grad_accum"] = accum_override or grad_accum(arch_id, shape)
        out["args"] = (params, opt_structs(cfg, ocfg, mesh),
                       batch_structs(cfg, shape, mesh))
    elif shape.kind in ("prefill", "encode"):
        out["args"] = (params, prefill_structs(cfg, shape, mesh))
    else:
        # the reference's position is a traced int32 scalar; here the
        # last slot of the ring, so that every visible key is attended
        out["args"] = (params, decode_token_structs(cfg, shape, mesh),
                       cache_structs(cfg, shape, mesh), shape.seq_len - 1)
    return out
