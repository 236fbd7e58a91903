"""LM assembly: one composable stack covering the JAX package's ten
architectures.

An architecture is a ``ModelConfig`` whose ``period_pattern`` lists the
(mixer, mlp) kind of each layer inside one repeating period:

    mixer: attn | attn_local | attn_bidir | mamba | rwkv
    mlp:   dense | moe | rwkv_cm (after rwkv only)

``n_layers = n_periods * len(period) + tail``.  As in the JAX package the
parameters of the full periods are stacked over a leading ``n_periods``
axis (``params["stack"]["pos<i>"]``) and the tail layers have their own
(``params["tail<j>"]``), so the trees carry across one to one; here the
periods run as a Python loop that indexes layer p of each stacked leaf.

Inputs are token ids (``input_kind="tokens"``, looked up in
``embed/tok``) or, for the audio and vision stubs, precomputed frame or
patch features ``(B, T, d_frontend)`` projected to ``d_model`` by
``frontend/proj`` (``input_kind="embed"``: hubert, internvl2).

Entry points:
    loss_fn     {"inputs", "labels"[, "mask"]} -> scalar loss (the
                cross-entropy plus ``aux_loss_weight`` x the MoE layers'
                load-balance loss), under autograd: attention runs the
                plain blocked executor (``attention.blocked_attention``),
                the cross-entropy is chunked over time (``chunked_ce``)
                and, with ``remat``, each period is recomputed in
                backward
    prefill     (B, T) tokens or (B, T, d_frontend) frames -> last logits
                + cache
    decode_step (B, 1) token (or (B, 1, d_frontend)) + cache -> logits +
                cache (cache updated in place: the attention k/v at the
                ring slot, the rwkv and mamba state leaves whole)
    encode      (B, T[, d_frontend]) -> logits at every position (the
                encoder-only hubert; no cache)

Every entry point runs under a mesh too: with DTensor inputs and
parameters, the plain tensors it builds (positions, masks) count as
replicated (``layers.mesh_context``).  Each block of a layer is one
region on local shards from its input to its output, with explicit
collectives over 'model' (``layers.Region``, :func:`_sharded_layer`): the
pre-norm on whole rows, then attention head-parallel (decode:
flash-decoding over the sequence's split), the dense MLP on its ff
blocks, the MoE expert-parallel, rwkv6 by head and mamba by channel, and
the residual add on the local block; the embedding and the
cross-entropy run vocab-parallel and the final norm on whole rows.  What
has no split to use runs on each rank's rows (``layers.run_on_rows``).
No op of a layer of the train step, prefill or encode is planned by
DTensor.  ``decode_step`` takes a cache whose kv leaves are split over
``batch_axes`` and ``seq_axes`` (the reference's ``cache_pspec``): the
new token's k/v are written on the rank that holds its ring slot.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from torch.utils.checkpoint import checkpoint

from repro_torch.launch.mesh import is_dtensor
from repro_torch.models import attention, layers, rwkv6, ssm
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import ParamSpec, Template

Tensor = torch.Tensor

_ATTN = ("attn", "attn_local", "attn_bidir")
_MIXERS = _ATTN + ("mamba", "rwkv")
_MLPS = ("dense", "moe", "rwkv_cm")
_STATEFUL = ("mamba", "rwkv")      # mixers whose decode state is O(1)
_MASK = {"attn": "causal", "attn_local": "window", "attn_bidir": "bidir"}


# --------------------------------------------------------------------------
# config
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    period_pattern: Tuple[Tuple[str, str], ...] = (("attn", "dense"),)
    # attention
    window: int = 0
    rope_theta: float = 10000.0
    rotary_frac: float = 1.0
    qk_norm: bool = False
    attn_impl: str = "blocked"     # blocked | pallas (kernel on CUDA) | ref
    attn_chunk: int = 1024         # kv chunk of the training executor
    kv_cache_dtype: str = "bf16"   # bf16 (the compute dtype) | int8
    # moe
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    n_shared_experts: int = 0      # > 0: one always-on GLU of width d_ff
    moe_chunk: int = 1024          # tokens a routing chunk
    moe_capacity_factor: float = 1.25
    moe_impl: str = "einsum"       # einsum | gather (the same function)
    aux_loss_weight: float = 0.01  # weight of the MoE load-balance loss
    # ssm
    ssm_d_state: int = 16
    ssm_d_conv: int = 4
    ssm_expand: int = 2
    ssm_chunk: int = 256
    # rwkv
    rwkv_head_dim: int = 64
    rwkv_chunk: int = 128
    # frontend
    input_kind: str = "tokens"     # tokens | embed (audio/vision stub)
    d_frontend: int = 0            # embed: width of the input features
    # numerics / structure
    norm: str = "rmsnorm"
    act: str = "silu"
    tie_embeddings: bool = False
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True             # recompute each period in backward
    ce_chunk: int = 2048           # time steps a cross-entropy chunk
    # shard the big matrices' d_model dim over the mesh's data axis too
    # (FSDP), through the templates' partition specs
    fsdp_params: bool = False
    batch_axes: Tuple[str, ...] = ()   # mesh axes the batch is sharded over
    # mesh axes decode caches shard seq over (``launch.shapes``
    # places the caches; decode reads any placement)
    seq_axes: Tuple[str, ...] = ()
    shard_activations: bool = False    # layer-boundary h sharded over
                                       # 'model' on d (big-arch training)

    @property
    def period(self) -> int:
        return len(self.period_pattern)

    @property
    def n_periods(self) -> int:
        return self.n_layers // self.period

    @property
    def tail(self) -> int:
        return self.n_layers - self.n_periods * self.period

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def dt_rank(self) -> int:
        return max(self.d_model // 16, 1)

    @property
    def rwkv_heads(self) -> int:
        return self.d_model // self.rwkv_head_dim

    @property
    def is_decoder(self) -> bool:
        return all(m != "attn_bidir" for m, _ in self.period_pattern)

    def param_count(self) -> int:
        return layers.param_count(build_template(self))


def _constrain(cfg: ModelConfig, x: Tensor) -> Tensor:
    """The reference's layer-boundary sharding constraint: a DTensor
    activation lies with the batch split over ``batch_axes`` (and, with
    ``shard_activations``, d_model over 'model').  The regions return
    their result in that layout, so between layers this only checks it;
    an input that lies otherwise (an embedding run on each rank's rows) is
    redistributed once.  A plain tensor is returned as it is, so one
    device runs unchanged."""
    if not cfg.batch_axes or not is_dtensor(x):
        return x
    spec = ((cfg.batch_axes, None, "model")
            if cfg.shard_activations and x.ndim == 3 else (cfg.batch_axes,))
    if tuple(x.placements) == layers.placements(spec, x.device_mesh):
        return x
    return layers.redistribute(x, spec)


def _check_supported(cfg: ModelConfig) -> None:
    for m, f in cfg.period_pattern:
        if m not in _MIXERS or f not in _MLPS:
            raise ValueError(f"{cfg.name}: unknown layer kind ({m}, {f}); "
                             f"mixers {_MIXERS}, MLPs {_MLPS}")
        if f == "rwkv_cm" and m != "rwkv":
            raise ValueError(f"{cfg.name}: rwkv_cm keeps its shift carry in "
                             f"the rwkv mixer's state; ({m}, {f}) has none")
    if cfg.input_kind not in ("tokens", "embed"):
        raise ValueError(f"{cfg.name}: unknown input_kind "
                         f"{cfg.input_kind!r} (tokens | embed)")


# --------------------------------------------------------------------------
# templates
# --------------------------------------------------------------------------

def _mixer_template(cfg: ModelConfig, kind: str) -> Template:
    if kind == "mamba":
        return ssm.mamba_template(cfg.d_model, cfg.d_inner, cfg.ssm_d_state,
                                  cfg.ssm_d_conv, cfg.dt_rank, cfg.dtype,
                                  cfg.fsdp_params)
    if kind == "rwkv":
        return rwkv6.rwkv6_template(cfg.d_model, cfg.rwkv_heads,
                                    cfg.rwkv_head_dim, cfg.dtype,
                                    cfg.fsdp_params)
    return attention.attention_template(
        cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.dtype,
        cfg.fsdp_params, qk_norm=cfg.qk_norm)


def _mlp_template(cfg: ModelConfig, kind: str) -> Template:
    if kind == "rwkv_cm":
        return rwkv6.channel_mix_template(cfg.d_model, cfg.d_ff, cfg.dtype,
                                          cfg.fsdp_params)
    if kind == "moe":
        return moe_mod.moe_template(
            cfg.d_model, cfg.moe_d_ff, cfg.n_experts, cfg.dtype,
            cfg.fsdp_params, n_shared=cfg.n_shared_experts,
            shared_ff=cfg.d_ff if cfg.n_shared_experts else 0)
    return layers.glu_mlp_template(cfg.d_model, cfg.d_ff, cfg.dtype)


def _layer_template(cfg: ModelConfig, mixer: str, mlp: str) -> Template:
    return {
        "norm1": layers.norm_template(cfg.norm, cfg.d_model),
        "mixer": _mixer_template(cfg, mixer),
        "norm2": layers.norm_template(cfg.norm, cfg.d_model),
        "mlp": _mlp_template(cfg, mlp),
    }


def _stack_template(t: Template, n: int) -> Template:
    """Prepend a period axis to every leaf; remember the true fan-in."""
    def one(ps: ParamSpec) -> ParamSpec:
        fan = (int(np.prod(ps.shape[:-1])) if len(ps.shape) >= 2
               else ps.shape[0])
        return ParamSpec((n,) + ps.shape, ps.dtype, (None,) + ps.spec,
                         ps.init, ps.scale, fan=fan)
    return layers.tree_map(one, t)


def build_template(cfg: ModelConfig) -> Template:
    _check_supported(cfg)
    dax = "data" if cfg.fsdp_params else None
    t: Template = {}
    if cfg.input_kind == "tokens":
        espec = ("model", dax) if cfg.vocab % 64 == 0 else (None, "model")
        t["embed"] = {"tok": ParamSpec((cfg.vocab, cfg.d_model), cfg.dtype,
                                       espec, "normal", 0.02)}
    else:
        t["frontend"] = {"proj": ParamSpec((cfg.d_frontend, cfg.d_model),
                                           cfg.dtype, (None, "model"),
                                           "fan_in")}
    if cfg.n_periods > 0:
        t["stack"] = {f"pos{i}": _stack_template(_layer_template(cfg, m, f),
                                                 cfg.n_periods)
                      for i, (m, f) in enumerate(cfg.period_pattern)}
    for j in range(cfg.tail):
        t[f"tail{j}"] = _layer_template(cfg, *cfg.period_pattern[j])
    t["final_norm"] = layers.norm_template(cfg.norm, cfg.d_model)
    if not cfg.tie_embeddings:
        # a small class head (hubert's 504 codebook classes) is replicated
        # over the model axis, as the reference does
        vspec = (dax, "model") if cfg.vocab % 64 == 0 else (dax, None)
        t["lm_head"] = {"w": ParamSpec((cfg.d_model, cfg.vocab), cfg.dtype,
                                       vspec, "fan_in")}
    return t


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: Optional[torch.device] = None) -> Dict[str, Any]:
    """Seed-initialised parameters (the frozen random-features backbone)."""
    return layers.init_params(build_template(cfg), generator, device)


# --------------------------------------------------------------------------
# caches (decode state)
# --------------------------------------------------------------------------

class TensorSpec(NamedTuple):
    shape: Tuple[int, ...]
    dtype: torch.dtype


def _layer_cache(cfg: ModelConfig, mixer: str, batch: int, seq: int
                 ) -> Dict[str, TensorSpec]:
    if mixer == "mamba":
        # O(1) in seq: the conv's last d_conv - 1 inputs and the scan state
        f32 = torch.float32
        return {"conv": TensorSpec((batch, cfg.ssm_d_conv - 1, cfg.d_inner),
                                   f32),
                "ssm": TensorSpec((batch, cfg.d_inner, cfg.ssm_d_state),
                                  f32)}
    if mixer == "rwkv":
        # O(1) in seq: the two token-shift carries and the wkv state
        f32 = torch.float32
        kd = cfg.rwkv_head_dim
        return {"shift": TensorSpec((batch, 1, cfg.d_model), f32),
                "wkv": TensorSpec((batch, cfg.rwkv_heads, kd, kd), f32),
                "shift_ffn": TensorSpec((batch, 1, cfg.d_model), f32)}
    kv_shape = (batch, seq, cfg.n_kv_heads, cfg.head_dim)
    if cfg.kv_cache_dtype == "int8":
        sc_shape = (batch, seq, cfg.n_kv_heads, 1)
        return {"k": TensorSpec(kv_shape, torch.int8),
                "v": TensorSpec(kv_shape, torch.int8),
                "k_scale": TensorSpec(sc_shape, torch.float32),
                "v_scale": TensorSpec(sc_shape, torch.float32)}
    return {"k": TensorSpec(kv_shape, cfg.dtype),
            "v": TensorSpec(kv_shape, cfg.dtype)}


def cache_struct(cfg: ModelConfig, batch: int, seq: int) -> Dict[str, Any]:
    """TensorSpec tree describing the decode cache."""
    _check_supported(cfg)
    out: Dict[str, Any] = {}
    if cfg.n_periods > 0:
        out["stack"] = {
            f"pos{i}": {k: TensorSpec((cfg.n_periods,) + s.shape, s.dtype)
                        for k, s in _layer_cache(cfg, m, batch, seq).items()}
            for i, (m, _) in enumerate(cfg.period_pattern)}
    for j in range(cfg.tail):
        out[f"tail{j}"] = _layer_cache(cfg, cfg.period_pattern[j][0], batch,
                                       seq)
    return out


def init_cache(cfg: ModelConfig, batch: int, seq: int,
               device: Optional[torch.device] = None) -> Dict[str, Any]:
    return layers.tree_map(
        lambda s: torch.zeros(s.shape, dtype=s.dtype, device=device),
        cache_struct(cfg, batch, seq))


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------

def _apply_mixer(cfg: ModelConfig, kind: str, p, h: Tensor,
                 positions: Tensor, cache, pos, impl: str
                 ) -> Tuple[Tensor, Dict[str, Tensor]]:
    if kind == "mamba":
        out, new = ssm.mamba_mixer(
            p, h, d_inner=cfg.d_inner, d_state=cfg.ssm_d_state,
            d_conv=cfg.ssm_d_conv, dt_rank=cfg.dt_rank, dtype=cfg.dtype,
            chunk=cfg.ssm_chunk,
            state=None if cache is None else ssm.SSMState(cache["conv"],
                                                          cache["ssm"]))
        return out, {"conv": new.conv, "ssm": new.ssm}
    if kind == "rwkv":
        out, s_end, carry = rwkv6.rwkv6_mixer(
            p, h, n_heads=cfg.rwkv_heads, head_dim=cfg.rwkv_head_dim,
            dtype=cfg.dtype, chunk=cfg.rwkv_chunk,
            state=None if cache is None else cache["wkv"],
            shift_carry=None if cache is None else cache["shift"])
        return out, {"wkv": s_end, "shift": carry}
    return attention.attention_block(
        p, h, positions, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
        head_dim=cfg.head_dim, mask_kind=_MASK[kind], window=cfg.window,
        rope_theta=cfg.rope_theta, rotary_frac=cfg.rotary_frac,
        dtype=cfg.dtype, impl=impl, chunk=cfg.attn_chunk, cache=cache,
        cache_pos=pos)


def _apply_mlp(cfg: ModelConfig, kind: str, p, h: Tensor, cache
               ) -> Tuple[Tensor, Optional[Tensor], Optional[Tensor]]:
    """Returns (out, the MoE aux loss or None, the channel mix's new shift
    carry or None)."""
    if kind == "rwkv_cm":
        carry = (torch.zeros((h.shape[0], 1, cfg.d_model),
                             dtype=torch.float32, device=h.device)
                 if cache is None else cache["shift_ffn"])
        out, carry = rwkv6.channel_mix(p, h, carry, cfg.dtype)
        return out, None, carry
    if kind == "moe":
        out, aux = moe_mod.moe_mlp(
            p, h, top_k=cfg.top_k, n_experts=cfg.n_experts, act=cfg.act,
            dtype=cfg.dtype, capacity_factor=cfg.moe_capacity_factor,
            chunk=cfg.moe_chunk, impl=cfg.moe_impl)
        return out, aux, None
    return layers.glu_mlp(p, h, cfg.act, cfg.dtype), None, None


def _layer(cfg: ModelConfig, mixer: str, mlp: str, p, h: Tensor,
           positions: Tensor, cache, pos, impl: str
           ) -> Tuple[Tensor, Optional[Tensor], Dict[str, Tensor]]:
    """Pre-norm residual layer.  Returns (h, the MoE aux loss or None,
    layer cache).  With a cache (decode) the attention k/v are written in
    place by the block; the rwkv and mamba state leaves are copied into
    the cache here, so the caller's stacked cache holds the new state
    too.  Sharded, each block runs as a region (:func:`_sharded_layer`)."""
    if is_dtensor(h):
        return _sharded_layer(cfg, mixer, mlp, p, h, positions, cache, pos,
                              impl)
    mixed, new_cache = _apply_mixer(
        cfg, mixer, p["mixer"], layers.apply_norm(cfg.norm, h, p["norm1"]),
        positions, cache, pos, impl)
    h = h + mixed
    out, aux, cm_carry = _apply_mlp(
        cfg, mlp, p["mlp"], layers.apply_norm(cfg.norm, h, p["norm2"]),
        cache)
    if cm_carry is not None:
        new_cache["shift_ffn"] = cm_carry
    return h + out, aux, _keep_state(mixer, cache, new_cache)


def _keep_state(mixer: str, cache, new_cache):
    """A recurrent mixer's new state copied into its decode cache."""
    if cache is None or mixer not in _STATEFUL:
        return new_cache
    for name, leaf in new_cache.items():
        dst = cache[name]
        if is_dtensor(dst):   # the new state in the cache's layout
            leaf = leaf.redistribute(dst.device_mesh, dst.placements)
        dst.copy_(leaf)
    return cache


def _sharded_layer(cfg: ModelConfig, mixer: str, mlp: str, p, h,
                   positions: Tensor, cache, pos, impl: str):
    """The layer under a mesh: each block one region from h to h + block
    (norm(h)), norm, block and residual on local shards
    (``layers.Region``); what it returns lies in h's layout, which
    :func:`_constrain` then only checks.  A recurrent mixer's decode step
    (one token against its O(1) state) runs on DTensor's own ops."""
    n1, n2 = (cfg.norm, p["norm1"]), (cfg.norm, p["norm2"])
    if mixer in _STATEFUL and cache is not None:
        mixed, new_cache = _apply_mixer(
            cfg, mixer, p["mixer"], layers.apply_norm(cfg.norm, h,
                                                      p["norm1"]),
            positions, cache, pos, impl)
        h = h + mixed
    elif mixer == "rwkv":
        h, new_cache = rwkv6.rwkv6_layer(
            p["mixer"], h, n1, n_heads=cfg.rwkv_heads,
            head_dim=cfg.rwkv_head_dim, dtype=cfg.dtype, chunk=cfg.rwkv_chunk)
    elif mixer == "mamba":
        h, new_cache = ssm.mamba_layer(
            p["mixer"], h, n1, d_inner=cfg.d_inner, d_state=cfg.ssm_d_state,
            d_conv=cfg.ssm_d_conv, dt_rank=cfg.dt_rank, dtype=cfg.dtype,
            chunk=cfg.ssm_chunk)
    else:
        h, new_cache = attention.attention_layer(
            p["mixer"], h, positions, n1, cache=cache, cache_pos=pos,
            n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, head_dim=cfg.head_dim,
            mask_kind=_MASK[mixer], window=cfg.window,
            rope_theta=cfg.rope_theta, rotary_frac=cfg.rotary_frac,
            dtype=cfg.dtype, impl=impl, chunk=cfg.attn_chunk)
    h = _constrain(cfg, h)
    aux = None
    if mlp == "moe":
        h, aux = moe_mod.moe_mlp(
            p["mlp"], h, top_k=cfg.top_k, n_experts=cfg.n_experts,
            act=cfg.act, dtype=cfg.dtype,
            capacity_factor=cfg.moe_capacity_factor, chunk=cfg.moe_chunk,
            impl=cfg.moe_impl, norm=n2)
    elif mlp == "rwkv_cm":
        h, new_cache["shift_ffn"] = rwkv6.channel_mix_layer(
            p["mlp"], h, n2, None if cache is None else cache["shift_ffn"],
            cfg.dtype)
    else:
        h = layers.glu_mlp_region(p["mlp"], h, n2, cfg.act, cfg.dtype)
    return _constrain(cfg, h), aux, _keep_state(mixer, cache, new_cache)


def _embed_in(cfg: ModelConfig, params, x: Tensor) -> Tensor:
    if cfg.input_kind == "embed":
        return layers.linear(x.to(cfg.dtype), params["frontend"]["proj"],
                             cfg.dtype)
    h = layers.embed_lookup(params["embed"]["tok"], x, cfg.dtype,
                            shard_d=cfg.shard_activations
                            and bool(cfg.batch_axes))
    if cfg.tie_embeddings:
        # gemma-style: sqrt(d) rounded to the dtype, the product rounded
        # once (exact in f32 before that rounding: both factors are bf16)
        h = h * float(torch.tensor(cfg.d_model ** 0.5, dtype=cfg.dtype))
    return h


def _index(tree, p: int):
    """Layer p of a stacked (leading n_periods axis) parameter/cache tree."""
    return {k: _index(v, p) if isinstance(v, dict) else v[p]
            for k, v in tree.items()}


def _add_aux(total: Tensor, aux: Optional[Tensor]) -> Tensor:
    return total if aux is None else total + aux


def _period(cfg: ModelConfig, pp, h: Tensor, aux: Tensor,
            positions: Tensor, caches, pos, impl: str
            ) -> Tuple[Tensor, Tensor, List[Dict[str, Tensor]]]:
    """One period of layers: pp / caches hold each position's tree; aux
    accumulates the MoE layers' load-balance losses."""
    out = []
    for i, (m, f) in enumerate(cfg.period_pattern):
        h, a, nc = _layer(cfg, m, f, pp[i], h, positions, caches[i], pos,
                          impl)
        aux = _add_aux(aux, a)
        out.append(nc)
    return h, aux, out


def backbone(cfg: ModelConfig, params, x: Tensor, positions: Tensor,
             cache: Optional[Dict] = None, pos: Optional[int] = None,
             collect_cache: bool = False, train: bool = False
             ) -> Tuple[Tensor, Tensor, Optional[Dict]]:
    """-> (hidden (B, T, d), aux loss (f32 scalar: the sum of the MoE
    layers' load-balance losses, 0 without one), cache).

    cache=None + collect_cache=True is the prefill path: each layer's
    full-sequence k/v (or rwkv / mamba end state) are collected and
    stacked like the parameters.  With a cache (decode) the cache is
    updated in place and returned.  ``train`` runs attention through the
    plain blocked executor (differentiable on every device) and, with
    ``cfg.remat``, recomputes each period in backward.
    """
    _check_supported(cfg)
    impl = "train" if train and cfg.attn_impl != "ref" else cfg.attn_impl
    h = _constrain(cfg, _embed_in(cfg, params, x))
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    decoding = cache is not None
    collect = decoding or collect_cache
    new_cache: Optional[Dict] = {} if collect else None
    remat = (train and cfg.remat and not collect
             and torch.is_grad_enabled())

    if cfg.n_periods > 0:
        per_pos: List[List[Dict[str, Tensor]]] = [[] for _ in range(cfg.period)]
        none = [None] * cfg.period
        for p in range(cfg.n_periods):
            pp = [_index(params["stack"][f"pos{i}"], p)
                  for i in range(cfg.period)]
            lcs = ([_index(cache["stack"][f"pos{i}"], p)
                    for i in range(cfg.period)] if decoding else none)
            if remat:
                h, aux = checkpoint(lambda h_, a_, pp_=pp: _period(
                    cfg, pp_, h_, a_, positions, none, pos, impl)[:2], h,
                    aux, use_reentrant=False)
                continue
            h, aux, ncs = _period(cfg, pp, h, aux, positions, lcs, pos,
                                  impl)
            if collect_cache and not decoding:
                for i, nc in enumerate(ncs):
                    per_pos[i].append(nc)
        if decoding:
            new_cache["stack"] = cache["stack"]
        elif collect:
            new_cache["stack"] = {
                f"pos{i}": {k: torch.stack([c[k] for c in per_pos[i]])
                            for k in per_pos[i][0]}
                for i in range(cfg.period)}

    for j in range(cfg.tail):
        m, f = cfg.period_pattern[j]
        cc = cache[f"tail{j}"] if decoding else None
        h, a, nc = _layer(cfg, m, f, params[f"tail{j}"], h, positions, cc,
                          pos, impl)
        aux = _add_aux(aux, a)
        if collect:
            new_cache[f"tail{j}"] = nc

    h = (layers.norm_region(cfg.norm, h, params["final_norm"])
         if is_dtensor(h) else
         layers.apply_norm(cfg.norm, h, params["final_norm"]))
    return h, aux, new_cache


def _head_matrix(cfg: ModelConfig, params) -> Tensor:
    if cfg.tie_embeddings:
        return params["embed"]["tok"].T
    return params["lm_head"]["w"]


def logits_fn(cfg: ModelConfig, params, h: Tensor) -> Tensor:
    """Unchunked logits — only for small shapes / last-position decode."""
    return layers.linear(h, _head_matrix(cfg, params), cfg.dtype).float()


def _positions(b: int, t: int, start: int, device) -> Tensor:
    return (torch.arange(t, dtype=torch.int32, device=device)
            + start)[None].expand(b, t)


def chunked_ce(cfg: ModelConfig, params, h: Tensor, labels: Tensor,
               mask: Optional[Tensor] = None) -> Tensor:
    """Mean cross-entropy over the unmasked positions, without forming the
    (T, vocab) logits at once: ``ce_chunk`` time steps at a time.  h (B,
    T, d); the head's operands are rounded to the compute dtype and the
    logits are accumulated and kept in f32 (the reference's
    ``preferred_element_type``).  Sharded, a head matrix whose vocabulary
    is split over 'model' runs vocab-parallel (:func:`_ce_vocab_parallel`);
    any other sums each rank's own rows against the whole head matrix
    (``layers.run_on_rows``)."""
    w = _head_matrix(cfg, params)
    if is_dtensor(h) and layers.model_split(w, 1):
        loss_sum, count = _ce_vocab_parallel(cfg, h, w, labels, mask)
    elif is_dtensor(h):
        loss_sum, count = layers.run_on_rows(
            lambda h_, l_, m_, w_: _ce_sums(cfg, h_, w_, l_, m_),
            (h, labels, mask), (w,), sums=True, name="ce")
    else:
        loss_sum, count = _ce_sums(cfg, h, w, labels, mask)
    return loss_sum / torch.clamp(count, min=1.0)


def _ce_sums(cfg: ModelConfig, h: Tensor, w: Tensor, labels: Tensor,
             mask: Optional[Tensor]) -> Tuple[Tensor, Tensor]:
    """(sum of the cross-entropy over the unmasked positions, their
    count), chunk by chunk over time."""
    b, t, _ = h.shape
    w = w.to(cfg.dtype).float()
    if mask is None:
        mask = torch.ones((b, t), dtype=torch.float32, device=h.device)
    chunk = min(cfg.ce_chunk, t)
    loss_sum = torch.zeros((), dtype=torch.float32, device=h.device)
    count = torch.zeros((), dtype=torch.float32, device=h.device)
    for lo in range(0, t, chunk):
        logit = h[:, lo:lo + chunk].to(cfg.dtype).float() @ w
        lse = torch.logsumexp(logit, dim=-1)
        gold = torch.gather(logit, -1,
                            labels[:, lo:lo + chunk, None].long())[..., 0]
        mi = mask[:, lo:lo + chunk].float()
        loss_sum = loss_sum + torch.sum((lse - gold) * mi)
        count = count + torch.sum(mi)
    return loss_sum, count


def _ce_vocab_parallel(cfg: ModelConfig, h, w, labels, mask
                       ) -> Tuple[Tensor, Tensor]:
    """The cross-entropy sums on local shards (a ``layers.Region``): each
    rank's rows of h with d whole against its block of the vocabulary,
    chunk by chunk as :func:`_ce_sums`: the f32 logits of the block, the
    row max by an all-reduce max over 'model' (detached), the sum of
    exponentials by an all-reduce, the gold logit from the rank that owns
    it (an all-reduce of the masked value).  Each rank's logits get
    softmax minus one-hot on its own block as their gradient, and h the
    sum of the blocks' parts."""
    reg = layers.Region(h)
    hl = reg.act(h)                                    # (B_loc, T, d)
    wl = reg.weight(w).to(cfg.dtype).float()           # (d, V_loc)
    v0, n = layers.local_offset(w)[1], wl.shape[1]
    lab = reg.rows(labels).long() - v0
    b, t, _ = hl.shape
    mk = reg.rows(mask)
    if mk is None:
        mk = torch.ones((b, t), dtype=torch.float32, device=hl.device)
    g = reg.model_group
    chunk = min(cfg.ce_chunk, t)
    loss_sum = torch.zeros((), dtype=torch.float32, device=hl.device)
    count = torch.zeros((), dtype=torch.float32, device=hl.device)
    for lo in range(0, t, chunk):
        logit = hl[:, lo:lo + chunk].to(cfg.dtype).float() @ wl
        mx = layers.all_reduce_max(torch.amax(logit, dim=-1), g)
        se = layers.all_reduce(torch.sum(torch.exp(logit - mx[..., None]),
                                         dim=-1), g)
        li = lab[:, lo:lo + chunk]
        own = (li >= 0) & (li < n)
        gold = torch.gather(logit, -1, torch.where(
            own, li, torch.zeros_like(li))[..., None])[..., 0]
        gold = layers.all_reduce(torch.where(own, gold, torch.zeros_like(
            gold)), g)
        mi = mk[:, lo:lo + chunk].float()
        loss_sum = loss_sum + torch.sum((mx + torch.log(se) - gold) * mi)
        count = count + torch.sum(mi)
    layers.trace_region("ce", vocab_cols=n)
    return reg.sums(loss_sum, count)


def loss_fn(cfg: ModelConfig, params, batch: Dict[str, Tensor]) -> Tensor:
    """batch: {"inputs": (B, T) int or (B, T, d_frontend) float, "labels":
    (B, T) int, optional "mask": (B, T)}.  The scalar cross-entropy plus
    ``aux_loss_weight`` x the MoE layers' load-balance loss."""
    x = batch["inputs"]
    b, t = batch["labels"].shape
    with layers.mesh_context(x):
        h, aux, _ = backbone(cfg, params, x, _positions(b, t, 0, x.device),
                             train=True)
        ce = chunked_ce(cfg, params, h, batch["labels"], batch.get("mask"))
        return ce + cfg.aux_loss_weight * aux


@torch.no_grad()
def prefill(cfg: ModelConfig, params, x: Tensor) -> Tuple[Tensor, Dict[str, Any]]:
    """Prefill pass: returns (last-position logits (B, vocab) f32, cache).

    The returned attention caches have length T (the prompt); the serve
    layer pads them to the generation budget before decode_step."""
    b, t = x.shape[0], x.shape[1]
    with layers.mesh_context(x):
        h, _, new_cache = backbone(cfg, params, x,
                                   _positions(b, t, 0, x.device),
                                   collect_cache=True)
        logits = layers.linear(h[:, -1:], _head_matrix(cfg, params),
                               cfg.dtype).float()[:, 0]
    return logits, new_cache


@torch.no_grad()
def decode_step(cfg: ModelConfig, params, token: Tensor,
                cache: Dict[str, Any], pos: int
                ) -> Tuple[Tensor, Dict[str, Any]]:
    """token (B, 1) (or (B, 1, d_frontend) for an embed front end); pos
    the position of the token (its cache slot is pos mod S).  Returns
    (logits (B, vocab) f32, the updated cache)."""
    b = token.shape[0]
    with layers.mesh_context(token):
        h, _, new_cache = backbone(cfg, params, token,
                                   _positions(b, 1, int(pos), token.device),
                                   cache=cache, pos=int(pos))
        logits = layers.linear(h[:, -1], _head_matrix(cfg, params),
                               cfg.dtype).float()
    return logits, new_cache


@torch.no_grad()
def encode(cfg: ModelConfig, params, x: Tensor) -> Tensor:
    """Encoder-only (hubert): logits (B, T, vocab) f32 at every position,
    one unchunked head over the small vocabulary."""
    b, t = x.shape[0], x.shape[1]
    with layers.mesh_context(x):
        h, _, _ = backbone(cfg, params, x, _positions(b, t, 0, x.device))
        return logits_fn(cfg, params, h)
