"""GQA attention block: train, prefill (flash) and decode (cache) paths.

Executors, chosen by ``impl``:

  * ``blocked`` and ``pallas`` — ``kernels.flash_attention.ops``, which
    dispatches by the tensor's device: the hand-written kernel (B9) on a
    CUDA tensor, its plain PyTorch version on a CPU tensor;
  * ``train`` — :func:`blocked_attention`, the JAX package's ``blocked``
    executor in plain PyTorch under autograd: an online softmax over kv
    chunks, each chunk step checkpointed.  ``models.model.loss_fn`` runs
    it on every device (the kernels have no backward and refuse operands
    that require grad);
  * ``ref`` — the plain materialised softmax, on any device.

Decode attends one new token against the full KV cache.  With
``impl != "ref"`` it goes to ``kernels.decode_attention.ops``, which on a
CUDA tensor launches the fused decode kernel (B10, the cache streamed in
its stored dtype) and on a CPU tensor runs its plain version; ``ref``
runs the plain ``decode_attention`` below.

The cache is updated IN PLACE: the new token's k/v (int8 plus its scale
for a quantised cache) are written into the cache tensors at the ring
position (:func:`ring_write`; a cache split over the sequence on the
rank that holds the slot), and the returned cache is the same dict.  The
JAX package returns a new cache; in place saves a copy of every layer's
cache per decoded token.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.launch.mesh import is_dtensor
from repro_torch.models import layers
from repro_torch.models.layers import ParamSpec, Template

Tensor = torch.Tensor

NEG_INF = -1e30


def attention_template(d: int, n_heads: int, n_kv: int, head_dim: int,
                       dtype: torch.dtype, fsdp: bool = False,
                       qk_norm: bool = False) -> Template:
    dax = "data" if fsdp else None
    t: Template = {
        "wq": ParamSpec((d, n_heads * head_dim), dtype, (dax, "model"),
                        "fan_in"),
        "wk": ParamSpec((d, n_kv * head_dim), dtype, (dax, "model"),
                        "fan_in"),
        "wv": ParamSpec((d, n_kv * head_dim), dtype, (dax, "model"),
                        "fan_in"),
        "wo": ParamSpec((n_heads * head_dim, d), dtype, ("model", dax),
                        "fan_in"),
    }
    if qk_norm:
        t["q_norm"] = ParamSpec((head_dim,), torch.float32, (None,), "ones")
        t["k_norm"] = ParamSpec((head_dim,), torch.float32, (None,), "ones")
    return t


# --------------------------------------------------------------------------
# executors
# --------------------------------------------------------------------------

def _blocked_step(qf: Tensor, kj: Tensor, vj: Tensor, m_run: Tensor,
                  l_run: Tensor, acc: Tensor, mask: Tensor, scale: float
                  ) -> Tuple[Tensor, Tensor, Tensor]:
    """One kv chunk of the online softmax.  qf (B, T, Hk, G, D) f32; kj, vj
    (B, c, Hk, D); mask (T, c) bool."""
    logit = torch.einsum("bthgd,bshd->bthgs", qf, kj.float()) * scale
    logit = torch.where(mask[None, :, None, None, :], logit,
                        torch.tensor(NEG_INF, device=qf.device))
    m_new = torch.maximum(m_run, torch.amax(logit, dim=-1))
    p = torch.exp(logit - m_new[..., None])
    alpha = torch.exp(m_run - m_new)
    l_new = l_run * alpha + torch.sum(p, dim=-1)
    acc = acc * alpha[..., None] + torch.einsum("bthgs,bshd->bthgd", p,
                                                vj.float())
    return m_new, l_new, acc


def blocked_attention(q: Tensor, k: Tensor, v: Tensor, mask_kind: str,
                      window: int, scale: float, chunk: int) -> Tensor:
    """Online-softmax attention over kv chunks of ``chunk`` columns, in f32
    (the JAX package's ``_blocked_attention``).  q (B, T, H, D); k, v
    (B, S, Hk, D) -> (B, T, H, D) in q's dtype.  Under autograd each chunk
    step is checkpointed: backward recomputes the (T, chunk) probability
    tile instead of keeping every tile."""
    b, t, h, d = q.shape
    s, hk = k.shape[1], k.shape[2]
    g = h // hk
    chunk = min(chunk, s)
    qf = q.float().reshape(b, t, hk, g, d)
    rows = torch.arange(t, device=q.device) + (s - t)
    step = (functools.partial(checkpoint, _blocked_step, use_reentrant=False)
            if torch.is_grad_enabled() else _blocked_step)
    m_run = torch.full((b, t, hk, g), NEG_INF, device=q.device)
    l_run = torch.zeros((b, t, hk, g), device=q.device)
    acc = torch.zeros((b, t, hk, g, d), device=q.device)
    for lo in range(0, s, chunk):
        cols = torch.arange(lo, min(lo + chunk, s), device=q.device)
        if mask_kind == "bidir":
            mask = torch.ones((t, cols.shape[0]), dtype=torch.bool,
                              device=q.device)
        else:
            mask = rows[:, None] >= cols[None, :]
            if mask_kind == "window":
                mask = mask & (rows[:, None] - cols[None, :] < window)
        m_run, l_run, acc = step(qf, k[:, lo:lo + chunk], v[:, lo:lo + chunk],
                                 m_run, l_run, acc, mask, scale)
    out = acc / torch.clamp(l_run, min=1e-30)[..., None]
    return out.reshape(b, t, h, d).to(q.dtype)


def run_attention(q: Tensor, k: Tensor, v: Tensor, mask_kind: str,
                  window: int, scale: float, impl: str = "blocked",
                  chunk: int = 1024) -> Tensor:
    """q (B, T, H, D); k, v (B, S, Hk, D) -> (B, T, H, D)."""
    if impl == "ref":
        from repro_torch.kernels.flash_attention.ref import flash_attention_ref
        return flash_attention_ref(q, k, v, mask_kind, window, scale)
    if impl == "train":
        return blocked_attention(q, k, v, mask_kind, window, scale, chunk)
    if impl not in ("blocked", "pallas"):
        raise ValueError(f"unknown attention impl {impl!r}")
    from repro_torch.kernels.flash_attention.ops import flash_attention
    return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                           mask_kind=mask_kind, window=window)


# --------------------------------------------------------------------------
# the block
# --------------------------------------------------------------------------

def _qk_norm(x: Tensor, w: Tensor) -> Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + 1e-6) * w).to(x.dtype)


def quantize_kv(x: Tensor) -> Tuple[Tensor, Tensor]:
    """Per-(token, head) symmetric int8: scale = max|x| / 127 (floored at
    1e-10), values rounded half to even and clipped to +-127."""
    xf = x.float()
    sc = torch.clamp(torch.amax(torch.abs(xf), dim=-1, keepdim=True) / 127.0,
                     min=1e-10)
    q8 = torch.clamp(torch.round(xf / sc), -127, 127).to(torch.int8)
    return q8, sc


def _split_heads(x: Tensor, n: int, d: int) -> Tensor:
    """(B, T, n d) -> (B, T, n, d).  A DTensor whose last dim is split
    over a mesh dim that does not divide the n heads (gemma3-4b's 8 heads
    over 16 ranks) has that dim gathered first: DTensor cannot unflatten
    an uneven split."""
    if is_dtensor(x):
        from torch.distributed.tensor import Replicate, Shard
        mesh = x.device_mesh
        last = Shard(x.ndim - 1)
        pl = [Replicate() if p == last and n % mesh.size(i) else p
              for i, p in enumerate(x.placements)]
        if pl != list(x.placements):
            x = x.redistribute(mesh, pl)
    return x.reshape(x.shape[0], x.shape[1], n, d)


def attention_block(
    p: Dict[str, Tensor],
    x: Tensor,                     # (B, T, d)
    positions: Tensor,             # (B, T)
    *,
    n_heads: int,
    n_kv: int,
    head_dim: int,
    mask_kind: str = "causal",     # causal | window | bidir
    window: int = 0,
    rope_theta: float = 10000.0,
    rotary_frac: float = 1.0,
    dtype: torch.dtype = torch.bfloat16,
    impl: str = "blocked",
    chunk: int = 1024,                           # kv chunk of ``train``
    cache: Optional[Dict[str, Tensor]] = None,   # (B, S, Hk, D) leaves
    cache_pos: Optional[int] = None,             # write position
) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Returns (out (B, T, d), cache).

    Decode: pass cache + cache_pos with T == 1; the new token is written
    at ``cache_pos mod S`` (in place) and attention runs over the full
    cache.  Prefill: cache is None and the returned {"k", "v"} (the
    rotated keys and the values) become the cache (None in training,
    ``impl == "train"``, where nothing keeps it).  Sharded, prefill and
    training run head-parallel over 'model' where the heads allow it
    (:func:`head_parallel`), else on each rank's rows with every head.
    """
    kw = dict(n_heads=n_heads, n_kv=n_kv, head_dim=head_dim,
              mask_kind=mask_kind, window=window, rope_theta=rope_theta,
              rotary_frac=rotary_frac, dtype=dtype, impl=impl, chunk=chunk)
    if cache is None and head_parallel(x, p, n_heads, n_kv, head_dim):
        return _attention_heads(p, x, positions, **kw)
    q = _split_heads(layers.linear(x, p["wq"], dtype), n_heads, head_dim)
    k = _split_heads(layers.linear(x, p["wk"], dtype), n_kv, head_dim)
    v = _split_heads(layers.linear(x, p["wv"], dtype), n_kv, head_dim)
    b, t = q.shape[:2]
    if "q_norm" in p:
        q = _qk_norm(q, p["q_norm"])
        k = _qk_norm(k, p["k_norm"])
    q = layers.apply_rope(q, positions, rope_theta, rotary_frac)
    k = layers.apply_rope(k, positions, rope_theta, rotary_frac)

    scale = float(head_dim ** -0.5)

    if cache is None:
        if is_dtensor(q):
            # on each rank's own rows, every head whole: a sharded einsum
            # that flattens the batch and head dims cannot be planned
            # without a redistribution
            out = layers.run_on_rows(
                lambda q_, k_, v_: run_attention(q_, k_, v_, mask_kind,
                                                 window, scale, impl, chunk),
                (q, k, v), name="attention")
        else:
            out = run_attention(q, k, v, mask_kind, window, scale, impl,
                                chunk)
        new_cache = {"k": k, "v": v}
    else:
        s = cache["k"].shape[1]
        pos = int(cache_pos) % s          # ring-buffer write position
        new_cache = cache
        quantized = "k_scale" in cache
        for name, new in (("k", k), ("v", v)):
            if quantized:
                q8, sc = quantize_kv(new)
                ring_write(cache[name], q8, pos)
                ring_write(cache[name + "_scale"], sc, pos)
            else:
                ring_write(cache[name], new.to(cache[name].dtype), pos)
        names = ("k", "v") + (("k_scale", "v_scale") if quantized else ())

        def attend(q_, *leaves):
            c = dict(zip(names, leaves))
            dec_window = window if mask_kind == "window" else 0
            if impl != "ref":
                return fused_decode(q_, c, scale, window=dec_window,
                                    cache_pos=int(cache_pos))
            k_eff, v_eff = c["k"], c["v"]
            if quantized:
                k_eff = k_eff.float() * c["k_scale"]
                v_eff = v_eff.float() * c["v_scale"]
            return decode_attention(q_, k_eff, v_eff, scale,
                                    window=dec_window,
                                    cache_pos=int(cache_pos))

        leaves = tuple(cache[n] for n in names)
        if is_dtensor(q):
            # each rank's rows against their whole cache: the sequence
            # split over seq_axes is gathered first
            out = layers.run_on_rows(attend, (q,) + leaves,
                                     name="decode_attention")
        else:
            out = attend(q, *leaves)

    out = out.reshape(b, t, n_heads * head_dim)
    return layers.linear(out, p["wo"], dtype), new_cache


def head_parallel(x, p: Dict[str, Tensor], n_heads: int, n_kv: int,
                  head_dim: int) -> bool:
    """Whether the block runs head-parallel over the mesh's 'model' dim:
    x sharded, wq/wk/wv split there on their columns and wo on its rows,
    the query heads divided evenly, and each rank's query heads reading
    kv heads of its own (``n_kv`` a multiple of the 'model' ranks) or one
    kv head shared with its neighbours (the ranks a multiple of
    ``n_kv``).  Otherwise (gemma3-4b's 8 heads or llama4-maverick's 40
    over 16 ranks) the block runs on each rank's rows with every head."""
    if (not is_dtensor(x) or layers.model_split(x, 0)
            or not all(layers.model_split(p[n], 1) for n in ("wq", "wk", "wv"))
            or not layers.model_split(p["wo"], 0)):
        return False
    m = x.device_mesh.size(x.device_mesh.mesh_dim_names.index("model"))
    return (n_heads % m == 0 and (n_kv % m == 0 or m % n_kv == 0)
            and (n_kv * head_dim) % m == 0)


def _attention_heads(p: Dict[str, Tensor], x, positions: Tensor, *,
                     n_heads: int, n_kv: int, head_dim: int, mask_kind: str,
                     window: int, rope_theta: float, rotary_frac: float,
                     dtype: torch.dtype, impl: str, chunk: int):
    """Head-parallel attention on local shards (a :class:`layers.Region`):
    x's rows with d whole, each rank's n_heads / model query heads (wq's
    column block) and the kv heads they read: wk's and wv's column blocks
    where the kv heads divide over 'model', else the one kv head the
    rank's group of model / n_kv neighbours shares, its columns gathered
    within that group only.  The output times wo's row block is a sum over
    'model', reduce-scattered onto d (or all-reduced) into x's layout."""
    reg = layers.Region(x)
    m = reg.model_size
    xl = reg.act(x)                                     # (B_loc, T, d)
    b, t = xl.shape[:2]
    hl = n_heads // m
    wk, wv = reg.weight(p["wk"]), reg.weight(p["wv"])
    if n_kv % m:                       # the group's kv head, whole
        sub = reg.model_subgroup(m // n_kv)
        wk, wv = (layers.all_gather(w, 1, sub) for w in (wk, wv))
    hkl = wk.shape[1] // head_dim
    q = layers.linear(xl, reg.weight(p["wq"]), dtype).reshape(b, t, hl,
                                                              head_dim)
    k = layers.linear(xl, wk, dtype).reshape(b, t, hkl, head_dim)
    v = layers.linear(xl, wv, dtype).reshape(b, t, hkl, head_dim)
    if "q_norm" in p:
        q = _qk_norm(q, reg.weight(p["q_norm"]))
        k = _qk_norm(k, reg.weight(p["k_norm"]))
    pos = reg.rows(positions)
    q = layers.apply_rope(q, pos, rope_theta, rotary_frac)
    k = layers.apply_rope(k, pos, rope_theta, rotary_frac)
    out = run_attention(q, k, v, mask_kind, window, float(head_dim ** -0.5),
                        impl, chunk)
    layers.trace_region("attention", heads=hl, kv_heads=hkl)
    y = layers.linear(out.reshape(b, t, hl * head_dim),
                      reg.weight(p["wo"]), dtype)
    return reg.out(y), (None if impl == "train"
                        else _heads_cache(reg, k, v, n_kv))


def _heads_cache(reg, k: Tensor, v: Tensor, n_kv: int) -> Dict[str, Tensor]:
    """The prefill cache of head-parallel attention as DTensors (B, T,
    n_kv, D): the local kv heads split over 'model'; a kv head shared by
    several ranks is gathered so that every rank holds them all (the
    reference's cache keeps the heads whole)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    m = reg.model_size
    out = {}
    for name, t in (("k", k), ("v", v)):
        if n_kv % m == 0:
            pl = reg.layout(Shard(2))
        else:
            t = layers.all_gather(t, 2, reg.model_group)[:, :, ::m // n_kv]
            pl = reg.layout(Replicate())
        shape = (reg.like.shape[0],) + tuple(t.shape[1:2]) + (
            n_kv, t.shape[3])
        out[name] = DTensor.from_local(
            t.contiguous(), reg.mesh, pl, run_check=False,
            shape=torch.Size(shape), stride=layers._contiguous_stride(shape))
    return out


def ring_write(dst: Tensor, new: Tensor, pos: int) -> None:
    """``dst[:, pos:pos + T] = new`` in place (dst (B, S, ...), new (B, T,
    ...)).  A DTensor ``dst`` split over its sequence dim is written on
    its local blocks: ``new`` takes dst's layout with that dim whole, and
    each rank writes the slots it holds."""
    t = new.shape[1]
    if not is_dtensor(dst):
        dst[:, pos:pos + t] = new
        return
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    mesh = dst.device_mesh
    pl = [Replicate() if p == Shard(1) else p for p in dst.placements]
    if not is_dtensor(new):       # the same on every rank: replicated
        new = DTensor.from_local(new, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)
    src = new.redistribute(mesh, pl).to_local()
    shape, offset = compute_local_shape_and_global_offset(
        dst.shape, mesh, dst.placements)
    lo, hi = max(pos, offset[1]), min(pos + t, offset[1] + shape[1])
    if lo < hi:
        dst.to_local()[:, lo - offset[1]:hi - offset[1]] = \
            src[:, lo - pos:hi - pos]


def fused_decode(q: Tensor, cache: Dict[str, Tensor], scale: float,
                 window: int, cache_pos: int) -> Tensor:
    """One-token attention through the fused decode kernel (or, for a CPU
    tensor, its plain version).  q (B, 1, H, D); cache leaves
    (B, S, Hk, D) [+ scales].  Returns (B, 1, H, D)."""
    from repro_torch.kernels.decode_attention.ops import decode_attention_fused
    b, t, h, d = q.shape
    hk = cache["k"].shape[2]
    qh = q.reshape(b, hk, h // hk, d)
    out = decode_attention_fused(
        qh, cache["k"], cache["v"], cache_pos, scale,
        k_scale=cache.get("k_scale"), v_scale=cache.get("v_scale"),
        window=window)
    return out.reshape(b, t, h, d)


def decode_attention(q: Tensor, k_cache: Tensor, v_cache: Tensor,
                     scale: float, window: int = 0,
                     cache_pos: Optional[int] = None) -> Tensor:
    """One-token attention over the full cache, materialised in f32.
    q (B, 1, H, D); caches (B, S, Hk, D)."""
    b, t, h, d = q.shape
    s, hk = k_cache.shape[1], k_cache.shape[2]
    g = h // hk
    qf = q.float().reshape(b, t, hk, g, d)
    logits = torch.einsum("bthgd,bshd->bthgs", qf, k_cache.float()) * scale
    if cache_pos is not None:
        idx = torch.arange(s, device=q.device)
        # never-written ring slots (pos < S, idx > pos) must not attend
        valid = (idx <= cache_pos) | (cache_pos >= s)
        if window > 0:
            valid &= torch.remainder(cache_pos - idx, s) < window
        logits = torch.where(valid, logits,
                             torch.tensor(NEG_INF, device=q.device))
    m = torch.amax(logits, dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    l = torch.sum(p, dim=-1, keepdim=True)
    out = torch.einsum("bthgs,bshd->bthgd", p / torch.clamp(l, min=1e-30),
                       v_cache.float())
    return out.reshape(b, t, h, d).to(q.dtype)
