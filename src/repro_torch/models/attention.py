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

Under a mesh the layer is one region on local shards (:func:`attention_layer`):
prefill, encode and training run head-parallel, by head group where the
'model' ranks do not divide the heads (:func:`head_groups`: each group's
ranks split its rows); decode over a cache
split over the sequence runs flash-decoding (:func:`_decode_split`): each
rank runs B10's partials mode on its own block of the ring for its rows
and every head, and one merge over the sequence's ranks (an all-reduce
max of the log-sum-exp, one all-reduce sum of the rescaled outputs and
weights packed together) gives the whole; no cache leaf is gathered.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, NamedTuple, Optional, Tuple

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
    ``impl == "train"``, where nothing keeps it).  Under a mesh the layer
    runs as :func:`attention_layer`, which calls this block only on local
    tensors.
    """
    b, t = x.shape[:2]
    q = layers.linear(x, p["wq"], dtype).reshape(b, t, n_heads, head_dim)
    k = layers.linear(x, p["wk"], dtype).reshape(b, t, n_kv, head_dim)
    v = layers.linear(x, p["wv"], dtype).reshape(b, t, n_kv, head_dim)
    if "q_norm" in p:
        q = _qk_norm(q, p["q_norm"])
        k = _qk_norm(k, p["k_norm"])
    q = layers.apply_rope(q, positions, rope_theta, rotary_frac)
    k = layers.apply_rope(k, positions, rope_theta, rotary_frac)

    scale = float(head_dim ** -0.5)

    if cache is None:
        out = run_attention(q, k, v, mask_kind, window, scale, impl, chunk)
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
        dec_window = window if mask_kind == "window" else 0
        if impl != "ref":
            out = fused_decode(q, cache, scale, window=dec_window,
                               cache_pos=int(cache_pos))
        else:
            k_eff, v_eff = cache["k"], cache["v"]
            if quantized:
                k_eff = k_eff.float() * cache["k_scale"]
                v_eff = v_eff.float() * cache["v_scale"]
            out = decode_attention(q, k_eff, v_eff, scale, window=dec_window,
                                   cache_pos=int(cache_pos))

    out = out.reshape(b, t, n_heads * head_dim)
    return layers.linear(out, p["wo"], dtype), new_cache


class HeadGroups(NamedTuple):
    """How the query heads split over the m 'model' ranks: ``groups``
    (g = gcd(H, m)) groups of ``ranks`` (r = m / g) consecutive ranks,
    group j owning the ``heads`` query heads [j H / g, (j + 1) H / g)
    (exactly the wq column blocks of its r ranks) and reading the ``kv``
    kv heads from ``kv_first(j)`` on: whole kv heads of its own, or one
    kv head shared by ``share`` groups.  ``kv_ranks`` is the least run of
    consecutive ranks whose wk / wv column blocks hold every kv head the
    group of each of them reads.  r is 1 where the ranks divide the
    heads."""
    groups: int
    ranks: int
    heads: int
    kv: int
    share: int
    kv_ranks: int

    def kv_first(self, group: int) -> int:
        return group * self.kv // self.share


def head_groups(n_heads: int, n_kv: int, head_dim: int, m: int
                ) -> Optional[HeadGroups]:
    """The head groups of ``n_heads`` query and ``n_kv`` kv heads over
    ``m`` 'model' ranks (:class:`HeadGroups`), or None where the column
    blocks are uneven (H D or Hk D not a multiple of m) or a group's
    query heads would read part of one kv head and part of the next (no
    config of the repo at a 'model' size that is a power of two)."""
    if (n_heads * head_dim) % m or (n_kv * head_dim) % m:
        return None
    g = math.gcd(n_heads, m)
    hg, per_kv = n_heads // g, n_heads // n_kv
    if hg % per_kv == 0:
        kv, share = hg // per_kv, 1
    elif per_kv % hg == 0:
        kv, share = 1, per_kv // hg
    else:
        return None
    cb = n_kv * head_dim // m                  # wk's columns a rank
    for s in (d for d in range(1, m + 1) if m % d == 0):
        grp = HeadGroups(g, m // g, hg, kv, share, s)
        spans = ((q, grp.kv_first(q // grp.ranks) * head_dim)
                 for q in range(m))
        if all(q // s * s * cb <= c0 and c0 + kv * head_dim
               <= (q // s + 1) * s * cb for q, c0 in spans):
            return grp
    return None


def head_parallel(x, p: Dict[str, Tensor], n_heads: int, n_kv: int,
                  head_dim: int) -> bool:
    """Whether the block runs head-parallel over the mesh's 'model' dim
    (:func:`_attention_heads`): x sharded with its rows not split over
    'model', wq/wk/wv split there on their columns and wo on its rows,
    in equal blocks, and the heads in groups (:func:`head_groups`).  Where
    the 'model' ranks divide the heads each rank is a group of its own;
    elsewhere (gemma3-4b's 8 heads or llama4-maverick's 40 over 16 ranks:
    8 groups of 2) each group's ranks must split the rows each of them
    holds evenly among them.  Otherwise -- a batch of B rows over
    'data' ranks with B / data not a multiple of the ranks of a group,
    e.g. a batch-1 prefill on a (1, 16) mesh -- the block runs on each
    rank's rows with every head (``layers.rows_layer``)."""
    if (not is_dtensor(x) or layers.model_split(x, 0)
            or not all(layers.model_split(p[n], 1) for n in ("wq", "wk", "wv"))
            or not layers.model_split(p["wo"], 0)):
        return False
    reg = layers.Region(x)
    grp = head_groups(n_heads, n_kv, head_dim, reg.model_size)
    if grp is None:
        return False
    batch_ranks = math.prod(reg.mesh.size(i) for i in reg.batch)
    return grp.ranks == 1 or x.shape[0] % (batch_ranks * grp.ranks) == 0


def attention_layer(p: Dict[str, Tensor], h, positions: Tensor,
                    norm: Tuple[str, Dict[str, Tensor]], *,
                    cache: Optional[Dict[str, Tensor]] = None,
                    cache_pos: Optional[int] = None, **kw):
    """The sharded layer h + attention(norm(h)) -> (h, cache): head-parallel
    on local shards, by head group where 'model' does not divide the heads
    (:func:`head_parallel`); decode over a cache split over the sequence
    by flash-decoding (:func:`decode_split`); otherwise (a group that
    cannot split its rows) on each rank's rows with every head whole
    (``layers.rows_layer``).  A decode whose cache is
    not laid out for flash-decoding (``launch.shapes.cache_structs`` lays
    out every sharded cache so) raises."""
    n_heads, n_kv, d = kw["n_heads"], kw["n_kv"], kw["head_dim"]
    if cache is None:
        if head_parallel(h, p, n_heads, n_kv, d):
            return _attention_heads(p, h, positions, norm=norm, **kw)

        def fn(xn, q, pos):
            out, c = attention_block(q, xn, pos, **kw)
            return out if kw["impl"] == "train" else (out, c["k"], c["v"])
        if kw["impl"] == "train":
            return layers.rows_layer(fn, h, p, norm, name="attention",
                                     rows=(positions,)), None
        out, k, v = layers.rows_layer(fn, h, p, norm, name="attention",
                                      rows=(positions,), extra=2)
        return out, {"k": k, "v": v}
    if not decode_split(h, p, cache):
        raise ValueError(
            "a sharded decode needs its cache laid out for flash-decoding "
            "(launch.shapes.cache_structs): rows split as h's, the sequence "
            "split or whole, heads whole; and wq/wk/wv and wo split evenly "
            "over the mesh's 'model' dim")
    return _decode_split(p, h, positions, norm, cache, int(cache_pos), **kw)


def decode_split(h, p: Dict[str, Tensor], cache: Dict[str, Tensor]) -> bool:
    """Whether a sharded decode runs flash-decoding on local shards: the
    cache's leaves DTensors with their rows split as h's are, the sequence
    split over any other mesh dims (or whole), heads and head dim whole;
    wq / wk / wv on equal 'model' column blocks and wo on equal row
    blocks."""
    from torch.distributed.tensor import Replicate, Shard
    k = cache["k"]
    if not (is_dtensor(h) and is_dtensor(k)) or layers.model_split(h, 0):
        return False
    reg = layers.Region(h)
    if k.device_mesh != reg.mesh:
        return False
    for i, pl in enumerate(k.placements):
        if pl not in ((Shard(0),) if i in reg.batch
                      else (Shard(1), Replicate())):
            return False
    if any(not is_dtensor(c) or c.placements != k.placements
           for c in cache.values()):
        return False
    return reg.model is None or (all(reg.even(p[n], 1)
                                     for n in ("wq", "wk", "wv"))
                                 and reg.even(p["wo"], 0))


def _decode_split(p: Dict[str, Tensor], h, positions: Tensor,
                  norm: Tuple[str, Dict[str, Tensor]],
                  cache: Dict[str, Tensor], cache_pos: int, *, n_heads: int,
                  n_kv: int, head_dim: int, mask_kind: str, window: int,
                  rope_theta: float, rotary_frac: float, dtype: torch.dtype,
                  impl: str, chunk: int):
    """Flash-decoding on local shards (a :class:`layers.Region`): h's rows
    normed whole; q, k, v of every head (each rank's 'model' column blocks
    gathered: a token's worth); the new k / v written into the block of
    the ring that holds their slot; B10's partials mode on this rank's
    block (``decode_attention_partials``: the visible keys of the ring
    that lie in the block, one run); the merge over the ranks that split
    the sequence (:func:`merge_partials`); then each rank's heads times
    wo's row block, summed over 'model', and the residual."""
    from torch.distributed.tensor import Shard
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.kernels.decode_attention import ref as dec_ref
    reg = layers.Region(h)
    xn = reg.act(h, norm)                                   # (B_loc, 1, d)
    b = xn.shape[0]

    def whole(w, n):          # (B_loc, 1, n, D) of every head
        y = layers.linear(xn, reg.weight(w), dtype)
        if reg.model is not None:
            y = layers.all_gather(y, y.ndim - 1, reg.model_group)
        return y.reshape(b, 1, n, head_dim)

    q, k, v = whole(p["wq"], n_heads), whole(p["wk"], n_kv), whole(p["wv"],
                                                                  n_kv)
    if "q_norm" in p:
        q = _qk_norm(q, reg.weight(p["q_norm"]))
        k = _qk_norm(k, reg.weight(p["k_norm"]))
    pos = reg.rows(positions)
    q = layers.apply_rope(q, pos, rope_theta, rotary_frac)
    k = layers.apply_rope(k, pos, rope_theta, rotary_frac)

    ck = cache["k"]
    s_total = ck.shape[1]
    lo = layers.local_offset(ck)[1]
    local = {n: c.to_local() for n, c in cache.items()}
    n_loc = local["k"].shape[1]
    slot = cache_pos % s_total
    if lo <= slot < lo + n_loc:            # this rank holds the new slot
        for name, new in (("k", k), ("v", v)):
            if "k_scale" in local:
                q8, sc = quantize_kv(new)
                local[name][:, slot - lo] = q8[:, 0]
                local[name + "_scale"][:, slot - lo] = sc[:, 0]
            else:
                local[name][:, slot - lo] = new[:, 0].to(local[name].dtype)

    qh = q.reshape(b, n_kv, n_heads // n_kv, head_dim)
    scale = float(head_dim ** -0.5)
    win = window if mask_kind == "window" else 0
    ops = (local["k"], local["v"])
    scales = (local.get("k_scale"), local.get("v_scale"))
    if impl == "ref":
        s0, nvis = dec_ops.block_visible_range(s_total, cache_pos, win, lo,
                                               n_loc)
        o, lse = dec_ref.decode_attention_partials_ref(qh, *ops, s0, nvis,
                                                       scale, *scales)
    else:
        o, lse = dec_ops.decode_attention_partials(
            qh, *ops, cache_pos, scale, *scales, window=win,
            block=(lo, s_total))
    o = merge_partials(o, lse, [reg.group(i) for i, pl in
                                enumerate(ck.placements) if pl == Shard(1)])
    out = o.to(q.dtype).reshape(b, 1, n_heads * head_dim)
    wo = reg.weight(p["wo"])
    if reg.model is not None:              # this rank's heads' rows of wo
        r0 = layers.local_offset(p["wo"])[0]
        out = out[..., r0:r0 + wo.shape[0]]
    layers.trace_region("decode_attention", heads=n_heads, seq_block=n_loc)
    return reg.out(layers.linear(out, wo, dtype), residual=True), cache


def merge_partials(o: Tensor, lse: Tensor, groups) -> Tensor:
    """The flash-decoding merge of per-rank partials: o (..., D) f32
    normalised over a rank's keys, lse (...) their log-sum-exp (-inf with
    none).  With M the max of lse over the ranks (an all-reduce max over
    each group in turn), each rank weighs its o by exp(lse - M) (0 with
    no key, never a NaN) and one all-reduce sum over each group of the
    weighted outputs and weights packed together gives sum(w o) / sum(w)."""
    m = lse
    for g in groups:
        m = layers.all_reduce_max(m, g)
    w = torch.exp(lse - m)[..., None]
    packed = torch.cat([o * w, w], dim=-1)
    for g in groups:
        packed = layers.all_reduce(packed, g)
    return packed[..., :-1] / torch.clamp(packed[..., -1:], min=1e-30)


def _attention_heads(p: Dict[str, Tensor], x, positions: Tensor, *,
                     n_heads: int, n_kv: int, head_dim: int, mask_kind: str,
                     window: int, rope_theta: float, rotary_frac: float,
                     dtype: torch.dtype, impl: str, chunk: int,
                     norm: Optional[Tuple[str, Dict[str, Tensor]]] = None):
    """Head-parallel attention on local shards (a :class:`layers.Region`)
    by head group (:func:`head_groups`): x's rows with d whole, split
    among the r ranks of this rank's group (its block of them); the
    group's query heads (wq's column blocks and wo's row blocks gathered
    within the group) and the kv heads they read (wk's and wv's column
    blocks gathered over the ``kv_ranks`` neighbours that hold them, and
    their columns kept); B9 once at (rows / r, T, H / g, D).  The output
    times wo's rows is a partial sum over the groups, entered in this
    rank's block of the rows and reduce-scattered onto d (or all-reduced)
    over 'model' into x's layout.  Where the ranks divide the heads (r 1)
    each rank runs its own heads on all its rows.  With ``norm`` the
    region is the whole layer: x normed on whole rows, and x +
    attention(norm(x)) returned, the residual on the local block."""
    reg = layers.Region(x)
    grp = head_groups(n_heads, n_kv, head_dim, reg.model_size)
    r = grp.ranks
    xl = reg.act(x, norm, row_split=r)                  # (B_loc / r, T, d)
    b, t = xl.shape[:2]

    wq, wo = reg.model_blocks(p["wq"], 1, r), reg.model_blocks(p["wo"], 0, r)
    wk, wv = (reg.model_blocks(p[n], 1, grp.kv_ranks) for n in ("wk", "wv"))
    if wk.shape[1] != grp.kv * head_dim:     # the group's kv heads' columns
        c0 = (grp.kv_first(reg.model_rank // r) * head_dim
              - reg.model_rank // grp.kv_ranks * wk.shape[1])
        wk, wv = (w[:, c0:c0 + grp.kv * head_dim] for w in (wk, wv))
    q = layers.linear(xl, wq, dtype).reshape(b, t, grp.heads, head_dim)
    k = layers.linear(xl, wk, dtype).reshape(b, t, grp.kv, head_dim)
    v = layers.linear(xl, wv, dtype).reshape(b, t, grp.kv, head_dim)
    if "q_norm" in p:
        q = _qk_norm(q, reg.weight(p["q_norm"]))
        k = _qk_norm(k, reg.weight(p["k_norm"]))
    pos = reg.rows(positions)
    q = layers.apply_rope(q, pos, rope_theta, rotary_frac)
    k = layers.apply_rope(k, pos, rope_theta, rotary_frac)
    out = run_attention(q, k, v, mask_kind, window, float(head_dim ** -0.5),
                        impl, chunk)
    layers.trace_region("attention", heads=grp.heads, kv_heads=grp.kv,
                        **({"rows": b} if r > 1 else {}))
    y = layers.linear(out.reshape(b, t, grp.heads * head_dim), wo, dtype)
    return reg.out(y, residual=norm is not None), (
        None if impl == "train" else _heads_cache(reg, k, v, n_kv, grp))


def _heads_cache(reg, k: Tensor, v: Tensor, n_kv: int,
                 grp: HeadGroups) -> Dict[str, Tensor]:
    """The prefill cache of head-parallel attention as DTensors (B, T,
    n_kv, D) with their rows split as x's: where each rank holds kv heads
    of its own for all its rows, those heads split over 'model' (no
    communication); else every rank's block (its group's kv heads for its
    block of the rows) gathered over 'model' and each kv head's row blocks
    kept once, so that every rank holds all its rows with the heads whole
    (the reference's cache keeps them whole; ``decode_split`` reads
    this)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    out = {}
    for name, t in (("k", k), ("v", v)):
        if grp.ranks == 1 and grp.share == 1:
            pl = reg.layout(Shard(2))
        else:
            b, s, _, d = t.shape
            t = layers.all_gather(t, 2, reg.model_group).reshape(
                b, s, grp.groups, grp.ranks, grp.kv, d)[:, :, ::grp.share]
            t = t.permute(3, 0, 1, 2, 4, 5).reshape(
                grp.ranks * b, s, n_kv, d)
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
