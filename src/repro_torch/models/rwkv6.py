"""RWKV-6 "Finch" mixer: linear attention with data-dependent decay (the
JAX package's ``models/rwkv6.py``).

Per head (dim K): state S (K, V) evolves as

    S_t = diag(w_t) S_{t-1} + k_t^T v_t
    o_t = r_t (S_{t-1} + diag(u) k_t^T v_t)          (bonus u on current)

with w_t = exp(-exp(ww + lora_w(x_t))) in (0, 1).  Attention-free: the
decode state is O(1) per head (``wkv`` (B, H, K, V) f32, and the two token
shift carries (B, 1, d) f32).

Token shift follows RWKV: each block input is a learned lerp of x_t and
x_{t-1}; the shift carry is part of the decode state.  The simplifications
of the reference are kept (static mix vectors, dense gate and receptance
projections).

Chunked form.  Within a chunk of Q steps, with L_t = sum_{i<=t} log w_i,

    state:        r_t exp(L_{t-1}) S_0
    intra (j<t):  sum_k r_tk k_jk exp(L_{t-1,k} - L_{j,k})  v_j
    bonus:        (r_t u k_t) v_t
    end state:    exp(L_Q) S_0 + sum_j (k_j exp(L_Q - L_j))^T v_j

Every exponent here is <= 0.  The reference forms k_j exp(-L_j) alone,
which overflows f32 once a chunk's decay passes e^88 (its full config at
init: ROADMAP C10); the port forms the pairwise decay over a (Q, Q, K)
tile, masked before the exp, and never overflows.  In exact arithmetic
the two are the same function, and both equal the token-by-token
recurrence (the ``T == 1`` branch).
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers
from repro_torch.models.layers import ParamSpec, Template

Tensor = torch.Tensor


def rwkv6_template(d: int, n_heads: int, head_dim: int,
                   dtype: torch.dtype, fsdp: bool = False,
                   decay_lora: int = 64) -> Template:
    dax = "data" if fsdp else None
    hd = n_heads * head_dim
    f32 = torch.float32
    return {
        "mix_r": ParamSpec((d,), f32, (None,), "ones", 0.5),
        "mix_k": ParamSpec((d,), f32, (None,), "ones", 0.5),
        "mix_v": ParamSpec((d,), f32, (None,), "ones", 0.5),
        "mix_w": ParamSpec((d,), f32, (None,), "ones", 0.5),
        "mix_g": ParamSpec((d,), f32, (None,), "ones", 0.5),
        "wr": ParamSpec((d, hd), dtype, (dax, "model"), "fan_in"),
        "wk": ParamSpec((d, hd), dtype, (dax, "model"), "fan_in"),
        "wv": ParamSpec((d, hd), dtype, (dax, "model"), "fan_in"),
        "wg": ParamSpec((d, hd), dtype, (dax, "model"), "fan_in"),
        "wo": ParamSpec((hd, d), dtype, ("model", dax), "fan_in"),
        # data-dependent decay: w_t = exp(-exp(ww + (x W_a) W_b))
        "ww": ParamSpec((hd,), f32, ("model",), "normal", 0.5),
        "w_lora_a": ParamSpec((d, decay_lora), dtype, (dax, None), "fan_in"),
        "w_lora_b": ParamSpec((decay_lora, hd), dtype, (None, "model"),
                              "fan_in", 0.1),
        "u_bonus": ParamSpec((n_heads, head_dim), f32, ("model", None),
                             "normal", 0.5),
        "ln_x_w": ParamSpec((hd,), f32, ("model",), "ones"),
    }


def channel_mix_template(d: int, ff: int, dtype: torch.dtype,
                         fsdp: bool = False) -> Template:
    dax = "data" if fsdp else None
    return {
        "mix_k": ParamSpec((d,), torch.float32, (None,), "ones", 0.5),
        "wk": ParamSpec((d, ff), dtype, (dax, "model"), "fan_in"),
        "wv": ParamSpec((ff, d), dtype, ("model", dax), "fan_in"),
    }


def _token_shift(x: Tensor, carry: Tensor) -> Tuple[Tensor, Tensor]:
    """x (B, T, d) -> previous-token tensor, new carry (last token, f32)."""
    prev = torch.cat([carry.to(x.dtype), x[:, :-1]], dim=1)
    return prev, x[:, -1:].float()


def _lerp(x: Tensor, prev: Tensor, mv: Tensor) -> Tensor:
    return x * mv.to(x.dtype) + prev * (1.0 - mv).to(x.dtype)


def _wkv_chunk(r: Tensor, k: Tensor, v: Tensor, w: Tensor, u: Tensor,
               s0: Tensor) -> Tuple[Tensor, Tensor]:
    """One chunk of the recurrence.  r/k/w (B, H, Q, K); v (B, H, Q, V);
    u (H, K); s0 (B, H, K, V) f32.  Returns (o (B, H, Q, V), s_end)."""
    q = r.shape[2]
    logw = torch.log(torch.clamp(w, min=1e-12))
    lcum = torch.cumsum(logw, dim=2)                   # L_t (inclusive)
    lprev = lcum - logw                                # L_{t-1}
    o_state = (r * torch.exp(lprev)) @ s0

    # pairwise decay exp(L_{t-1} - L_j) for j < t, (B, H, Q_t, Q_j, K)
    strict = torch.ones((q, q), dtype=torch.bool, device=r.device).tril(-1)
    expo = (lprev[:, :, :, None, :] - lcum[:, :, None, :, :]).masked_fill(
        ~strict[:, :, None], float("-inf"))
    att = torch.sum(r[:, :, :, None, :] * k[:, :, None, :, :]
                    * torch.exp(expo), dim=-1)         # (B, H, Q_t, Q_j)
    o_intra = att @ v

    o_bonus = torch.sum(r * u[None, :, None, :] * k, dim=-1,
                        keepdim=True) * v

    k_end = k * torch.exp(lcum[:, :, -1:] - lcum)      # k_j exp(L_Q - L_j)
    s_end = (torch.exp(lcum[:, :, -1])[..., None] * s0
             + k_end.transpose(-1, -2) @ v)
    return o_state + o_intra + o_bonus, s_end


def rwkv6_mixer(p: Dict[str, Tensor], x: Tensor, *, n_heads: int,
                head_dim: int, dtype: torch.dtype = torch.bfloat16,
                chunk: int = 128, state: Optional[Tensor] = None,
                shift_carry: Optional[Tensor] = None
                ) -> Tuple[Tensor, Tensor, Tensor]:
    """x (B, T, d).  Returns (out (B, T, d), wkv state (B, H, K, V) f32,
    shift carry (B, 1, d) f32).  ``T == 1`` steps the recurrence; longer
    inputs run the chunked form over chunks of ``chunk`` steps."""
    b, t, d = x.shape
    h, kd = n_heads, head_dim
    if state is None:
        carry = torch.zeros((b, 1, d), dtype=torch.float32, device=x.device)
        s0 = torch.zeros((b, h, kd, kd), dtype=torch.float32,
                         device=x.device)
    else:
        carry, s0 = shift_carry, state

    prev, new_carry = _token_shift(x, carry)
    r = layers.linear(_lerp(x, prev, p["mix_r"]), p["wr"], dtype)
    k = layers.linear(_lerp(x, prev, p["mix_k"]), p["wk"], dtype)
    v = layers.linear(_lerp(x, prev, p["mix_v"]), p["wv"], dtype)
    g = layers.linear(_lerp(x, prev, p["mix_g"]), p["wg"], dtype)
    w_in = layers.linear(_lerp(x, prev, p["mix_w"]), p["w_lora_a"], dtype)
    w_log = p["ww"] + layers.linear(torch.tanh(w_in.float()).to(dtype),
                                    p["w_lora_b"], dtype).float()
    w = torch.exp(-torch.exp(w_log))                   # (B, T, H*K) in (0, 1)

    def heads(z: Tensor) -> Tensor:
        return z.float().reshape(b, t, h, kd).transpose(1, 2)

    rh, kh, vh, wh = heads(r), heads(k), heads(v), heads(w)
    u = p["u_bonus"]

    if t == 1:
        # decode: o = r (S + u k^T v); S' = diag(w) S + k^T v
        kv = kh[:, :, 0, :, None] * vh[:, :, 0, None, :]     # (B, H, K, V)
        o = (rh[:, :, 0, None, :] @ (s0 + u[None, :, :, None] * kv))
        s_end = wh[:, :, 0, :, None] * s0 + kv
        o = o.reshape(b, 1, h * kd)
    else:
        q = min(chunk, t)
        n_chunks = -(-t // q)
        pad = n_chunks * q - t
        if pad:
            rh, kh, vh = (F.pad(z, (0, 0, 0, pad)) for z in (rh, kh, vh))
            wh = F.pad(wh, (0, 0, 0, pad), value=1.0)  # decay 1 = inert
        # under autograd each chunk is recomputed in backward instead of
        # keeping every chunk's (Q, Q, K) tile (the reference's chunk remat)
        step = (functools.partial(checkpoint, _wkv_chunk, use_reentrant=False)
                if torch.is_grad_enabled() else _wkv_chunk)
        outs = []
        s_end = s0
        for c in range(n_chunks):
            sl = slice(c * q, (c + 1) * q)
            o_c, s_end = step(rh[:, :, sl], kh[:, :, sl], vh[:, :, sl],
                              wh[:, :, sl], u, s_end)
            outs.append(o_c)
        o = torch.cat(outs, dim=2)[:, :, :t]
        o = o.transpose(1, 2).reshape(b, t, h * kd)

    # per-head group norm (ln_x) + silu gate
    of = o.reshape(b, -1, h, kd)
    mu = torch.mean(of, dim=-1, keepdim=True)
    var = torch.mean((of - mu) ** 2, dim=-1, keepdim=True)
    of = (of - mu) * torch.rsqrt(var + 1e-5)
    o = (of.reshape(b, -1, h * kd) * p["ln_x_w"]).to(dtype)
    o = o * F.silu(g.float()).to(dtype)
    return layers.linear(o, p["wo"], dtype), s_end, new_carry


def channel_mix(p: Dict[str, Tensor], x: Tensor, carry: Tensor,
                dtype: torch.dtype) -> Tuple[Tensor, Tensor]:
    """RWKV FFN: squared relu with token shift.  Returns (out, new carry)."""
    prev, new_carry = _token_shift(x, carry)
    hidden = layers.act_fn("relu2",
                           layers.linear(_lerp(x, prev, p["mix_k"]), p["wk"],
                                         dtype))
    return layers.linear(hidden, p["wv"], dtype), new_carry


def rwkv6_layer(p: Dict[str, Tensor], h, norm, *, n_heads: int,
                head_dim: int, dtype: torch.dtype, chunk: int):
    """The sharded layer h + rwkv6(norm(h)) -> (h, {"wkv", "shift"}) on
    local shards (a ``layers.Region``): h's rows normed whole (the token
    shift reads whole rows), each rank's n_heads / model heads (wr / wk /
    wv / wg / w_lora_b column blocks, ww, u_bonus and ln_x_w blocks; the
    mixes and w_lora_a whole), wo's row block, the partial sum reduced
    over 'model' and the residual added there.  The end state is split
    over 'model' by head, the shift carry whole.  Heads that do not split
    run whole on each rank's rows (``layers.rows_layer``)."""
    reg = layers.Region(h)
    split = n_heads % reg.model_size == 0 and all(
        reg.even(p[n], dim) for n, dim in (
            ("wr", 1), ("wk", 1), ("wv", 1), ("wg", 1), ("wo", 0),
            ("ww", 0), ("w_lora_b", 1), ("u_bonus", 0), ("ln_x_w", 0)))
    kw = dict(head_dim=head_dim, dtype=dtype, chunk=chunk)
    if not split:
        out, s_end, carry = layers.rows_layer(
            lambda xn, q: rwkv6_mixer(q, xn, n_heads=n_heads, **kw), h, p,
            norm, name="rwkv", extra=2)
        return out, {"wkv": s_end, "shift": carry}
    xn = reg.act(h, norm)
    hl = n_heads // reg.model_size
    out, s_end, carry = rwkv6_mixer(reg.weights(p), xn, n_heads=hl, **kw)
    layers.trace_region("rwkv", heads=hl)
    return (reg.out(out, residual=True),
            {"wkv": reg.put(s_end, 1), "shift": reg.put(carry)})


def channel_mix_layer(p: Dict[str, Tensor], h, norm, carry,
                      dtype: torch.dtype):
    """The sharded layer h + channel_mix(norm(h)) -> (h, new carry) on
    local shards: wk's ff column block and wv's row block, the partial sum
    reduced over 'model' and the residual added there; ``carry`` (a
    DTensor, or None: zeros) and the new carry whole on each rank's
    rows."""
    reg = layers.Region(h)
    if not (reg.even(p["wk"], 1) and reg.even(p["wv"], 0)):
        c = carry if carry is not None else torch.zeros(
            (h.shape[0], 1, h.shape[-1]), dtype=torch.float32,
            device=h.device)
        return layers.rows_layer(
            lambda xn, q, c_: channel_mix(q, xn, c_, dtype), h, p, norm,
            name="channel_mix", rows=(c,), extra=1)
    xn = reg.act(h, norm)
    c = (torch.zeros((xn.shape[0], 1, xn.shape[-1]), dtype=torch.float32,
                     device=xn.device) if carry is None else reg.rows(carry))
    w = reg.weights(p)
    out, new = channel_mix(w, xn, c, dtype)
    layers.trace_region("channel_mix", ff=w["wk"].shape[1])
    return reg.out(out, residual=True), reg.put(new)
