"""Mamba(1) selective-state-space mixer (the JAX package's
``models/ssm.py``).

The selective scan h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t is a diagonal
per-(channel, state) linear recurrence.  Over a prompt it runs in chunks
of ``chunk`` steps: the carry is one (B, d_inner, N) f32 state, and only
one chunk's (B, Q, d_inner, N) history is live.  Decode (T == 1) is the
same recurrence in closed form: an O(1)-state step.

Inside a chunk the steps compose as (a1, b1) o (a2, b2) = (a1 a2,
a2 b1 + b2) (decay, input).  torch has no associative scan, so the chunk
runs a Hillis-Steele doubling scan over its Q + 1 steps (the carried
state prepended with decay 1): log2(Q + 1) elementwise passes, each
composing every step with the one 2^j before it.  Every decay is
exp(dt A) with dt >= 0 and A < 0, so every factor lies in (0, 1] and no
product can overflow.  The tail chunk is padded with dt = 0 after the
softplus (decay 1, input 0): the padded steps keep the state, so the end
state is exact.  Summation order differs from the reference's scan; the
two agree within f32 rounding.

The depthwise conv is causal with a (d_conv - 1) carry, so chunking and
decoding do not change results.
"""
from __future__ import annotations

import functools
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers
from repro_torch.models.layers import ParamSpec, Template

Tensor = torch.Tensor


class SSMState(NamedTuple):
    conv: Tensor   # (B, d_conv - 1, d_inner) f32 rolling conv inputs
    ssm: Tensor    # (B, d_inner, N) f32 recurrent state


def mamba_template(d: int, d_inner: int, d_state: int, d_conv: int,
                   dt_rank: int, dtype: torch.dtype,
                   fsdp: bool = False) -> Template:
    dax = "data" if fsdp else None
    f32 = torch.float32
    return {
        "in_proj": ParamSpec((d, 2 * d_inner), dtype, (dax, "model"),
                             "fan_in"),
        "conv_w": ParamSpec((d_conv, d_inner), f32, (None, "model"),
                            "normal", 0.2),
        "conv_b": ParamSpec((d_inner,), f32, ("model",), "zeros"),
        "x_proj": ParamSpec((d_inner, dt_rank + 2 * d_state), dtype,
                            ("model", None), "fan_in"),
        "dt_proj_w": ParamSpec((dt_rank, d_inner), f32, (None, "model"),
                               "fan_in"),
        "dt_proj_b": ParamSpec((d_inner,), f32, ("model",), "ones", 0.01),
        "a_log": ParamSpec((d_inner, d_state), f32, ("model", None),
                           "normal", 0.5),
        "d_skip": ParamSpec((d_inner,), f32, ("model",), "ones"),
        "out_proj": ParamSpec((d_inner, d), dtype, ("model", dax), "fan_in"),
    }


def _causal_conv(x: Tensor, w: Tensor, b: Tensor, carry: Tensor
                 ) -> Tuple[Tensor, Tensor]:
    """Depthwise causal conv1d.  x (B, T, D); w (K, D); carry (B, K-1, D).
    Returns (out in x's dtype, new carry f32)."""
    k, t = w.shape[0], x.shape[1]
    xin = torch.cat([carry.to(x.dtype), x], dim=1)          # (B, K-1+T, D)
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(k):
        out = out + xin[:, i:i + t].float() * w[i]
    new_carry = xin[:, xin.shape[1] - (k - 1):]
    return (out + b).to(x.dtype), new_carry.float()


def _scan(a: Tensor, b: Tensor) -> Tensor:
    """Inclusive scan of h_t = a_t h_{t-1} + b_t along dim 1 (h_{-1} = 0):
    Hillis-Steele doubling.  a, b (B, L, D, N) -> h (B, L, D, N)."""
    n = a.shape[1]
    s = 1
    while s < n:
        b = torch.cat([b[:, :s], a[:, s:] * b[:, :-s] + b[:, s:]], dim=1)
        if 2 * s < n:                   # the last pass needs no decays
            a = torch.cat([a[:, :s], a[:, s:] * a[:, :-s]], dim=1)
        s *= 2
    return b


def _ssm_chunk(xq: Tensor, dt: Tensor, b_t: Tensor, c_t: Tensor, a: Tensor,
               h0: Tensor) -> Tuple[Tensor, Tensor]:
    """One chunk of the selective scan.  xq (B, Q, D) conv'd input; dt
    (B, Q, D); b_t/c_t (B, Q, N); a (D, N); h0 (B, D, N).  Returns (y (B,
    Q, D), h_end)."""
    da = torch.exp(dt[..., None] * a)                       # (B, Q, D, N)
    dbx = (dt * xq)[..., None] * b_t[:, :, None, :]         # (B, Q, D, N)
    ones = torch.ones_like(h0)[:, None]
    hist = _scan(torch.cat([ones, da], dim=1),
                 torch.cat([h0[:, None], dbx], dim=1))[:, 1:]
    y = torch.einsum("bqdn,bqn->bqd", hist, c_t)
    return y, hist[:, -1]


def mamba_mixer(p: Dict[str, Tensor], x: Tensor, *, d_inner: int,
                d_state: int, d_conv: int, dt_rank: int,
                dtype: torch.dtype = torch.bfloat16, chunk: int = 256,
                state: Optional[SSMState] = None,
                xz: Optional[Tuple[Tensor, Tensor]] = None,
                proj_sum=layers.sum_partial
                ) -> Tuple[Tensor, SSMState]:
    """x (B, T, d).  Returns (out (B, T, d), end state).  Pass ``state`` to
    continue from it (decode: T == 1).  On local shards (:func:`mamba_layer`)
    ``xz`` gives the input projection's two halves of this rank's
    d_inner channels and ``proj_sum`` sums x_proj's product (a contraction
    over the split channels) over the ranks."""
    b, t, _ = x.shape
    if xz is None:
        xs, z = torch.split(layers.linear(x, p["in_proj"], dtype), d_inner,
                            dim=-1)                         # (B, T, D) each
    else:
        xs, z = xz
    if state is None:
        conv_carry = torch.zeros((b, d_conv - 1, d_inner),
                                 dtype=torch.float32, device=x.device)
        h0 = torch.zeros((b, d_inner, d_state), dtype=torch.float32,
                         device=x.device)
    else:
        conv_carry, h0 = state.conv, state.ssm

    xs, conv_carry = _causal_conv(xs, p["conv_w"], p["conv_b"], conv_carry)
    xs = F.silu(xs.float()).to(dtype)

    # sharded, x_proj contracts over the split d_inner: its sum first
    proj = proj_sum(layers.linear(xs, p["x_proj"], dtype)).float()
    dt_in, b_t, c_t = torch.split(proj, [dt_rank, d_state, d_state], dim=-1)
    dt = F.softplus(dt_in @ p["dt_proj_w"] + p["dt_proj_b"])   # (B, T, D)
    a = -torch.exp(p["a_log"])                                 # (D, N)
    xf = xs.float()

    if t == 1:
        # decode: the closed-form single step
        da = torch.exp(dt[:, 0, :, None] * a)                   # (B, D, N)
        h_end = (da * h0 + (dt[:, 0] * xf[:, 0])[..., None]
                 * b_t[:, 0, None, :])
        y = torch.einsum("bdn,bn->bd", h_end, c_t[:, 0])[:, None]
    else:
        q = min(chunk, t)
        n_chunks = -(-t // q)
        pad = n_chunks * q - t
        xq, dq, bq, cq = xf, dt, b_t, c_t
        if pad:                         # dt = 0: the padded steps keep h
            xq, dq, bq, cq = (F.pad(z_, (0, 0, 0, pad))
                              for z_ in (xf, dt, b_t, c_t))
        # under autograd each chunk is recomputed in backward instead of
        # keeping every chunk's (B, Q, D, N) history (the reference's
        # chunk remat)
        step = (functools.partial(checkpoint, _ssm_chunk, use_reentrant=False)
                if torch.is_grad_enabled() else _ssm_chunk)
        ys = []
        h_end = h0
        for c in range(n_chunks):
            sl = slice(c * q, (c + 1) * q)
            y_c, h_end = step(xq[:, sl], dq[:, sl], bq[:, sl], cq[:, sl], a,
                              h_end)
            ys.append(y_c)
        y = torch.cat(ys, dim=1)[:, :t]

    y = y + xf * p["d_skip"]
    y = y * F.silu(z.float())
    out = layers.linear(y.to(dtype), p["out_proj"], dtype)
    return out, SSMState(conv=conv_carry, ssm=h_end)


def mamba_layer(p: Dict[str, Tensor], h, norm, *, d_inner: int,
                d_state: int, d_conv: int, dt_rank: int, dtype: torch.dtype,
                chunk: int):
    """The sharded layer h + mamba(norm(h)) -> (h, {"conv", "ssm"}) on local
    shards (a ``layers.Region``, the reference's split of the d_inner
    channels over 'model'): h's rows normed whole; in_proj gathered over
    'model' (its column blocks do not follow the channels: it holds both
    halves) and only this rank's channels of each half computed; the
    conv, dt, A, D and the scan on the rank's channels; x_proj's product
    summed over 'model'; out_proj's row block, the partial sum reduced
    there and the residual added.  The end state is split over 'model' by
    channel.  Channels that do not split run whole on each rank's rows
    (``layers.rows_layer``)."""
    reg = layers.Region(h)
    m = reg.model_size
    kw = dict(d_state=d_state, d_conv=d_conv, dt_rank=dt_rank, dtype=dtype,
              chunk=chunk)
    split = d_inner % m == 0 and all(reg.even(p[n], dim) for n, dim in (
        ("in_proj", 1), ("conv_w", 1), ("conv_b", 0), ("x_proj", 0),
        ("dt_proj_w", 1), ("dt_proj_b", 0), ("a_log", 0), ("d_skip", 0),
        ("out_proj", 0)))
    if not split:
        def fn(xn, q):
            out, st = mamba_mixer(q, xn, d_inner=d_inner, **kw)
            return out, st.conv, st.ssm
        out, conv, ssm = layers.rows_layer(fn, h, p, norm, name="mamba",
                                           extra=2)
        return out, {"conv": conv, "ssm": ssm}
    xn = reg.act(h, norm)
    w_in = reg.weight(p["in_proj"])
    proj_sum = (lambda t: t) if reg.model is None else functools.partial(
        layers.all_reduce_sum_grad, group=reg.model_group)
    if reg.model is not None:
        w_in = layers.all_gather(w_in, 1, reg.model_group)
    dl, r = d_inner // m, reg.model_rank
    xs = layers.linear(xn, w_in[:, r * dl:(r + 1) * dl], dtype)
    z = layers.linear(xn, w_in[:, d_inner + r * dl:d_inner + (r + 1) * dl],
                      dtype)
    local = reg.weights({k: v for k, v in p.items() if k != "in_proj"})
    out, st = mamba_mixer(local, xn, d_inner=dl, xz=(xs, z),
                          proj_sum=proj_sum, **kw)
    layers.trace_region("mamba", channels=dl)
    return (reg.out(out, residual=True),
            {"conv": reg.put(st.conv, 2), "ssm": reg.put(st.ssm, 1)})
