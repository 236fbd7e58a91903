"""Shared LM building blocks: parameter templates, norms, RoPE, MLPs.

Parameters are described by a *template* (nested dict of ParamSpec) that
carries shape, dtype and init recipe; ``init_params`` materialises it from
a ``torch.Generator``.  Parameters are plain nested dicts of tensors with
the JAX package's keys, so weights carry across one to one
(``models.convert``).  The mesh and sharding helpers of the JAX package
are not ported.

Rounding follows the reference: every projection takes its operands in
the compute dtype and rounds its f32-accumulated result to that dtype;
norms and RoPE compute in f32 and cast back.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Callable, Dict, Iterator, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Tensor = torch.Tensor


class ParamSpec(NamedTuple):
    shape: Tuple[int, ...]
    dtype: torch.dtype
    init: str        # zeros | ones | normal | fan_in
    scale: float = 1.0
    fan: Optional[int] = None  # explicit fan-in (stacked/period templates)


Template = Dict[str, Any]  # nested dict[str, ParamSpec | Template]


def tree_items(tree: Dict[str, Any], prefix: Tuple[str, ...] = ()
               ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    """(key path, leaf) pairs in sorted-key order (JAX's dict flatten order)."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from tree_items(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def tree_map(fn: Callable[..., Any], tree: Dict[str, Any], *rest
             ) -> Dict[str, Any]:
    """``fn`` over the leaves of ``tree`` and of the congruent ``rest``."""
    return {k: tree_map(fn, v, *(r[k] for r in rest)) if isinstance(v, dict)
            else fn(v, *(r[k] for r in rest)) for k, v in tree.items()}


def tree_from_items(items) -> Dict[str, Any]:
    """The nested dict of (key path, leaf) pairs."""
    out: Dict[str, Any] = {}
    for path, leaf in items:
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


def leaf_specs(template: Template):
    return [ps for _, ps in tree_items(template)]


def init_params(template: Template, generator: torch.Generator,
                device: Optional[torch.device] = None) -> Dict[str, Any]:
    """Materialise real parameters; normal draws come from ``generator``
    (on ``device``, the generator's device by default), one leaf after
    the other in sorted-key order, in f32 and then cast."""
    dev = generator.device if device is None else torch.device(device)

    def one(ps: ParamSpec) -> Tensor:
        if ps.init == "zeros":
            return torch.zeros(ps.shape, dtype=ps.dtype, device=dev)
        if ps.init == "ones":
            return torch.ones(ps.shape, dtype=ps.dtype, device=dev)
        if ps.init == "normal":
            std = ps.scale
        elif ps.init == "fan_in":
            fan = ps.fan if ps.fan is not None else (
                ps.shape[0] if len(ps.shape) <= 2
                else int(np.prod(ps.shape[:-1])))
            std = ps.scale / math.sqrt(max(fan, 1))
        else:
            raise ValueError(ps.init)
        v = torch.randn(ps.shape, generator=generator, dtype=torch.float32,
                        device=dev)
        return v.mul_(std).to(ps.dtype)

    return tree_from_items((path, one(ps))
                           for path, ps in tree_items(template))


def param_count(template: Template) -> int:
    return sum(int(np.prod(ps.shape)) for ps in leaf_specs(template))


# --------------------------------------------------------------------------
# numerics
# --------------------------------------------------------------------------

def rms_norm(x: Tensor, w: Tensor, eps: float = 1e-6) -> Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.float()).to(x.dtype)


def layer_norm(x: Tensor, w: Tensor, b: Optional[Tensor],
               eps: float = 1e-5) -> Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps) * w.float()
    if b is not None:
        out = out + b.float()
    return out.to(x.dtype)


def apply_norm(kind: str, x: Tensor, p: Dict[str, Tensor]) -> Tensor:
    if kind == "rmsnorm":
        return rms_norm(x, p["w"])
    return layer_norm(x, p["w"], p.get("b"))


def norm_template(kind: str, d: int, bias: bool = False) -> Template:
    t: Template = {"w": ParamSpec((d,), torch.float32, "ones")}
    if kind == "layernorm" and bias:
        t["b"] = ParamSpec((d,), torch.float32, "zeros")
    return t


# --------------------------------------------------------------------------
# RoPE (partial-rotary aware)
# --------------------------------------------------------------------------

def rope_frequencies(head_dim: int, rotary_dim: int, theta: float) -> np.ndarray:
    assert rotary_dim % 2 == 0
    return 1.0 / (theta ** (np.arange(0, rotary_dim, 2, dtype=np.float64)
                            / rotary_dim))


@functools.lru_cache(maxsize=64)
def _rope_freqs(d: int, rd: int, theta: float, device: torch.device) -> Tensor:
    """The f32 frequencies on ``device``, copied there once: a copy from
    host memory per call would block the host on the card every layer."""
    return torch.as_tensor(rope_frequencies(d, rd, theta),
                           dtype=torch.float32).to(device)


def apply_rope(x: Tensor, positions: Tensor, theta: float,
               rotary_frac: float = 1.0) -> Tensor:
    """x (..., T, H, D); positions (..., T) int.  Rotates the first
    rotary_frac*D dims (half-split layout), in f32; the two rotated halves
    are rounded to x's dtype separately."""
    d = x.shape[-1]
    rd = int(d * rotary_frac)
    rd -= rd % 2
    if rd == 0:
        return x
    freqs = _rope_freqs(d, rd, float(theta), x.device)
    ang = positions.float()[..., None] * freqs                  # (..., T, rd/2)
    cos = torch.cos(ang)[..., None, :]                          # (..., T, 1, rd/2)
    sin = torch.sin(ang)[..., None, :]
    xr, xp = x[..., :rd], x[..., rd:]
    xf1, xf2 = xr[..., : rd // 2].float(), xr[..., rd // 2:].float()
    r1 = xf1 * cos - xf2 * sin
    r2 = xf2 * cos + xf1 * sin
    return torch.cat([r1.to(x.dtype), r2.to(x.dtype), xp], dim=-1)


# --------------------------------------------------------------------------
# dense projections & MLPs
# --------------------------------------------------------------------------

def linear(x: Tensor, w: Tensor, dtype: torch.dtype) -> Tensor:
    """x @ w with both operands in ``dtype``; the product accumulates in
    f32 and is rounded to ``dtype`` once (cuBLAS and the CPU's bf16 GEMM
    both accumulate bf16 products in f32)."""
    return torch.matmul(x.to(dtype), w.to(dtype))


def act_fn(name: str, x: Tensor) -> Tensor:
    if name == "silu":
        return F.silu(x)
    if name == "gelu":
        return F.gelu(x, approximate="tanh")
    if name == "relu2":
        r = F.relu(x)
        return r * r
    raise ValueError(name)


def glu_mlp_template(d: int, ff: int, dtype: torch.dtype) -> Template:
    """Gated MLP (SwiGLU / GeGLU)."""
    return {
        "wi": ParamSpec((d, ff), dtype, "fan_in"),
        "wg": ParamSpec((d, ff), dtype, "fan_in"),
        "wo": ParamSpec((ff, d), dtype, "fan_in"),
    }


def glu_mlp(p: Dict[str, Tensor], x: Tensor, act: str,
            dtype: torch.dtype) -> Tensor:
    h = act_fn(act, linear(x, p["wg"], dtype)) * linear(x, p["wi"], dtype)
    return linear(h, p["wo"], dtype)


# --------------------------------------------------------------------------
# token embedding
# --------------------------------------------------------------------------

def embed_template(vocab: int, d: int, dtype: torch.dtype) -> Template:
    return {"tok": ParamSpec((vocab, d), dtype, "fan_in", 1.0)}


def embed_lookup(emb: Tensor, tokens: Tensor, dtype: torch.dtype) -> Tensor:
    """Rows of ``emb`` at ``tokens`` (any integer dtype), in ``dtype``."""
    return emb[tokens.long()].to(dtype)
