"""Shared LM building blocks: parameter templates, norms, RoPE, MLPs.

Parameters are described by a *template* (nested dict of ParamSpec) that
carries shape, dtype, partition spec and init recipe.  The same template
drives three consumers:

  * ``init_params``    real parameters, drawn from a ``torch.Generator``
  * ``shape_tree``     meta tensors (shapes and dtypes, no storage)
  * ``sharding_tree``  each leaf's DTensor placements on a ``DeviceMesh``

Parameters are plain nested dicts of tensors with the JAX package's keys,
so weights carry across one to one (``models.convert``).

A partition spec is the reference's ``PartitionSpec`` as a tuple, one
entry per leading dim: a mesh-axis name, a tuple of names (the dim split
over their product, the first name major) or ``None`` (not split); dims
past its end are not split.  Axis roles, as in the reference:
  'model'  tensor-parallel axis: heads / d_ff / experts / vocab
  'data'   FSDP axis: second param shard for big archs; batch axis
  'pod'    outermost data-parallel axis (several hosts)

Rounding follows the reference: every projection takes its operands in
the compute dtype and rounds its f32-accumulated result to that dtype;
norms and RoPE compute in f32 and cast back.
"""
from __future__ import annotations

import contextlib
import functools
import math
import threading
from typing import Any, Callable, Dict, Iterator, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.launch.mesh import is_dtensor

Tensor = torch.Tensor


class ParamSpec(NamedTuple):
    shape: Tuple[int, ...]
    dtype: torch.dtype
    spec: Tuple[Any, ...]   # partition spec over ('data', 'model') axes
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


def spec_tree(template: Template) -> Dict[str, Any]:
    """Each leaf's partition spec (the reference's ``spec_tree``, as
    tuples)."""
    return tree_map(lambda ps: ps.spec, template)


def placements(spec: Tuple[Any, ...], mesh) -> tuple:
    """DTensor placements of a leaf with partition ``spec`` on ``mesh``:
    for each mesh dim, ``Shard(d)`` where tensor dim d is split over it,
    else ``Replicate()``.  A dim split over several axes is split over the
    first one first (DTensor's order across mesh dims, the reference's
    within a spec entry), so the names must come in the mesh's order."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names or ())
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        axes = (entry,) if isinstance(entry, str) else tuple(entry or ())
        idx = []
        for a in axes:
            if a not in names:
                raise ValueError(f"partition spec {spec}: axis {a!r} is not "
                                 f"a dim of the mesh {names}")
            idx.append(names.index(a))
        if idx != sorted(idx):
            raise ValueError(f"partition spec {spec}: axes {axes} out of the "
                             f"mesh's order {names}")
        for i in idx:
            out[i] = Shard(dim)
    return tuple(out)


def sharding_tree(template: Template, mesh) -> Dict[str, Any]:
    """Each leaf's DTensor placements on ``mesh`` (the reference's
    ``NamedSharding`` tree)."""
    return tree_map(lambda ps: placements(ps.spec, mesh), template)


_REPLICATING = threading.local()


@contextlib.contextmanager
def mesh_context(x: Any):
    """The context sharded code runs in: for a DTensor ``x``, plain
    tensors met along the way (RoPE tables, masks, positions, routing
    indices) count as replicated on its mesh (``implicit_replication``);
    for a plain ``x``, nothing.  Nests: torch's context switches the
    replication off on exit, so only the outermost one enters it (a
    backward after the forward still needs it)."""
    if not is_dtensor(x) or getattr(_REPLICATING, "on", False):
        yield
        return
    from torch.distributed.tensor.experimental import implicit_replication
    _REPLICATING.on = True
    try:
        with implicit_replication():
            yield
    finally:
        _REPLICATING.on = False


def redistribute(x: Any, spec: Tuple[Any, ...]) -> Any:
    """A DTensor ``x`` redistributed to partition ``spec`` on its own mesh
    (the reference's ``with_sharding_constraint``); a plain tensor as
    is."""
    if not is_dtensor(x):
        return x
    mesh = x.device_mesh
    return x.redistribute(mesh, placements(spec, mesh))


def sum_partial(x: Any) -> Any:
    """A DTensor whose pending sums (``Partial`` placements) are summed
    over their ranks, every other placement kept; a plain tensor as is.
    A product contracted over a split dim leaves such a sum, and torch
    2.11's DTensor cannot add a split operand to it ("redistribute from
    S(0) to P(sum) not supported")."""
    if not is_dtensor(x) or not any(p.is_partial() for p in x.placements):
        return x
    from torch.distributed.tensor import Replicate
    return x.redistribute(x.device_mesh, [Replicate() if p.is_partial()
                                          else p for p in x.placements])


def run_on_rows(fn: Callable[..., Any], rows: Tuple[Any, ...],
                whole: Tuple[Any, ...] = (), sums: bool = False) -> Any:
    """``fn(*rows, *whole)`` with sharded operands run on local tensors:
    the ``rows`` operands (dim 0 the batch; ``None`` passes through) take
    the first one's batch split, every other mesh dim replicated, and the
    ``whole`` operands are gathered whole; ``fn`` then computes each row as
    one device would.  The result (a tensor) is split like the rows; with
    ``sums``, ``fn`` returns per-rank sums over its rows (a tuple) and each
    becomes their total over the ranks.  Differentiable (``to_local`` /
    ``from_local``).  It carries the regions whose DTensor sharding rules
    are missing or differ across torch versions: the embedding gather,
    attention and the cross-entropy."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    lead = next(t for t in rows + whole if is_dtensor(t))
    mesh = lead.device_mesh
    rep = [Replicate()] * mesh.ndim
    pl, n_rows = [], 1
    first = rows[0]
    for i, p in enumerate(first.placements if is_dtensor(first) else rep):
        split = (p == Shard(0)
                 and first.shape[0] % (n_rows * mesh.size(i)) == 0)
        n_rows *= mesh.size(i) if split else 1
        pl.append(Shard(0) if split else Replicate())

    # a sum over the batch-split ranks: the whole operands' gradients (each
    # rank's rows contribute their part) and the per-rank sums
    part = [Partial() if p == Shard(0) else Replicate() for p in pl]

    def local(t, placements, grad_placements=None):
        if t is None:
            return None
        if not is_dtensor(t):     # the same on every rank: replicated
            t = DTensor.from_local(t, mesh, rep, run_check=False)
        return t.redistribute(mesh, placements).to_local(
            grad_placements=grad_placements)

    out = fn(*(local(t, pl) for t in rows),
             *(local(t, rep, part) for t in whole))
    if not sums:
        return DTensor.from_local(out, mesh, pl, run_check=False)
    # each rank's sum enters the total once; in backward the total's
    # (replicated) gradient comes back to every rank whole
    return tuple(DTensor.from_local(o, mesh, part, run_check=False)
                 for o in out)


def shape_tree(template: Template, mesh=None) -> Dict[str, Any]:
    """Stand-ins with no storage: meta tensors of each leaf's shape and
    dtype; with ``mesh``, ``(meta tensor, placements)`` pairs."""
    def one(ps: ParamSpec):
        t = torch.empty(ps.shape, dtype=ps.dtype, device="meta")
        return t if mesh is None else (t, placements(ps.spec, mesh))
    return tree_map(one, template)


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
    t: Template = {"w": ParamSpec((d,), torch.float32, (None,), "ones")}
    if kind == "layernorm" and bias:
        t["b"] = ParamSpec((d,), torch.float32, (None,), "zeros")
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
    """Gated MLP (SwiGLU / GeGLU).  ff sharded over model, d over data
    (the reference's specs, with or without ``fsdp_params``)."""
    return {
        "wi": ParamSpec((d, ff), dtype, ("data", "model"), "fan_in"),
        "wg": ParamSpec((d, ff), dtype, ("data", "model"), "fan_in"),
        "wo": ParamSpec((ff, d), dtype, ("model", "data"), "fan_in"),
    }


def glu_mlp(p: Dict[str, Tensor], x: Tensor, act: str,
            dtype: torch.dtype) -> Tensor:
    h = act_fn(act, linear(x, p["wg"], dtype)) * linear(x, p["wi"], dtype)
    return linear(h, p["wo"], dtype)


# --------------------------------------------------------------------------
# token embedding
# --------------------------------------------------------------------------

def embed_template(vocab: int, d: int, dtype: torch.dtype) -> Template:
    return {"tok": ParamSpec((vocab, d), dtype, ("model", "data"),
                             "fan_in", 1.0)}


def embed_lookup(emb: Tensor, tokens: Tensor, dtype: torch.dtype) -> Tensor:
    """Rows of ``emb`` at ``tokens`` (any integer dtype), in ``dtype``.
    Sharded, each rank gathers its tokens' rows from the whole table
    (:func:`run_on_rows`)."""
    if is_dtensor(tokens) or is_dtensor(emb):
        return run_on_rows(lambda tok, table: table[tok.long()].to(dtype),
                           (tokens,), (emb,))
    return emb[tokens.long()].to(dtype)
