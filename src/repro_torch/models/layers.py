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
from torch.utils.checkpoint import checkpoint

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
                whole: Tuple[Any, ...] = (), sums: bool = False, *,
                name: str) -> Any:
    """``fn(*rows, *whole)`` with sharded operands run on local tensors:
    the ``rows`` operands (dim 0 the batch; ``None`` passes through) take
    the first one's batch split, every other mesh dim replicated, and the
    ``whole`` operands are gathered whole; ``fn`` then computes each row as
    one device would.  The result (a tensor, or a tuple of them) is split
    like the rows; with ``sums``, ``fn`` returns per-rank sums over its
    rows (a tuple) and each becomes their total over the ranks.  Differentiable (``to_local`` /
    ``from_local``).  It carries what has no split to use (a
    :class:`Region` takes the rest): the embedding and cross-entropy of a
    vocabulary that is not split over 'model', and attention whose head
    groups cannot split a rank's rows among their ranks
    (``models.attention.head_parallel``: a batch-1 prefill of heads the
    'model' ranks do not divide).  ``name`` names the region in
    ``REGION_TRACE``.  A layer run this way takes its norm and residual
    inside ``fn`` (:func:`rows_layer`)."""
    trace_region("run_on_rows", region=name)
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
        if isinstance(out, tuple):
            return tuple(DTensor.from_local(o, mesh, pl, run_check=False)
                         for o in out)
        return DTensor.from_local(out, mesh, pl, run_check=False)
    # each rank's sum enters the total once; in backward the total's
    # (replicated) gradient comes back to every rank whole
    return tuple(DTensor.from_local(o, mesh, part, run_check=False)
                 for o in out)


# --------------------------------------------------------------------------
# a loop of same-shaped trips (jax.lax.scan with no carry)
# --------------------------------------------------------------------------

# replacements of scan_trips while one is entered, innermost last: the
# dry run's cost meter counts the loop as a scan (launch.op_cost); None
# runs the loop itself
SCAN_OVERRIDES: list = []


@contextlib.contextmanager
def scan_override(fn: Optional[Callable[..., Any]]):
    """Inside, :func:`scan_trips` calls ``fn(body, w, xs)`` in its place
    (``None``: the loop itself)."""
    SCAN_OVERRIDES.append(fn)
    try:
        yield
    finally:
        SCAN_OVERRIDES.pop()


def scan_trips(body: Callable[..., Tuple[Tensor, ...]],
               w: Dict[str, Tensor], xs: Tensor) -> Tuple[Tensor, ...]:
    """``body(w, x)`` (a tuple of tensors) for each x of ``xs`` along its
    leading dim, each output stacked over the trips.  Under autograd with
    more than one trip each trip is checkpointed: recomputed in backward.
    Every trip is the same program on operands of the same shapes, so a
    cost meter may count one trip times their number
    (:func:`scan_override`)."""
    if SCAN_OVERRIDES and SCAN_OVERRIDES[-1] is not None:
        return SCAN_OVERRIDES[-1](body, w, xs)
    trips = xs.unbind(0)
    remat = len(trips) > 1 and torch.is_grad_enabled()
    outs = [checkpoint(body, w, x, use_reentrant=False) if remat
            else body(w, x) for x in trips]
    return tuple(torch.stack(o) for o in zip(*outs))


# --------------------------------------------------------------------------
# regions on local shards, with explicit collectives
# --------------------------------------------------------------------------

# a list while a test records the regions that ran (name, local sizes),
# else None
REGION_TRACE: Optional[list] = None


def trace_region(name: str, **info) -> None:
    if REGION_TRACE is not None:
        REGION_TRACE.append((name, info))


@contextlib.contextmanager
def dtensor_ops(ops: list):
    """Inside, each aten op with a DTensor operand (an op DTensor's
    sharding rules would plan) is noted in ``ops`` by name and handed on to
    DTensor: the check that a region runs on local shards only."""
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode

    class Noted(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(issubclass(t, DTensor) for t in types):
                ops.append(str(func))
                return NotImplemented
            return func(*args, **(kwargs or {}))

    with Noted():
        yield ops


def _gather_dim(x: Tensor, dim: int, group) -> Tensor:
    """The group's blocks of ``x`` concatenated along ``dim`` in rank
    order (every block the same shape)."""
    import torch.distributed as dist
    n = dist.get_world_size(group)
    if n == 1:
        return x
    xt = x.movedim(dim, 0).contiguous()
    out = xt.new_empty((n * xt.shape[0],) + tuple(xt.shape[1:]))
    dist.all_gather_into_tensor(out, xt, group=group)
    return out.movedim(0, dim)


def _scatter_dim(x: Tensor, dim: int, group) -> Tensor:
    """The sum of the group's ``x`` over its ranks, this rank's block of
    it along ``dim`` (split evenly)."""
    import torch.distributed as dist
    n = dist.get_world_size(group)
    if n == 1:
        return x
    xt = x.movedim(dim, 0).contiguous()
    out = xt.new_empty((xt.shape[0] // n,) + tuple(xt.shape[1:]))
    dist.reduce_scatter_tensor(out, xt, group=group)
    return out.movedim(0, dim)


def _reduce(x: Tensor, group, op=None) -> Tensor:
    import torch.distributed as dist
    out = x.contiguous().clone()
    if dist.get_world_size(group) > 1:
        dist.all_reduce(out, op=op or dist.ReduceOp.SUM, group=group)
    return out


class _AllGather(torch.autograd.Function):
    """All-gather along a dim; backward the dual reduce-scatter of the
    ranks' partial gradients (``grad_sum``), or, where every rank
    computed the same gradient, this rank's block of it."""

    @staticmethod
    def forward(ctx, x, dim, group, grad_sum):
        ctx.dim, ctx.group, ctx.grad_sum = dim, group, grad_sum
        return _gather_dim(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist
        if ctx.grad_sum:
            return _scatter_dim(g, ctx.dim, ctx.group), None, None, None
        n = dist.get_world_size(ctx.group)
        own = g.chunk(n, ctx.dim)[dist.get_rank(ctx.group)]
        return own.contiguous(), None, None, None


class _ReduceScatter(torch.autograd.Function):
    """Reduce-scatter along a dim; backward the all-gather."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _scatter_dim(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _gather_dim(g, ctx.dim, ctx.group), None, None


class _AllReduce(torch.autograd.Function):
    """Sum over the group; backward the identity (the sum is used the
    same way on every rank)."""

    @staticmethod
    def forward(ctx, x, group):
        return _reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumGrad(torch.autograd.Function):
    """The identity; backward the sum of the ranks' partial gradients."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _reduce(g, ctx.group), None


def all_gather(x: Tensor, dim: int, group, grad_sum: bool = True) -> Tensor:
    return _AllGather.apply(x, dim, group, grad_sum)


def all_reduce(x: Tensor, group) -> Tensor:
    return _AllReduce.apply(x, group)


def all_reduce_sum_grad(x: Tensor, group) -> Tensor:
    """Sum over the group where each rank then uses the sum its own way
    (a contraction over a split dim feeding the rank's channels): backward
    the sum of the ranks' gradients too."""
    return _SumGrad.apply(_AllReduce.apply(x, group), group)


def all_reduce_max(x: Tensor, group) -> Tensor:
    """The elementwise max over the group (no gradient)."""
    import torch.distributed as dist
    return _reduce(x.detach(), group, dist.ReduceOp.MAX)


def local_offset(t) -> Tuple[int, ...]:
    """Where the local block of the DTensor ``t`` starts in the global
    tensor (DTensor's own uneven-split arithmetic)."""
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    return tuple(compute_local_shape_and_global_offset(
        t.shape, t.device_mesh, t.placements)[1])


def model_split(t, dim: int) -> bool:
    """Whether the DTensor ``t`` is split over the mesh's 'model' dim on
    its tensor dim ``dim``."""
    from torch.distributed.tensor import Shard
    if not is_dtensor(t):
        return False
    names = tuple(t.device_mesh.mesh_dim_names or ())
    return ("model" in names
            and t.placements[names.index("model")] == Shard(dim % t.ndim))


class Region:
    """One region of the sharded step run on local shards: its operands'
    local blocks (``to_local`` with the gradient placements stated) and
    its collectives issued explicitly on the process group of a named
    mesh dim, never through DTensor's sharding rules, so it runs the same
    on every torch version.  The region's own split is over 'model'
    (heads, vocabulary, experts); the batch stays split over the mesh
    dims ``like`` (a batch operand: dim 0 its rows) is split over; every
    other split of a weight (FSDP over 'data') is gathered.  The result
    comes back as a DTensor in the activations' layout (:meth:`out`) or
    as per-rank sums (:meth:`sums`).

    Gradients: a weight's local gradient is a sum over the batch ranks
    (``Partial``) and over 'model' where the weight is replicated there
    (each rank's heads, vocabulary block or experts give their part); an
    explicit gather's backward is the reduce-scatter over the same group
    (its own block where every rank computed the same).

    A layer is one region from its input to its output: :meth:`act` gathers
    d once and runs the pre-norm on whole rows (its sum over d in the
    unsharded order), the block runs on its local weights, and :meth:`out`
    sums the partial result over 'model' into the activations' layout and
    adds the residual there, on local shards."""

    def __init__(self, like, mesh=None):
        from torch.distributed.tensor import Shard
        self.mesh = like.device_mesh if is_dtensor(like) else mesh
        names = tuple(self.mesh.mesh_dim_names or ())
        self.model = names.index("model") if "model" in names else None
        self.batch = tuple(
            i for i, p in enumerate(like.placements)
            if p == Shard(0) and i != self.model) if is_dtensor(like) else ()
        self.like = like if is_dtensor(like) else None
        self.d_split = False
        self.resid: Optional[Tensor] = None     # act's input, local block
        self.row_split = 1                      # act's ``row_split``

    # ------------------------------------------------------------ groups
    def group(self, dim: int):
        return self.mesh.get_group(dim)

    @property
    def model_size(self) -> int:
        return 1 if self.model is None else self.mesh.size(self.model)

    @property
    def model_rank(self) -> int:
        return (0 if self.model is None
                else self.mesh.get_local_rank(self.model))

    @property
    def model_group(self):
        return None if self.model is None else self.group(self.model)

    def model_subgroup(self, size: int):
        """The group of this rank's ``size`` consecutive 'model' ranks
        (created by its members alone, once a mesh)."""
        import torch.distributed as dist
        groups = getattr(self.mesh, "_region_subgroups", None)
        if groups is None:
            groups = {}
            setattr(self.mesh, "_region_subgroups", groups)
        if size not in groups:
            ranks = dist.get_process_group_ranks(self.model_group)
            lo = self.model_rank // size * size
            groups[size] = dist.new_group(ranks[lo:lo + size],
                                          use_local_synchronization=True)
        return groups[size]

    # ---------------------------------------------------------- operands
    def layout(self, model=None) -> list:
        """Placements of a batch operand in the region: its rows split as
        the batch, 'model' as ``model`` (replicated by default)."""
        from torch.distributed.tensor import Replicate, Shard
        pl = [Shard(0) if i in self.batch else Replicate()
              for i in range(self.mesh.ndim)]
        if model is not None:
            pl[self.model] = model
        return pl

    def rows(self, t) -> Optional[Tensor]:
        """This rank's rows of a batch operand (tokens, labels, a mask,
        positions), its block of them after :meth:`act` with a
        ``row_split``; a plain tensor counts as replicated."""
        if t is None:
            return None
        if is_dtensor(t):
            t = t.redistribute(self.mesh, self.layout()).to_local()
        elif self.like is not None:
            off, n = self.row_block()
            t = t[off:off + n]
        return self._row_part(t)

    def _row_part(self, t: Tensor) -> Tensor:
        """This rank's block of its rows ``t`` under ``row_split``."""
        n = self.row_split
        if n == 1:
            return t
        b = t.shape[0] // n
        i = self.model_rank % n
        return t[i * b:(i + 1) * b]

    def row_block(self) -> Tuple[int, int]:
        """(first row, row count) of this rank's rows of the batch."""
        from torch.distributed.tensor._utils import (
            compute_local_shape_and_global_offset)
        shape, off = compute_local_shape_and_global_offset(
            self.like.shape, self.mesh, self.layout())
        return off[0], shape[0]

    def act(self, x, norm: Optional[Tuple[str, Dict[str, Any]]] = None,
            row_split: int = 1) -> Tensor:
        """This rank's rows of the activation ``x`` (B, ..., d) with d
        whole: d gathered over 'model' where it is split there (backward:
        the reduce-scatter), else as it is (backward: the sum of the ranks'
        partial gradients).  With ``norm`` = (kind, params) the rows come
        back normed (:func:`apply_norm` on whole rows, its weights local).
        :meth:`out` returns the region's result in the same layout, and
        adds x there as the residual.  With ``row_split`` n > 1 each run
        of n consecutive 'model' ranks (a head group) splits those rows
        among it: this rank keeps the (model rank mod n)-th of n equal
        blocks, taken before the norm, :meth:`rows` gives its block of a
        batch operand, and :meth:`out` takes a result of that block."""
        from torch.distributed.tensor import Shard
        last = Shard(x.ndim - 1)
        split = (self.model is not None
                 and x.placements[self.model] == last
                 and x.shape[-1] % self.model_size == 0)
        pl = self.layout(last if split else None)
        if list(x.placements) != pl:
            x = x.redistribute(self.mesh, pl)
        self.d_split = split
        xl = self.resid = x.to_local()
        if self.model is not None:
            xl = (all_gather(xl, xl.ndim - 1, self.model_group) if split
                  else _SumGrad.apply(xl, self.model_group))
        self.row_split = row_split
        xl = self._row_part(xl)
        if norm is not None:
            kind, p = norm
            xl = apply_norm(kind, xl, self.weights(p))
        return xl

    def weights(self, tree: Dict[str, Any]) -> Dict[str, Any]:
        """:meth:`weight` of every leaf of a parameter tree."""
        return tree_map(self.weight, tree)

    def weight(self, w, model_part: bool = True) -> Tensor:
        """The local block of the weight ``w``: its 'model' split kept,
        every other split gathered on that dim's group (FSDP).  Its
        gradient is a sum over the batch ranks, and over the 'model' ranks
        unless every one of them computed all of it (``model_part``
        False)."""
        from torch.distributed.tensor import Partial, Replicate
        grad = [p if p.is_shard() else Partial()
                if (i == self.model and model_part) or i in self.batch
                else Replicate() for i, p in enumerate(w.placements)]
        wl = w.to_local(grad_placements=grad)
        for i in reversed(range(self.mesh.ndim)):
            p = w.placements[i]
            if i != self.model and p.is_shard():
                wl = all_gather(wl, p.dim, self.group(i), i in self.batch)
        return wl

    def model_blocks(self, w, dim: int, size: int) -> Tensor:
        """The 'model' blocks of the weight ``w`` (split there on ``dim``)
        of the run of ``size`` consecutive 'model' ranks this rank is in,
        concatenated (:meth:`weight`'s block where ``size`` is 1); backward
        the reduce-scatter of the run's partial gradients."""
        w = self.weight(w)
        if size == 1:
            return w
        return all_gather(w, dim, self.model_group if size == self.model_size
                          else self.model_subgroup(size))

    def gather_rows(self, x: Tensor) -> Tensor:
        """Every rank's rows of the local ``x`` (dim 0), over the batch
        dims; backward the reduce-scatter of the ranks' partial
        gradients."""
        for i in reversed(self.batch):
            x = all_gather(x, 0, self.group(i))
        return x

    # ----------------------------------------------------------- results
    def out(self, y: Tensor, residual: bool = False,
            dtype: Optional[torch.dtype] = None):
        """The region's local result ``y`` (B_loc, ..., d), a partial sum
        over 'model', summed there and returned as a DTensor in the
        activations' layout: reduce-scattered onto d where :meth:`act` found
        d split (or ``d_split`` was set), else all-reduced; then cast to
        ``dtype`` and, with ``residual``, added to :meth:`act`'s input on
        the local block (h + mixed, the unsharded order).  After a
        ``row_split`` y holds this rank's block of the rows only: it enters
        the sum in that block, zeros in the others, so each (row block,
        head group) term is summed once and the bytes moved are those of
        the whole rows."""
        from torch.distributed.tensor import DTensor, Shard
        if self.row_split > 1:
            i = self.model_rank % self.row_split
            y = torch.cat([y if j == i else torch.zeros_like(y)
                           for j in range(self.row_split)], 0)
        if self.model is None:
            pl = self.layout()
        elif self.d_split:
            y = _ReduceScatter.apply(y, y.ndim - 1, self.model_group)
            pl = self.layout(Shard(y.ndim - 1))
        else:
            y = all_reduce(y, self.model_group)
            pl = self.layout()
        if dtype is not None:
            y = y.to(dtype)
        if residual:
            y = self.resid + y
        shape = list(y.shape)
        if self.like is not None:
            shape[0] = self.like.shape[0]
        if self.d_split:
            shape[-1] *= self.model_size
        return DTensor.from_local(y, self.mesh, pl, run_check=False,
                                  shape=torch.Size(shape),
                                  stride=_contiguous_stride(shape))

    def put(self, t: Tensor, model_dim: Optional[int] = None):
        """A local block ``t`` (this rank's rows) as a DTensor: its rows
        split like the batch, its dim ``model_dim`` split over 'model' (a
        rank's heads or channels), else replicated there."""
        from torch.distributed.tensor import DTensor, Shard
        shape = list(t.shape)
        if self.like is not None:
            shape[0] = self.like.shape[0]
        model = None
        if model_dim is not None and self.model is not None:
            model = Shard(model_dim)
            shape[model_dim] *= self.model_size
        t = t.contiguous()
        return DTensor.from_local(t, self.mesh, self.layout(model),
                                  run_check=False, shape=torch.Size(shape),
                                  stride=_contiguous_stride(shape))

    def even(self, w, dim: int) -> bool:
        """Whether the weight ``w`` is split over 'model' on ``dim`` in
        equal blocks (or not split there at all, with no 'model' dim)."""
        if self.model is None:
            return True
        return model_split(w, dim) and w.shape[dim] % self.model_size == 0

    def sums(self, *vals: Tensor, over_model: bool = False):
        """Per-rank sums as DTensors whose value is their total over the
        batch ranks (and over 'model' with ``over_model``); in backward
        the total's gradient comes back to every rank whole."""
        from torch.distributed.tensor import DTensor, Partial, Replicate
        pl = [Partial() if i in self.batch or (over_model and i == self.model)
              else Replicate() for i in range(self.mesh.ndim)]
        return tuple(DTensor.from_local(v, self.mesh, pl, run_check=False)
                     for v in vals)


def _contiguous_stride(shape) -> Tuple[int, ...]:
    out, acc = [], 1
    for s in reversed(tuple(shape)):
        out.append(acc)
        acc *= int(s)
    return tuple(reversed(out))


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


def norm_region(kind: str, h, p: Dict[str, Tensor]):
    """apply_norm on local shards (a :class:`Region`) for a norm with no
    block behind it (the final norm): d gathered once over 'model' where h
    is split there, the norm on whole rows, and this rank's block of d
    kept, in h's layout; with d whole, the norm on the local rows as they
    are (every 'model' rank computes all of it)."""
    from torch.distributed.tensor import Shard
    reg = Region(h)
    split = (reg.model is not None
             and h.placements[reg.model] == Shard(h.ndim - 1)
             and h.shape[-1] % reg.model_size == 0)
    pl = reg.layout(Shard(h.ndim - 1) if split else None)
    if list(h.placements) != pl:
        h = h.redistribute(reg.mesh, pl)
    xl = h.to_local()
    if split:
        xl = all_gather(xl, xl.ndim - 1, reg.model_group)
    out = apply_norm(kind, xl, tree_map(
        lambda w: reg.weight(w, model_part=split), p))
    if split:
        n = out.shape[-1] // reg.model_size
        out = out[..., reg.model_rank * n:(reg.model_rank + 1) * n]
    trace_region("norm")
    return reg.put(out, out.ndim - 1 if split else None)


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


def glu_split(reg: "Region", p: Dict[str, Tensor]) -> bool:
    """Whether a GLU's weights run on their 'model' blocks: wi / wg on
    their ff columns and wo on its rows, in equal blocks."""
    return (reg.even(p["wi"], 1) and reg.even(p["wg"], 1)
            and reg.even(p["wo"], 0))


def glu_mlp_region(p: Dict[str, Tensor], h, norm: Tuple[str, Dict[str, Any]],
                   act: str, dtype: torch.dtype):
    """h + glu_mlp(norm(h)) on local shards (a :class:`Region`, the
    reference's layout): h's rows with d gathered once and normed whole,
    wi / wg on their ff column block and wo on its row block, the partial
    sum reduce-scattered onto d (or all-reduced) and the residual added on
    the local block.  Weights that do not split so run whole on each
    rank's rows (:func:`rows_layer`)."""
    reg = Region(h)
    if not glu_split(reg, p):
        return rows_layer(lambda x, q: glu_mlp(q, x, act, dtype), h, p,
                          norm, name="dense")
    xl = reg.act(h, norm)
    w = reg.weights(p)
    trace_region("dense", ff=w["wi"].shape[1])
    return reg.out(glu_mlp(w, xl, act, dtype), residual=True)


def rows_layer(fn: Callable[..., Any], h, p: Dict[str, Any],
               norm: Tuple[str, Dict[str, Any]], *, name: str,
               rows: Tuple[Any, ...] = (), extra: int = 0):
    """h + fn(norm(h), params, *rows) on each rank's rows with every
    weight whole (:func:`run_on_rows`): a block with no split to use.
    ``fn`` may return more than the block's output (its first result):
    ``extra`` more tensors (a prefill cache), split like the rows.  The
    new h takes h's layout."""
    kind, np_ = norm
    paths = [k for k, _ in tree_items(p)] + [("__norm",) + k
                                             for k, _ in tree_items(np_)]
    leaves = [v for _, v in tree_items(p)] + [v for _, v in tree_items(np_)]

    def body(hl, *args):
        rl, wl = args[:len(rows)], args[len(rows):]
        tree = tree_from_items(zip(paths, wl))
        nt = tree.pop("__norm")
        res = fn(apply_norm(kind, hl, nt), tree, *rl)
        out = res[0] if extra else res
        out = hl + out
        return (out,) + tuple(res[1:]) if extra else out

    res = run_on_rows(body, (h,) + tuple(rows), tuple(leaves), name=name)
    out = res[0] if extra else res
    if list(out.placements) != list(h.placements):
        out = out.redistribute(h.device_mesh, h.placements)
    return (out,) + tuple(res[1:]) if extra else out


# --------------------------------------------------------------------------
# token embedding
# --------------------------------------------------------------------------

def embed_template(vocab: int, d: int, dtype: torch.dtype) -> Template:
    return {"tok": ParamSpec((vocab, d), dtype, ("model", "data"),
                             "fan_in", 1.0)}


def embed_lookup(emb: Tensor, tokens: Tensor, dtype: torch.dtype,
                 shard_d: bool = False) -> Tensor:
    """Rows of ``emb`` at ``tokens`` (any integer dtype), in ``dtype``.
    A table whose vocabulary is split over 'model' is looked up
    vocab-parallel (:func:`_embed_vocab_parallel`; ``shard_d``: the result
    split on d over 'model', the activations' layout); any other sharded
    table is gathered whole for each rank's tokens (:func:`run_on_rows`)."""
    if model_split(emb, 0):
        return _embed_vocab_parallel(emb, tokens, dtype, shard_d)
    if is_dtensor(tokens) or is_dtensor(emb):
        return run_on_rows(lambda tok, table: table[tok.long()].to(dtype),
                           (tokens,), (emb,), name="embed")
    return emb[tokens.long()].to(dtype)


def _embed_vocab_parallel(emb, tokens, dtype: torch.dtype, shard_d: bool):
    """Each rank looks up the tokens inside its block of the vocabulary
    (zeros elsewhere; the block from DTensor's own offsets, so an uneven
    split is right) with d gathered whole (FSDP), and the sum over
    'model' -- one nonzero row a token, so exact -- is reduce-scattered
    onto d (``shard_d``) or all-reduced.  In backward the table's gradient
    stays on the rank's block."""
    reg = Region(tokens, mesh=emb.device_mesh)
    tok = reg.rows(tokens).long()
    table = reg.weight(emb)                                   # (V_loc, d)
    v0, n = local_offset(emb)[0], table.shape[0]
    own = (tok >= v0) & (tok < v0 + n)
    rows = table[torch.where(own, tok - v0, torch.zeros_like(tok))]
    rows = torch.where(own[..., None], rows.to(dtype),
                       torch.zeros((), dtype=dtype, device=rows.device))
    reg.d_split = (shard_d and reg.model is not None
                   and emb.shape[1] % reg.model_size == 0)
    trace_region("embed", vocab_rows=n)
    return reg.out(rows)
