"""Trip-exact cost analysis from the aten ops a step runs (the JAX
package's ``launch/jaxpr_cost.py``).

The reference walks the jaxpr and multiplies each scan body by its trip
count.  Here loops are Python loops, so :class:`CostMode`, a
``TorchDispatchMode``, counts every aten op as it runs and the trip counts
come out exact by themselves.  It runs on fake tensors (``FakeTensorMode``:
shapes and dtypes, no storage), so a full-size step costs no memory.

Byte model (HBM traffic of a well-fused program), as the reference's:
  * matmuls (``mm``, ``bmm``, ``addmm``, ``baddbmm``, ``_scaled_mm``, ...):
    2 x batch x m x n x k FLOPs; their bytes are both operands plus the
    output, each operand at its *source* bytes: a chain of converts,
    scale-multiplies, transposes and views is followed back to the stored
    tensor (an int8 cache dequantized on the fly is read as int8);
  * gathers (``index_select``, ``embedding``, ``gather``, advanced
    indexing): the output's bytes; in-place updates (``index_put_``,
    ``index_copy_``, ``scatter*``, ``slice_scatter``, ``copy_``): the
    update payload, not the destination;
  * elementwise ops: the output's element count in FLOPs, reductions the
    input's, ``sort``/``topk`` n log2 n, ``linalg`` factorizations the
    reference's factors; all assumed fused (no bytes);
  * the arguments of ``fn`` are charged once (the jaxpr's invars).

A loop whose trips are the same program on same-shaped operands
(``models.layers.scan_trips``: the MoE's routing chunks, the last one
zero-padded to the shape of the others) is counted as the reference
counts a ``lax.scan``: its body once, times its trips (:func:`loop_trips`,
which the mode puts in the loop's place while it is entered).  Forward,
the recompute and the backward of the one traced trip are scaled, and so
is the sum of its weights' gradients over the trips; the loop itself,
run under the mode trip by trip, counts the same, exactly.  Outside the
mode the loop runs every trip.

Data-dependent host reads (``aten._local_scalar_dense``: ``bool()``,
``float()``, ``int()``, ``.item()`` of a tensor) have no answer on a fake
tensor.  The mode answers them itself: a boolean read (a loop's
condition) reads True ``while_trips`` times in a row at its call site and
then False once, so a loop goes on for ``while_trips`` trips and ends; each
such call site counts in ``guessed_whiles``.  Any other read (a learning
rate, a statistic) gets the fixed value 1.

Under a mesh (DTensor operands) the mode sees the ops that the rank runs
on its local blocks, and the collectives it issues, with their local
shapes: the figures are one rank's (rank 0's under the dry run's fake
process group).  For an evenly split op that is the global cost divided
by the device count, the reference's per-device figure; so are the
regions on local shards (``layers.Region``: head-parallel attention,
the vocab-parallel embedding and cross-entropy, the expert-parallel
MoE), whose collectives are the c10d ones they issue; what runs whole on
each rank's rows (``layers.run_on_rows``: an unsplit vocabulary, a head
group that cannot split its rows) counts whole.  The
shape computations DTensor runs on global fake tensors to plan a
sharding are not the rank's work and are left out.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import sys
import traceback
from typing import Any, Dict, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

aten = torch.ops.aten

MATMUL = {"mm", "bmm", "addmm", "baddbmm", "addbmm", "_scaled_mm",
          "_int_mm", "mv", "addmv", "dot", "vdot", "_addmm_activation"}

GATHER = {"index_select", "embedding", "gather", "index", "take",
          "_unsafe_index", "index_select_backward"}

UPDATE = {"index_put", "_index_put_impl", "index_copy", "index_add",
          "scatter", "scatter_add", "scatter_reduce", "slice_scatter",
          "select_scatter", "diagonal_scatter", "copy",
          "embedding_dense_backward", "masked_scatter"}

REDUCE = {"sum", "mean", "amax", "amin", "max", "min", "prod", "logsumexp",
          "argmax", "argmin", "var", "std", "var_mean", "std_mean", "norm",
          "linalg_vector_norm", "any", "all", "nansum", "_softmax",
          "_log_softmax", "cumsum", "cumprod", "logcumsumexp", "aminmax"}

SORT = {"sort", "topk", "argsort", "kthvalue", "median", "msort"}

LINALG = {"_linalg_eigh": 9.0, "linalg_eigh": 9.0,
          "linalg_cholesky_ex": 1.0 / 3.0, "cholesky": 1.0 / 3.0,
          "linalg_lu_factor_ex": 2.0 / 3.0, "_linalg_lu": 2.0 / 3.0,
          "linalg_lu": 2.0 / 3.0, "linalg_qr": 4.0 / 3.0,
          "triangular_solve": 1.0, "linalg_solve_triangular": 1.0}

# a matmul operand's chain back to its stored tensor
SOURCE_CHAIN = {"_to_copy", "to", "mul", "t", "transpose", "permute",
                "view", "_unsafe_view", "reshape", "expand", "clone",
                "contiguous", "alias", "unsqueeze", "squeeze", "slice",
                "_reshape_alias", "convert_element_type"}

# c10d collectives, by the name they are reported under: the functional
# ones DTensor issues, and the plain ones of the cell gather, ef_psum and
# the regions on local shards (``models.layers.Region``)
COLLECTIVES = {
    "all_gather_into_tensor": "all_gather_into_tensor",
    "_allgather_base_": "all_gather_into_tensor",
    "reduce_scatter_tensor": "reduce_scatter_tensor",
    "_reduce_scatter_base_": "reduce_scatter_tensor",
    "all_reduce": "all_reduce",
    "allreduce_": "all_reduce",
    "all_to_all_single": "all_to_all_single",
}

ZERO = {"wait_tensor", "detach", "alias", "lift_fresh", "empty",
        "empty_strided", "empty_like", "zeros", "ones", "full", "arange",
        "scalar_tensor", "new_empty", "new_empty_strided", "new_zeros",
        "new_ones", "new_full", "device", "dim", "sym_size", "sym_stride",
        "sym_numel", "sym_storage_offset", "is_same_size", "_to_copy", "to",
        "clone", "view", "_unsafe_view", "reshape", "expand", "t",
        "transpose", "permute", "unsqueeze", "squeeze", "slice", "select",
        "split", "split_with_sizes", "unbind", "cat", "stack", "narrow",
        "as_strided", "contiguous", "flatten", "unflatten", "repeat",
        "_reshape_alias", "chunk", "zeros_like", "ones_like", "full_like",
        "fill", "set_", "resize_", "randn", "rand", "randint", "normal",
        "uniform", "bernoulli", "pad", "constant_pad_nd", "flip", "roll",
        "tril", "triu", "diag_embed", "diagonal", "detach_", "_assert_async",
        "_local_scalar_dense", "is_nonzero", "item", "lift_fresh_copy"}


def _nbytes(t) -> float:
    if not isinstance(t, torch.Tensor):
        return 0.0
    return float(t.numel()) * t.element_size()


def _nelems(t) -> float:
    return float(t.numel()) if isinstance(t, torch.Tensor) else 0.0


def _tensors(x) -> List[torch.Tensor]:
    return [t for t in tree_flatten(x)[0] if isinstance(t, torch.Tensor)]


@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0
    guessed_whiles: int = 0


# DTensor's planning: output shapes computed on global fake tensors, and
# the index arithmetic of an uneven strided split
_PLANNING = {"_propagate_tensor_meta_non_cached",
             "local_shard_size_and_offset", "_local_shard_size"}


def _planning() -> bool:
    """Whether the op runs inside DTensor's planning (not the rank's
    work)."""
    f = sys._getframe(2)
    for _ in range(8):
        if f is None:
            return False
        if f.f_code.co_name in _PLANNING:
            return True
        f = f.f_back
    return False


@contextlib.contextmanager
def _strided_offsets_on_host():
    """DTensor computes the offsets of an uneven strided split from an
    index tensor it makes with ``arange`` and reads with ``tolist``; under
    a fake mode that tensor is fake and cannot be read.  Its arithmetic
    runs on real (host) tensors here, once for each set of arguments: it
    depends on sizes only, and DTensor's search for a redistribution on a
    3-d mesh asks for the same split thousands of times."""
    try:
        from torch.distributed.tensor.placement_types import _StridedShard
    except ImportError:
        yield
        return
    fn = _StridedShard.__dict__.get("local_shard_size_and_offset")
    if fn is None:
        yield
        return
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    inner = fn.__func__ if isinstance(fn, staticmethod) else fn

    seen = {}

    @functools.wraps(inner)
    def on_host(*a, **kw):
        key = (a, tuple(sorted(kw.items())))
        if key not in seen:
            with unset_fake_temporarily():
                seen[key] = inner(*a, **kw)
        return seen[key]

    _StridedShard.local_shard_size_and_offset = (
        staticmethod(on_host) if isinstance(fn, staticmethod) else on_host)
    try:
        yield
    finally:
        _StridedShard.local_shard_size_and_offset = fn


def _call_site() -> str:
    """file:line of the innermost frame outside torch and this module."""
    for fr in reversed(traceback.extract_stack()):
        name = fr.filename.replace("\\", "/")
        if "/torch/" not in name and not name.endswith("op_cost.py"):
            return f"{name}:{fr.lineno}"
    return "?"


class CostMode(TorchDispatchMode):
    """Counts the aten ops that run inside it (see the module docstring).
    ``cost`` holds the totals, ``collective_bytes`` / ``collective_counts``
    the collectives by name (output bytes, as the reference's HLO parser
    counts them) and ``matmul_flops`` the matmuls' share of the FLOPs."""

    def __init__(self, while_trips: float = 1.0):
        super().__init__()
        from torch.utils.weak import WeakIdKeyDictionary
        self.while_trips = float(while_trips)
        self.scale = 1                          # each op counts this often
        self.cost = Cost()
        self.collective_bytes: Dict[str, float] = {}
        self.collective_counts: Dict[str, int] = {}
        self.matmul_flops = 0.0
        self._producer = WeakIdKeyDictionary()  # view/convert -> input
        self._reads: Dict[str, int] = {}        # call site -> run of Trues
        self._sites = set()

    def __enter__(self):
        from repro_torch.models import layers
        self._scan = layers.scan_override(functools.partial(loop_trips, self))
        self._scan.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        self._scan.__exit__(*exc)
        return super().__exit__(*exc)

    @contextlib.contextmanager
    def scaled(self, n: int):
        """Inside, every op counts ``n`` times (nested scales multiply)."""
        before = self.scale
        self.scale = before * int(n)
        try:
            yield
        finally:
            self.scale = before

    # ---------------------------------------------------------- helpers
    def _source_bytes(self, t: torch.Tensor) -> float:
        """The fewest bytes along the operand's chain back to its stored
        tensor: up to 12 ops back (the reference's 6 jaxpr equations;
        einsum here adds the permutes, copies and views around a bmm)."""
        best = _nbytes(t)
        for _ in range(12):
            prev = self._producer.get(t)
            if prev is None:
                break
            t = prev
            best = min(best, _nbytes(t))
        return best

    def _host_read(self, func, args, kwargs):
        try:
            return func(*args, **kwargs)
        except Exception:  # noqa: BLE001 - no value behind a fake tensor
            pass
        t = args[0]
        site = _call_site()
        if t.dtype == torch.bool:
            if site not in self._sites:
                self._sites.add(site)
                self.cost.guessed_whiles += 1
            run = self._reads.get(site, 0)
            if run < self.while_trips:
                self._reads[site] = run + 1
                return True
            self._reads[site] = 0
            return False
        return 1.0 if t.dtype.is_floating_point else 1

    def _count(self, name: str, args, kwargs, out) -> None:
        if self.scale == 1:
            return self._count_once(name, args, kwargs, out)
        before = (self.cost.flops, self.cost.bytes, self.matmul_flops,
                  dict(self.collective_bytes), dict(self.collective_counts))
        self._count_once(name, args, kwargs, out)
        k = self.scale - 1
        self.cost.flops += k * (self.cost.flops - before[0])
        self.cost.bytes += k * (self.cost.bytes - before[1])
        self.matmul_flops += k * (self.matmul_flops - before[2])
        for now, then in ((self.collective_bytes, before[3]),
                          (self.collective_counts, before[4])):
            for key in now:
                now[key] += k * (now[key] - then.get(key, 0))

    def _count_once(self, name: str, args, kwargs, out) -> None:
        c = self.cost
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        base = name.rstrip("_") if name not in COLLECTIVES else name
        if name in COLLECTIVES:
            key = COLLECTIVES[name]
            # the in-place c10d ops write their first argument
            moved = sum(_nbytes(t) for t in (outs if name[-1] != "_"
                                             else _tensors(args[0])))
            self.collective_bytes[key] = (self.collective_bytes.get(key, 0.0)
                                          + moved)
            self.collective_counts[key] = self.collective_counts.get(key,
                                                                     0) + 1
        elif base in MATMUL:
            a, b = (ins[-2], ins[-1]) if base in (
                "addmm", "baddbmm", "addbmm", "addmv", "_addmm_activation"
            ) else (ins[0], ins[1])
            flops = 2.0 * _nelems(outs[0]) * a.shape[-1]
            c.flops += flops
            self.matmul_flops += flops
            c.bytes += (self._source_bytes(a) + self._source_bytes(b)
                        + sum(_nbytes(o) for o in outs))
        elif base in GATHER:
            c.bytes += sum(_nbytes(o) for o in outs)
        elif base in UPDATE:
            c.bytes += sum(_nbytes(t) for t in ins[1:])
        elif base in LINALG:
            a = ins[0]
            n = float(a.shape[-1])
            batch = _nelems(a) / max(n * n, 1.0)
            c.flops += batch * LINALG[base] * n ** 3
            c.bytes += sum(_nbytes(t) for t in ins) + sum(_nbytes(o)
                                                          for o in outs)
        elif base in SORT:
            n = max((_nelems(t) for t in ins), default=0.0)
            c.flops += n * max(math.log2(max(n, 2.0)), 1.0)
        elif base in REDUCE:
            c.flops += max((_nelems(t) for t in ins), default=0.0)
        elif base not in ZERO:
            c.flops += sum(_nelems(o) for o in outs)   # elementwise

    # ---------------------------------------------------------- dispatch
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            # DTensor runs the op on the local blocks: those come back here
            return NotImplemented
        if func in (aten._local_scalar_dense.default, aten.item.default):
            return self._host_read(func, args, kwargs)
        out = func(*args, **kwargs)
        if _planning():
            return out
        name = func.overloadpacket.__name__
        self._count(name, args, kwargs, out)
        src = args[0] if args else None
        if (name.rstrip("_") in SOURCE_CHAIN and isinstance(out, torch.Tensor)
                and isinstance(src, torch.Tensor)
                and src.numel() == out.numel()):
            self._producer[out] = src
        return out


class _ScaleGrad(torch.autograd.Function):
    """The identity on a counted trip's operands (``at_outputs`` False) or
    results (True), whose backward scales the meter: at the results by
    the trip's count ``k`` (its backward runs next), at the operands back
    again, after counting the sum of the weights' gradients over the ``k``
    trips (``k - 1`` adds; ``ts[0]`` is the trip's input).  The autograd
    engine runs the trip's backward between the two: its nodes are the
    ones made between the markers, and it takes the latest made first."""

    @staticmethod
    def forward(ctx, meter, k, at_outputs, *ts):
        ctx.meter, ctx.k, ctx.at_outputs = meter, k, at_outputs
        ctx.set_materialize_grads(False)    # an unused weight gets none
        return tuple(t.view_as(t) for t in ts)

    @staticmethod
    def backward(ctx, *gs):
        if ctx.at_outputs:
            ctx.meter.scale *= ctx.k
        else:
            ctx.meter.scale //= ctx.k
            with ctx.meter.scaled(ctx.k - 1):
                [g + g for g in gs[1:] if g is not None]
        return (None, None, None, *gs)


class _Repeat(torch.autograd.Function):
    """One output of the loop stacked over its ``k + 1`` trips: trip 0's
    ``a`` for the first ``k`` and the last trip's ``b``; in backward the
    gradient of one trip of each."""

    @staticmethod
    def forward(ctx, k, a, b):
        ctx.set_materialize_grads(False)
        return torch.stack([a] * k + [b])

    @staticmethod
    def backward(ctx, g):
        return (None, None, None) if g is None else (None, g[0], g[-1])


def loop_trips(meter, body, w: Dict[str, Any], xs: torch.Tensor):
    """``models.layers.scan_trips(body, w, xs)`` counted by ``meter`` as a
    scan: every trip is the same program on operands of the same shapes,
    so the loop runs as two trips, trip 0 counted for the first
    ``len(xs) - 1`` (forward, and under autograd its checkpoint's
    recompute and backward, and the sum of the weights' gradients) and
    the last one once.  Two trips keep the loop's own structure where a
    checkpoint around it stops its recompute early (before the last
    trip, when nothing after the loop saves a tensor).  The values of
    the first trips are trip 0's: the meter runs on fake tensors, which
    hold none.  One trip runs as the loop."""
    from torch.utils.checkpoint import checkpoint
    from repro_torch.models import layers
    n = xs.shape[0]
    if n == 1:
        with layers.scan_override(None):
            return layers.scan_trips(body, w, xs)
    remat = torch.is_grad_enabled()
    wl, tree = tree_flatten(w)

    def trip(x, wl):
        wt = tree_unflatten(wl, tree)
        return (checkpoint(body, wt, x, use_reentrant=False) if remat
                else body(wt, x))

    first, last = xs.unbind(0)[::n - 1]
    with meter.scaled(n - 1):
        x0, *w0 = _ScaleGrad.apply(meter, n - 1, False, first, *wl)
        head = _ScaleGrad.apply(meter, n - 1, True, *trip(x0, w0))
    tail = trip(last, wl)
    return tuple(_Repeat.apply(n - 1, a, b) for a, b in zip(head, tail))


def argument_bytes(*args) -> float:
    """Bytes of every tensor among ``args`` (a DTensor's local block)."""
    from torch.distributed.tensor import DTensor
    return sum(_nbytes(t.to_local() if isinstance(t, DTensor) else t)
               for t in _tensors(args))


def _fake(x, mode):
    """A meta tensor as a fake CPU tensor of its shape and dtype; every
    other leaf as it is."""
    if isinstance(x, torch.Tensor) and x.device.type == "meta":
        with mode:
            return torch.empty(x.shape, dtype=x.dtype, device="cpu")
    return x


def run_counted(fn, *args, while_trips: float = 1.0, **kw):
    """``(fn(*args, **kw), CostMode)``: ``fn`` run on fake tensors under
    :class:`CostMode`, ``fn``'s arguments charged once.  Meta tensors
    among ``args`` become fake CPU tensors; fake tensors (and fake
    DTensors) built by the caller under its own ``FakeTensorMode`` are
    used as they are, in that mode."""
    from torch._guards import detect_fake_mode
    from torch._subclasses.fake_tensor import FakeTensorMode
    mode = detect_fake_mode(_tensors(args)) or FakeTensorMode(
        allow_non_fake_inputs=True)
    args = tree_map(lambda x: _fake(x, mode), args)
    cm = CostMode(while_trips)
    cm.cost.bytes += argument_bytes(*args)
    with mode, cm, _strided_offsets_on_host():
        out = fn(*args, **kw)
    return out, cm


def cost_of(fn, *args, while_trips: float = 1.0, **kw) -> Cost:
    """Trip-exact cost of ``fn(*args)`` (args may be meta tensors)."""
    return run_counted(fn, *args, while_trips=while_trips, **kw)[1].cost
