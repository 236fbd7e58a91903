"""Error-feedback int8 gradient compression for the outer data-parallel
axis (the JAX package's ``distributed/compression.py``):

    q = round((g + err) / scale) in int8        scale = max|g + err| / 127
    g_hat = psum(q) * scale_shared / n          (4x fewer bytes on the wire)
    err'  = (g + err) - q * scale               (residual carried forward)

``ef_psum`` is the all-reduce-mean over one axis of a ``DeviceMesh``:
each rank quantizes its own gradient against one scale shared through a
max all-reduce, and the int8 payloads are summed as int32 (the wire format
is int8; the widening models the accumulator), in the reference's order
of operations.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.models.layers import tree_from_items, tree_items, tree_map


def _over_127(x: torch.Tensor) -> torch.Tensor:
    """x / 127 as an IEEE division on every device: on CUDA a Python
    scalar divisor becomes a multiply by its reciprocal, which can differ
    in the last bit (and then flip a rounded payload)."""
    return x / torch.tensor(127.0, dtype=torch.float32, device=x.device)


def quantize_int8(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (int8 values, f32 0-d scale): max|g| / 127, floored at 1e-30;
    values rounded half to even and clipped to +-127."""
    scale = torch.clamp(_over_127(torch.amax(torch.abs(g))), min=1e-30)
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def ef_compress(g: torch.Tensor, err: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (int8 payload, f32 scale, new error residual)."""
    corrected = g.float() + err
    q, scale = quantize_int8(corrected)
    return q, scale, corrected - dequantize_int8(q, scale)


def ef_psum(g: torch.Tensor, err: torch.Tensor, axis_name: str, mesh
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Compressed all-reduce-mean of ``g`` over the ``axis_name`` dim of
    ``mesh`` (every rank of that dim calls it with its own ``g`` and
    residual ``err``).  Returns (g_hat averaged over the axis, the same on
    every rank of it; this rank's new residual)."""
    import torch.distributed as dist
    group = mesh.get_group(axis_name)
    corrected = g.float() + err
    global_max = torch.amax(torch.abs(corrected))
    dist.all_reduce(global_max, op=dist.ReduceOp.MAX, group=group)
    scale = torch.clamp(_over_127(global_max), min=1e-30)
    q = torch.clamp(torch.round(corrected / scale), -127, 127).to(torch.int8)
    new_err = corrected - q.float() * scale
    total = q.to(torch.int32)                      # int8 wire format
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    n = torch.tensor(float(dist.get_world_size(group)), dtype=torch.float32,
                     device=total.device)
    return total.float() * scale / n, new_err


def ef_psum_tree(grads: Any, errs: Any, axis_name: str, mesh
                 ) -> Tuple[Any, Any]:
    """:func:`ef_psum` over every leaf of a gradient tree (nested dicts),
    each leaf with its own scale.  Returns (g_hat tree, residual tree)."""
    outs = [(path, ef_psum(g, e, axis_name, mesh))
            for (path, g), (_, e) in zip(tree_items(grads),
                                         tree_items(errs))]
    return (tree_from_items((p, o[0]) for p, o in outs),
            tree_from_items((p, o[1]) for p, o in outs))


def init_error_state(params):
    """f32 zeros congruent with ``params`` (a nested dict of tensors)."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
