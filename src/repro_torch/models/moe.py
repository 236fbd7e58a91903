"""Mixture-of-Experts MLP with capacity-chunked token-choice routing (the
JAX package's ``models/moe.py``).

Tokens are cut into chunks of ``chunk`` (the last one zero-padded), so the
dispatch one-hot never exceeds (chunk, E, capacity).  Each chunk routes
its tokens to their top-k experts; an expert takes at most ``capacity =
max(int(chunk * top_k / E * capacity_factor), 4)`` of them, in the order
of the flattened (token, k) assignments, and drops the rest (the
residual path keeps a dropped token alive).

The router runs in f32.  Each expert product takes its operands in the
compute dtype and accumulates in f32; the gate product stays in f32
through the activation and is rounded once after it, the up and down
products are rounded to the dtype, and the gated product is formed in
the dtype, as the reference's ``preferred_element_type`` einsums do.

Two dispatch implementations, the reference's:
  * ``einsum``: one-hot dispatch and combine as real matrix products;
  * ``gather``: each kept assignment's row is copied into its slot of an
    (E * capacity) buffer and read back from it; dropped assignments go
    to a dump slot past the end.  A real slot receives at most one row,
    so the buffer is built by copies, never by a sum (deterministic on
    the card, no float atomics), and equals the reference's scatter-add.

Top-k breaks ties towards the lower expert index, as ``lax.top_k`` does
(a zero-padded token has all its logits equal).

Sharded with the experts split over 'model', each rank runs its own
experts on local shards (:func:`moe_mlp`) and one collective sums their
parts of the output.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.launch.mesh import is_dtensor
from repro_torch.models import layers
from repro_torch.models.layers import ParamSpec, Template

Tensor = torch.Tensor


def moe_template(d: int, ff: int, n_experts: int, dtype: torch.dtype,
                 fsdp: bool = False, n_shared: int = 0,
                 shared_ff: int = 0) -> Template:
    dax = "data" if fsdp else None
    t: Template = {
        "router": ParamSpec((d, n_experts), torch.float32, (dax, None),
                            "fan_in"),
        "wi": ParamSpec((n_experts, d, ff), dtype, ("model", dax, None),
                        "fan_in"),
        "wg": ParamSpec((n_experts, d, ff), dtype, ("model", dax, None),
                        "fan_in"),
        "wo": ParamSpec((n_experts, ff, d), dtype, ("model", None, dax),
                        "fan_in"),
    }
    if n_shared > 0:
        t["shared"] = layers.glu_mlp_template(d, shared_ff, dtype)
    return t


def _route(logits: Tensor, top_k: int) -> Tuple[Tensor, Tensor]:
    """(T, E) f32 -> (weights (T, k), indices (T, k)); softmax over top-k.
    Descending, the lower index first among equal logits."""
    gate, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    gate, idx = gate[:, :top_k], idx[:, :top_k]
    return torch.softmax(gate, dim=-1), idx


def _expert_product(x: Tensor, w: Tensor, f32_out: bool) -> Tensor:
    """(E, C, a) @ (E, a, b) in x's dtype with f32 accumulation: rounded
    to the dtype, or (``f32_out``) kept in f32."""
    if x.dtype == torch.float32 or not f32_out:
        return torch.bmm(x, w)
    if x.is_cuda:
        return torch.bmm(x, w, out_dtype=torch.float32)
    return torch.bmm(x.float(), w.float())   # bf16 products are exact in f32


def route_chunk(logits: Tensor, top_k: int, capacity: int, n_experts: int
                ) -> Dict[str, Tensor]:
    """Routing of one chunk from its (C_t, E) f32 router logits: the gates
    and expert ids (C_t, k), each flattened (token, k) assignment's
    position in its expert (-1 where it was not routed there), whether it
    is kept, and its slot id (expert * capacity + position; a dropped
    assignment takes the dump slot E * capacity)."""
    ct = logits.shape[0]
    gate, idx = _route(logits, top_k)
    onehot = F.one_hot(idx, n_experts)                          # (C_t, k, E)
    flat = onehot.reshape(ct * top_k, n_experts)
    pos = torch.cumsum(flat, dim=0) * flat - 1                  # (C_t k, E)
    keep = (pos < capacity) & (flat > 0)
    slot = torch.sum(torch.where(
        keep, idx.reshape(ct * top_k, 1) * capacity + pos,
        torch.zeros_like(pos)), dim=1)
    dropped = ~torch.any(keep, dim=1)
    slot = torch.where(dropped, torch.full_like(slot, n_experts * capacity),
                       slot)
    return {"gate": gate, "idx": idx, "onehot": onehot, "pos": pos,
            "keep": keep, "slot": slot, "dropped": dropped}


def _chunk_moe(p: Dict[str, Tensor], xc: Tensor, *, top_k: int,
               capacity: int, n_experts: int, act: str, dtype: torch.dtype,
               impl: str = "einsum", experts: Tuple[int, int] = None
               ) -> Tuple[Tensor, Tensor]:
    """One token chunk.  xc (C_t, d) -> (C_t, d), and its aux loss.  With
    ``experts`` = (first, count), p holds only those experts' weights (a
    rank's local block): only their slots are built and combined, and y
    is their part of the sum over the experts, in f32 (the caller sums
    the parts over the ranks and rounds once)."""
    ct, d = xc.shape
    logits = xc.float() @ p["router"].float()                   # (C_t, E)
    r = route_chunk(logits, top_k, capacity, n_experts)
    keep, slot, dropped = r["keep"], r["slot"], r["dropped"]
    n = ct * top_k
    gate_flat = r["gate"].reshape(n)
    x_rep = torch.repeat_interleave(xc.to(dtype), top_k, dim=0)  # (C_t k, d)
    e0, ne = (0, n_experts) if experts is None else experts
    if experts is not None:
        # the slots of the local experts; every other assignment goes to
        # the local dump slot
        slot = slot - e0 * capacity
        dropped = dropped | (slot < 0) | (slot >= ne * capacity)
        slot = torch.where(dropped, torch.full_like(slot, ne * capacity),
                           slot)

    if impl == "gather":
        # row of each slot: the one assignment kept there, else the zero
        # row n; only the dump slot (dropped) is written more than once
        src = torch.full((ne * capacity + 1,), n, dtype=torch.long,
                         device=xc.device)
        src = src.scatter(0, slot, torch.arange(n, device=xc.device))
        x_pad = torch.cat([x_rep, x_rep.new_zeros((1, d))])
        buf = x_pad[src[:-1]].reshape(ne, capacity, d)
    elif impl == "einsum":
        disp = F.one_hot(torch.where(keep, r["pos"], capacity),
                         capacity + 1)[..., :capacity].to(dtype)  # (C_t k, E, cap)
        disp = disp[:, e0:e0 + ne]
        buf = torch.einsum("tec,td->ecd", disp, x_rep)
    else:
        raise ValueError(f"unknown moe impl {impl!r} (einsum | gather)")

    h = layers.act_fn(act, _expert_product(buf, p["wg"].to(dtype), True))
    h = h.to(dtype) * _expert_product(buf, p["wi"].to(dtype), False)
    out_e = _expert_product(h, p["wo"].to(dtype), False)        # (E, cap, d)

    if impl == "gather":
        flat_out = torch.cat([out_e.reshape(ne * capacity, d),
                              out_e.new_zeros((1, d))])         # dump row
        y = flat_out[slot] * gate_flat[:, None].to(dtype)
        y = torch.where(dropped[:, None], torch.zeros_like(y), y)
    else:
        # the products in f32 (exact: both factors are in the dtype), the
        # sum over k in f32, one rounding
        comb = disp * gate_flat[:, None, None].to(dtype)
        y = torch.einsum("tec,ecd->td", comb.float(), out_e.float())
    if experts is None:
        y = y.reshape(ct, top_k, d).sum(dim=1).to(dtype)
    else:
        y = y.float().reshape(ct, top_k, d).sum(dim=1)

    # load-balance aux (Switch-style): mean gate prob x assignment fraction
    probs = torch.softmax(logits, dim=-1)
    frac_tokens = torch.mean(r["onehot"].sum(1).float(), dim=0)   # (E,)
    frac_probs = torch.mean(probs, dim=0)
    aux = n_experts * torch.sum(frac_tokens / top_k * frac_probs)
    return y, aux


def capacity_for(chunk: int, top_k: int, n_experts: int,
                 capacity_factor: float) -> int:
    return max(int(chunk * top_k / n_experts * capacity_factor), 4)


def moe_mlp(p: Dict[str, Tensor], x: Tensor, *, top_k: int, n_experts: int,
            act: str, dtype: torch.dtype, capacity_factor: float = 2.0,
            chunk: int = 4096, impl: str = "einsum",
            norm: Optional[Tuple[str, Dict[str, Tensor]]] = None
            ) -> Tuple[Tensor, Tensor]:
    """x (B, T, d) -> (out (B, T, d), aux loss).  The B*T tokens run in
    chunks of min(chunk, B*T), the last one zero-padded; the aux loss is
    the mean over chunks.  Under autograd each chunk is recomputed in
    backward (the reference's chunk remat).

    Sharded (x a DTensor), the layer runs expert-parallel on local shards
    (a ``layers.Region``): each rank takes its rows of x with d whole, the
    router whole and its n_experts / model experts (FSDP splits gathered
    once a layer, outside the chunk loop), routes every chunk as one
    device does, builds and runs only its experts' slots and combines
    their part of each token's output in f32; one all-reduce (or
    reduce-scatter onto d) over 'model' sums the parts (with a shared
    expert's, run on its ff column block), rounded to the dtype once.
    With ``norm`` = (kind, params) the region is the whole layer: x is
    normed on whole rows inside it and the result is x + moe(norm(x)),
    the residual added on the local block.  The chunks are the unsharded run's: a rank whose rows
    are whole chunks routes them alone, else every rank routes the whole
    batch (gathered) and keeps its rows.  The aux loss is each rank's
    share of the mean over the chunks."""
    b, t, d = x.shape
    chunk = min(chunk, b * t)
    n_chunks = -(-(b * t) // chunk)
    experts, share, reg = None, 1, None
    if is_dtensor(x):
        reg = _expert_region(p, x, n_experts)
        ne = n_experts // reg.model_size
        experts = (reg.model_rank * ne, ne)
        w = {name: reg.weight(p[name])
             for name in ("router", "wi", "wg", "wo")}
        xl = reg.act(x, norm)                           # (B_loc, T, d)
        xn = xl
        n_loc = xl.shape[0] * t
        n_rows = 1
        for i in reg.batch:
            n_rows *= reg.mesh.size(i)
        alone = b % n_rows == 0 and n_loc % chunk == 0
        share = reg.model_size        # ranks that compute the same aux term
        if not alone:
            xl = reg.gather_rows(xl)
            share *= n_rows
        xt = xl.reshape(-1, d)
    else:
        w, xt = p, x.reshape(b * t, d)
    pad = -xt.shape[0] % chunk
    if pad:
        xt = F.pad(xt, (0, 0, 0, pad))
    body = functools.partial(
        _chunk_moe, top_k=top_k, capacity=capacity_for(
            chunk, top_k, n_experts, capacity_factor),
        n_experts=n_experts, act=act, dtype=dtype, impl=impl,
        experts=experts)
    trips = xt.shape[0] // chunk
    y, auxs = layers.scan_trips(body, w, xt.reshape(trips, chunk, d))
    y = y.reshape(trips * chunk, d)
    aux = torch.mean(auxs) * (trips / (n_chunks * share))
    if reg is None:
        out = y[:b * t].reshape(b, t, d)
        if "shared" in p:
            out = out + layers.glu_mlp(p["shared"], x, act, dtype)
        return out, aux
    r0 = reg.row_block()[0] if not alone else 0
    y = y[r0 * t:r0 * t + n_loc].reshape(-1, t, d)
    if "shared" in p:
        if not layers.glu_split(reg, p["shared"]):
            raise ValueError("a sharded MoE layer's shared expert needs its "
                             "ff split evenly over the mesh's 'model' dim")
        y = y + layers.glu_mlp(reg.weights(p["shared"]), xn, act,
                               dtype).float()
    layers.trace_region("moe", experts=ne)
    out = reg.out(y, residual=norm is not None, dtype=dtype)
    (aux,) = reg.sums(aux, over_model=True)
    return out, aux


def _expert_region(p: Dict[str, Tensor], x, n_experts: int):
    """The region of a sharded MoE layer: x's batch not over 'model', the
    experts split evenly over 'model'; anything else raises."""
    reg = layers.Region(x)
    if (reg.model is None or layers.model_split(x, 0)
            or not all(layers.model_split(p[n], 0)
                       for n in ("wi", "wg", "wo"))
            or n_experts % reg.model_size):
        raise ValueError(
            f"a sharded MoE layer needs its {n_experts} experts split "
            f"evenly over the mesh's 'model' dim and its batch not split "
            f"there (mesh {reg.mesh}, x {x.placements})")
    return reg
