"""The port's inference entry points under a mesh, on CPU process groups:
``prefill``, ``encode`` and ``decode_step`` on a (2, 2) ``("data",
"model")`` mesh of four gloo ranks (smoke configs in f32; qwen3-moe also
on (1, 4), where each pair of 'model' ranks shares a kv head), with the
parameters split by their templates' placements, the batch over 'data'
and the decode cache placed as the dry run places it
(``launch.shapes.cache_structs``: kv leaves over the batch and the
sequence, ``seq_axes`` 'model', recurrent states over the batch).
Prefill and encode run every block of a layer as a region on local
shards (attention on each rank's H / model heads, the dense MLP on its ff
block, the MoE on its experts, mamba on its channels, the norms on whole
rows); decode runs flash-decoding: each rank attends to its own block of
the ring with B10's partials and one merge over the sequence's ranks
combines them, with no cache leaf gathered.  Three more decodes hold the
split's edges: a short prompt in a long ring (a rank whose block holds no
visible key) with a bf16 and an int8 cache, and gemma3-4b's window of 8
over a ring of 12 decoded past its end (the visible run wraps the ring,
and meets one block at both its ends).

gemma3-4b's 4 heads over the 8 'model' ranks of a (1, 8) mesh (its 8
heads over 16: 4 head groups of 2 ranks, each rank a head and half of its
rows) prefill head-parallel by head group, lay out the cache with the
heads whole, and decode with it split over the sequence; a batch-1
prefill there, whose one row a group cannot split, takes the rows path
and says so.  These run in a spawn of 8 ranks of their own.

Each run is held against the port's unsharded run on the same weights and
tokens, and its prefill against the JAX package's unsharded ``prefill``.
Tolerance: f32, a sharded matmul sums its contraction in another order,
a few ulps per op over a dozen ops: 1e-5 of the largest |logit| (measured
<= 1.1e-6 relative against either), and the head-parallel prefill's
logits within that measured 1.1e-6 of the unsharded ones; greedy tokens
must be equal, and the prefill's caches are held within the same bound
of their largest |value|.

The JAX package is imported inside the tests only: the rank processes
import this module and need torch alone.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
dist = pytest.importorskip("torch.distributed")

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.launch.local import run_local  # noqa: E402
from repro_torch.models import layers as t_layers  # noqa: E402
from repro_torch.models import model as t_model  # noqa: E402

# (arch, kv cache dtype): dense attention with a bf16-dtype and an int8
# cache, window attention, the mamba/attention/MoE hybrid, and the encoder
RUNS = (("stablelm-1.6b", "bf16"), ("stablelm-1.6b", "int8"),
        ("gemma3-4b", "bf16"), ("jamba-v0.1-52b", "bf16"),
        ("hubert-xlarge", "bf16"), ("qwen3-moe-235b-a22b", "bf16", (1, 4)))
B, T, NEW = 4, 8, 3
# (arch, kv cache dtype, prompt, ring, new tokens): the split's edges
EDGES = (("stablelm-1.6b", "bf16", 3, 16, 3), ("stablelm-1.6b", "int8", 3, 16, 3),
         ("gemma3-4b", "bf16", 8, 12, 6))
TOL = 1e-5
PREFILL_TOL = 1.1e-6     # relative: the head-parallel prefill (PERF.md)
# gemma3-4b (bf16 cache) on (1, 8): 4 head groups of 2 ranks; a ring of 16
# (2 slots a rank); and the batch-1 prefill that takes the rows path
UNEVEN = ("gemma3-4b", "bf16", (1, 8))
UNEVEN_RING = 16


def _id(run) -> str:
    return "-".join(str(v).replace(" ", "") for v in run)


def _mesh_shape(run):
    return run[2] if len(run) > 2 else (2, 2)


def _cfg(arch: str, kv: str):
    return dataclasses.replace(get_arch(arch).smoke, dtype=torch.float32,
                               kv_cache_dtype=kv)


def _inputs(cfg, seed: int = 1, t: int = T) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if cfg.input_kind == "embed":
        return rng.standard_normal((B, t, cfg.d_frontend)).astype(np.float32)
    return rng.integers(0, cfg.vocab, (B, t), dtype=np.int32)


def _params(cfg):
    return t_model.init_params(cfg, torch.Generator().manual_seed(0))


def _flat(tree) -> dict:
    """Copies of the leaves (decode updates the state leaves in place)."""
    return {"/".join(k): v.float().numpy().copy()
            for k, v in t_layers.tree_items(tree)}


def _serve(cfg, params, x, place=None, ring=None, new=NEW):
    """prefill (or encode) and ``new`` greedy decode steps over a ring of
    ``ring`` (the prompt and the new tokens by default) -> (prefill
    logits, prefill cache, decode logits, tokens, the regions prefill ran,
    the regions decode ran).  ``place(name, tensor)`` puts a tensor on the
    mesh (None: one device)."""
    from repro_torch.serve.kv_cache import pad_cache
    put = place or (lambda name, t: t)
    full = (lambda t: t.full_tensor()) if place else (lambda t: t)
    xs = put("batch", torch.from_numpy(x))
    planned, inner = [], t_model._layer

    def layer(*args, **kw):          # a layer's ops, DTensor's plans noted
        with t_layers.dtensor_ops(planned):
            return inner(*args, **kw)

    t_layers.REGION_TRACE = []
    t_model._layer = layer
    try:
        if not cfg.is_decoder:
            lg = full(t_model.encode(cfg, params, xs)).numpy()
        else:
            lg, cache = t_model.prefill(cfg, params, xs)
        regions = {(n, tuple(sorted(i.items())))
                   for n, i in t_layers.REGION_TRACE}
    finally:
        t_layers.REGION_TRACE = None
        t_model._layer = inner
    regions.add(("dtensor_planned", tuple(sorted(set(planned)))))
    if not cfg.is_decoder:
        return lg, {}, [], [], regions, set()
    t = x.shape[1]
    lg = full(lg)
    cache = t_layers.tree_map(full, cache)
    pre_cache = _flat(cache)
    # the decode cache: the prompt's cache padded to the ring, placed
    cache = put("cache", pad_cache(cfg, cache, ring or t + new))
    logits, toks = [], []
    tok = torch.argmax(lg, -1).to(torch.int32)[:, None]
    t_layers.REGION_TRACE = []
    try:
        for i in range(new):
            toks.append(tok.numpy())
            out, cache = t_model.decode_step(cfg, params, put("batch", tok),
                                             cache, t + i)
            out = full(out)
            logits.append(out.numpy())
            tok = torch.argmax(out, -1).to(torch.int32)[:, None]
        dec_regions = {(n, tuple(sorted(i.items())))
                       for n, i in t_layers.REGION_TRACE}
    finally:
        t_layers.REGION_TRACE = None
    return lg.numpy(), pre_cache, logits, toks, regions, dec_regions


def _placed(arch: str, kv: str, p_np, mesh, ring: int):
    """(config, parameters split by their templates' placements, place):
    ``place`` puts the batch over 'data' and a decode cache of ``ring``
    slots as ``launch.shapes.cache_structs`` lays it out."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.configs.common import ShapeSpec
    from repro_torch.launch.shapes import cache_structs
    cfg = dataclasses.replace(_cfg(arch, kv), batch_axes=("data",),
                              seq_axes=("model",))
    params = t_layers.tree_map(
        lambda a, pl: distribute_tensor(torch.from_numpy(a), mesh, pl,
                                        src_data_rank=None), p_np,
        t_layers.sharding_tree(t_model.build_template(cfg), mesh))
    structs = cache_structs(cfg, ShapeSpec("decode", "decode", ring, B),
                            mesh)

    def place(name, t):
        if name == "batch":
            pl = t_layers.placements((cfg.batch_axes,), mesh)
            return distribute_tensor(t, mesh, pl, src_data_rank=None)
        return t_layers.tree_map(
            lambda a, st: distribute_tensor(a.contiguous(), mesh,
                                            st.placements,
                                            src_data_rank=None),
            t, structs)
    return cfg, params, place


def _on_mesh(runs, params_np, xs, edges=(), edge_params=(), edge_xs=()):
    """On each rank: every run of ``runs`` on its mesh, then each of
    ``edges`` on the (2, 2) mesh."""
    from repro_torch.launch import mesh as mesh_mod
    meshes = {shape: mesh_mod.make_mesh(shape, ("data", "model"), "cpu")
              for shape in sorted({_mesh_shape(r) for r in runs})}
    out = []
    meshes.setdefault((2, 2), mesh_mod.make_mesh((2, 2), ("data", "model"),
                                                 "cpu"))
    jobs = [(run[:2], _mesh_shape(run), T + NEW, NEW) for run in runs] + [
        (e[:2], (2, 2), e[3], e[4]) for e in edges]
    for (arch, kv), shape, ring, new, p_np, x in zip(
            *zip(*jobs), list(params_np) + list(edge_params),
            list(xs) + list(edge_xs)):
        cfg, params, place = _placed(arch, kv, p_np, meshes[shape], ring)
        out.append(_serve(cfg, params, x, place, ring, new))
    out.append(_embed_uneven(meshes[(2, 2)]))
    out.append(_moe_uneven(meshes[(2, 2)]))
    out.append(_decode_whole_rows(meshes[(2, 2)]))
    return out


EMBED_V, EMBED_D = 503, 64


def _embed_uneven(mesh):
    """The vocab-parallel embedding with 503 rows split over the 2 'model'
    ranks (252 and 251): the rows looked up and the table's gradient of a
    seeded linear function of them, whole on every rank."""
    from torch.distributed.tensor import distribute_tensor
    gen = torch.Generator().manual_seed(3)
    table = torch.randn(EMBED_V, EMBED_D, generator=gen)
    tok = torch.randint(0, EMBED_V, (B, T), generator=gen)
    coef = torch.randn(B, T, EMBED_D, generator=gen)
    tp = distribute_tensor(table, mesh, t_layers.placements(
        ("model", None), mesh), src_data_rank=None).requires_grad_(True)
    tk = distribute_tensor(tok, mesh, t_layers.placements(("data",), mesh),
                           src_data_rank=None)
    cf = distribute_tensor(coef, mesh, t_layers.placements(("data",), mesh),
                           src_data_rank=None)
    t_layers.REGION_TRACE = []
    try:
        with t_layers.mesh_context(tk):
            rows = t_layers.embed_lookup(tp, tk, torch.float32)
            (grad,) = torch.autograd.grad((rows * cf).sum(), tp)
        regions = list(t_layers.REGION_TRACE)
    finally:
        t_layers.REGION_TRACE = None
    return {"rows": rows.detach().full_tensor().numpy(),
            "grad": grad.full_tensor().numpy(), "regions": regions,
            "local_rows": tp.to_local().shape[0]}


def _moe_uneven(mesh) -> str:
    """A sharded MoE layer with 3 experts over the 2 'model' ranks: the
    error it raises (each rank runs whole experts, so 'model' must divide
    them)."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.models import moe as t_moe
    gen = torch.Generator().manual_seed(4)
    d, ff, e = 8, 16, 3
    p = {"router": torch.randn(d, e, generator=gen),
         **{n: torch.randn(e, *s, generator=gen)
            for n, s in (("wi", (d, ff)), ("wg", (d, ff)), ("wo", (ff, d)))}}
    p = {n: distribute_tensor(v, mesh, t_layers.placements(
        (None,) if n == "router" else ("model",), mesh), src_data_rank=None)
         for n, v in p.items()}
    x = distribute_tensor(torch.randn(B, T, d, generator=gen), mesh,
                          t_layers.placements(("data",), mesh),
                          src_data_rank=None)
    try:
        t_moe.moe_mlp(p, x, top_k=2, n_experts=e, act="silu",
                      dtype=torch.float32)
    except ValueError as exc:
        return str(exc)
    return ""


def _decode_whole_rows(mesh) -> str:
    """A sharded decode step of one attention layer whose cache holds
    every row on every rank (not split as the rows of h are): the error
    it raises (a sharded decode runs by flash-decoding only)."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.models import attention as t_attn
    gen = torch.Generator().manual_seed(5)
    d, nh, hd, s = 16, 2, 8, 6
    p = {n: distribute_tensor(torch.randn(*sh, generator=gen), mesh,
                              t_layers.placements(pl, mesh),
                              src_data_rank=None)
         for n, sh, pl in (("wq", (d, nh * hd), (None, "model")),
                           ("wk", (d, nh * hd), (None, "model")),
                           ("wv", (d, nh * hd), (None, "model")),
                           ("wo", (nh * hd, d), ("model",)))}
    h = distribute_tensor(torch.randn(B, 1, d, generator=gen), mesh,
                          t_layers.placements(("data",), mesh),
                          src_data_rank=None)
    cache = {n: distribute_tensor(torch.randn(B, s, nh, hd, generator=gen),
                                  mesh, t_layers.placements((), mesh),
                                  src_data_rank=None) for n in ("k", "v")}
    norm = ("rmsnorm", {"w": distribute_tensor(
        torch.ones(d), mesh, t_layers.placements((), mesh),
        src_data_rank=None)})
    try:
        t_attn.attention_layer(
            p, h, torch.full((B, 1), s - 1), norm, cache=cache,
            cache_pos=s - 1, n_heads=nh, n_kv=nh, head_dim=hd,
            mask_kind="causal", window=0, rope_theta=1e4, rotary_frac=1.0,
            dtype=torch.float32, impl="ref", chunk=16)
    except ValueError as exc:
        return str(exc)
    return "ran"


@pytest.fixture(scope="module")
def runs():
    cfgs = [_cfg(*r[:2]) for r in RUNS]
    params = [_params(c) for c in cfgs]
    xs = [_inputs(c) for c in cfgs]
    params_np = [t_layers.tree_map(lambda v: v.numpy(), p) for p in params]
    e_cfgs = [_cfg(*e[:2]) for e in EDGES]
    e_params = [_params(c) for c in e_cfgs]
    e_xs = [_inputs(c, t=e[2]) for c, e in zip(e_cfgs, EDGES)]
    sharded = run_local(_on_mesh, 4, RUNS, params_np, xs, EDGES,
                        [t_layers.tree_map(lambda v: v.numpy(), p)
                         for p in e_params], e_xs)
    plain = [_serve(c, p, x) for c, p, x in zip(cfgs, params, xs)]
    out = {r: (plain[i], [s[i] for s in sharded], params_np[i], xs[i])
           for i, r in enumerate(RUNS)}
    for j, e in enumerate(EDGES):
        out[e] = (_serve(e_cfgs[j], e_params[j], e_xs[j], None, e[3], e[4]),
                  [s[len(RUNS) + j] for s in sharded], None, e_xs[j])
    out["embed_uneven"] = [s[-3] for s in sharded]
    out["moe_uneven"] = [s[-2] for s in sharded]
    out["decode_whole_rows"] = [s[-1] for s in sharded]
    return out


def _close(got, want, tol=TOL):
    err = float(np.abs(got - want).max())
    assert err <= tol * max(1.0, float(np.abs(want).max())), err


@pytest.mark.parametrize("run", RUNS, ids=[_id(r) for r in RUNS])
def test_sharded_equals_unsharded(runs, run):
    plain, ranks, _, _ = runs[run]
    lg, cache, dec, toks, _, _ = plain
    for rank in ranks:                       # every rank holds the result
        _close(rank[0], lg)
        _close(rank[0], lg, PREFILL_TOL)
        for k, v in cache.items():
            _close(rank[1][k], v)
        for got, want in zip(rank[2], dec):
            _close(got, want)
        for got, want in zip(rank[3], toks):
            assert np.array_equal(got, want)


def layer_regions(cfg, m: int) -> set:
    """The regions each block of ``cfg``'s layers runs as on local shards
    at ``m`` 'model' ranks, with the local sizes each sees, and the final
    norm's."""
    out = {("norm", ())}
    for mixer, mlp in cfg.period_pattern:
        if mixer.startswith("attn"):
            out.add(("attention", (("heads", cfg.n_heads // m), (
                "kv_heads", max(cfg.n_kv_heads // m, 1)))))
        elif mixer == "mamba":
            out.add(("mamba", (("channels", cfg.d_inner // m),)))
        else:
            out.add(("rwkv", (("heads", cfg.rwkv_heads // m),)))
        if mlp == "moe":
            out.add(("moe", (("experts", cfg.n_experts // m),)))
        elif mlp == "rwkv_cm":
            out.add(("channel_mix", (("ff", cfg.d_ff // m),)))
        else:
            out.add(("dense", (("ff", cfg.d_ff // m),)))
    return out


@pytest.mark.parametrize("run", RUNS, ids=[_id(r) for r in RUNS])
def test_prefill_runs_head_parallel(runs, run):
    """The sharded prefill (encode) ran every block as a region on local
    shards (``layer_regions``): attention on each rank's H / model query
    heads (and the kv heads they read: one shared where the kv heads are
    fewer than the 'model' ranks), the dense MLP on its ff / model block,
    the MoE on its E / model experts, mamba on its channels, the norms
    inside them on whole rows and the final norm as its own; it entered
    ``run_on_rows`` only for the embedding (the smoke vocabularies do not
    split over 'model')."""
    _, ranks, _, _ = runs[run]
    cfg = _cfg(*run[:2])
    want = layer_regions(cfg, _mesh_shape(run)[1])
    if cfg.input_kind == "tokens":
        want.add(("run_on_rows", (("region", "embed"),)))
    for rank in ranks:
        got = {r for r in rank[4] if r[0] != "dtensor_planned"}
        assert got == want, (got, want)


@pytest.mark.parametrize("run", RUNS, ids=[_id(r) for r in RUNS])
def test_prefill_layers_take_no_dtensor_plan(runs, run):
    """No op of a layer of the sharded prefill (encode) has a DTensor
    operand: the norms, the blocks and the residual adds all run on local
    shards, so DTensor's sharding rules plan nothing of a layer (the same
    program on every torch version)."""
    _, ranks, _, _ = runs[run]
    for rank in ranks:
        assert ("dtensor_planned", ()) in rank[4], rank[4]


def _decode_regions(cfg, m: int, ring: int, rank: int) -> set:
    """What a decode step on the (2, 2) mesh runs on 'model' rank
    ``rank``: flash-decoding on its block of the ring (every head, the
    sequence split over the m 'model' ranks), the dense MLP and MoE as
    in prefill, a recurrent mixer on DTensor's own ops, the final norm,
    and the embedding on each rank's rows; no ``run_on_rows`` for
    attention."""
    out = {r for r in layer_regions(cfg, m)
           if r[0] not in ("attention", "mamba", "rwkv")}
    lo = -(-ring // m)
    if any(k.startswith("attn") for k, _ in cfg.period_pattern):
        out.add(("decode_attention", (("heads", cfg.n_heads), (
            "seq_block", lo if rank < m - 1 else ring - lo * (m - 1)))))
    out.add(("run_on_rows", (("region", "embed"),)))
    return out


@pytest.mark.parametrize("run", [r for r in RUNS if _cfg(*r[:2]).is_decoder],
                         ids=[_id(r) for r in RUNS
                              if _cfg(*r[:2]).is_decoder])
def test_decode_runs_flash_decoding(runs, run):
    """Decode with the cache split over the sequence ran attention as
    flash-decoding on each rank's block of the ring (``decode_attention``,
    every head) and never through ``run_on_rows``: no rank gathers a
    cache leaf."""
    _, ranks, _, _ = runs[run]
    cfg = _cfg(*run[:2])
    m = _mesh_shape(run)[1]
    for i, rank in enumerate(ranks):       # rank = data * m + model
        want = _decode_regions(cfg, m, T + NEW, i % m)
        assert rank[5] == want, (rank[5], want)
        assert ("run_on_rows", (("region", "decode_attention"),)) not in \
            rank[5]


@pytest.mark.parametrize("edge", EDGES, ids=[_id(e) for e in EDGES])
def test_split_decode_edges(runs, edge):
    """The split's edges on the (2, 2) mesh (``EDGES``): decode logits
    within ``TOL`` of the largest of the unsharded decode's and the greedy
    tokens equal, each rank's decode through flash-decoding only.  With a
    prompt of 3 in a ring of 16 the second 'model' rank's block [8, 16)
    holds no visible key at the first steps (a log-sum-exp of -inf, a
    weight of 0); gemma3-4b's window of 8 in a ring of 12 decoded to
    position 13 wraps the ring (position 12 meets block [0, 6) at both
    its ends: keys 5 and 0)."""
    from repro_torch.kernels.decode_attention.ops import block_visible_range
    arch, kv, t, ring, new = edge
    cfg = _cfg(arch, kv)
    plain, ranks, _, _ = runs[edge]
    if arch == "gemma3-4b":
        assert block_visible_range(ring, 12, cfg.window, 0, ring // 2) == \
            (5, 2)
    else:
        assert block_visible_range(ring, t, 0, ring // 2, ring // 2)[1] == 0
    for i, rank in enumerate(ranks):
        assert len(rank[2]) == new
        for got, want in zip(rank[2], plain[2]):
            assert np.isfinite(got).all()
            _close(got, want)
        for got, want in zip(rank[3], plain[3]):
            assert np.array_equal(got, want)
        assert rank[5] == _decode_regions(cfg, 2, ring, i % 2), rank[5]


@pytest.mark.parametrize("run", RUNS, ids=[_id(r) for r in RUNS])
def test_sharded_prefill_equals_reference(runs, run):
    """The sharded prefill (encode) against the JAX package's unsharded
    one on the same weights."""
    import jax.numpy as jnp
    from repro.configs import get_arch as j_get_arch
    from repro.models import model as j_model
    arch, kv = run[:2]
    _, ranks, params_np, x = runs[run]
    jc = dataclasses.replace(j_get_arch(arch).smoke, dtype=jnp.float32,
                             kv_cache_dtype=kv)
    jp = t_layers.tree_map(jnp.asarray, params_np)
    if jc.is_decoder:
        want = np.asarray(j_model.prefill(jc, jp, jnp.asarray(x))[0])
    else:
        want = np.asarray(j_model.encode(jc, jp, jnp.asarray(x)))
    _close(ranks[0][0], want)


def test_moe_experts_must_divide_model(runs):
    """A sharded MoE layer whose experts the 'model' ranks do not divide
    raises on every rank, naming the experts; it is never run some other
    way."""
    for msg in runs["moe_uneven"]:
        assert "3 experts split evenly over the mesh's 'model' dim" in msg


def test_decode_cache_must_be_split_for_flash_decoding(runs):
    """A sharded decode whose cache is not laid out for flash-decoding
    (here every row whole on every rank) raises on every rank; it is
    never run by gathering the cache."""
    for msg in runs["decode_whole_rows"]:
        assert "laid out for flash-decoding" in msg, msg


def test_embed_vocab_parallel_uneven_split(runs):
    """503 vocabulary rows over 2 'model' ranks (252 and 251, DTensor's
    own offsets): each rank looks up the tokens of its block, the sum over
    'model' equals the plain lookup exactly, and the table's gradient
    equals the plain one (each rank's block holding its rows')."""
    gen = torch.Generator().manual_seed(3)
    table = torch.randn(EMBED_V, EMBED_D, generator=gen).requires_grad_(True)
    tok = torch.randint(0, EMBED_V, (B, T), generator=gen)
    coef = torch.randn(B, T, EMBED_D, generator=gen)
    rows = t_layers.embed_lookup(table, tok, torch.float32)
    (grad,) = torch.autograd.grad((rows * coef).sum(), table)
    locals_ = sorted({r["local_rows"] for r in runs["embed_uneven"]})
    assert locals_ == [251, 252]
    for r in runs["embed_uneven"]:
        assert r["regions"] == [("embed", {"vocab_rows": r["local_rows"]})]
        assert np.array_equal(r["rows"], rows.detach().numpy())
        _close(r["grad"], grad.numpy())


# ---------------------------------------- heads 'model' does not divide
def _on_uneven(params_np, x, x1):
    """On each of 8 ranks, on UNEVEN's (1, 8) mesh: the prefill of ``x``
    by head group and NEW decode steps with its cache split over the
    sequence (a ring of UNEVEN_RING), then the prefill of the one row
    ``x1``."""
    from repro_torch.launch import mesh as mesh_mod
    arch, kv, shape = UNEVEN
    mesh = mesh_mod.make_mesh(shape, ("data", "model"), "cpu")
    cfg, params, place = _placed(arch, kv, params_np, mesh, UNEVEN_RING)
    return (_serve(cfg, params, x, place, UNEVEN_RING, NEW),
            _serve(cfg, params, x1, place, None, 0))


@pytest.fixture(scope="module")
def uneven():
    """The port's unsharded runs of UNEVEN's inputs and the 8 ranks'."""
    cfg = _cfg(*UNEVEN[:2])
    params = _params(cfg)
    x, x1 = _inputs(cfg), _inputs(cfg, seed=2)[:1]
    params_np = t_layers.tree_map(lambda v: v.numpy(), params)
    ranks = run_local(_on_uneven, 8, params_np, x, x1)
    plain = (_serve(cfg, params, x, None, UNEVEN_RING),
             _serve(cfg, params, x1, None, None, 0))
    return plain, ranks, params_np, x


def test_uneven_heads_equal_unsharded(uneven):
    """gemma3-4b's 4 heads over 8 'model' ranks: every rank's prefill
    logits within ``TOL`` and the head-parallel ``PREFILL_TOL`` of the
    unsharded ones, the prefill's cache (gathered to the heads whole)
    within ``TOL``, and the split-cache decode's logits within ``TOL``
    with the greedy tokens equal."""
    (lg, cache, dec, toks, _, _), _ = uneven[0]
    for rank, _ in uneven[1]:
        _close(rank[0], lg)
        _close(rank[0], lg, PREFILL_TOL)
        assert rank[1].keys() == cache.keys()
        for k, v in cache.items():
            _close(rank[1][k], v)
        assert len(rank[2]) == NEW
        for got, want in zip(rank[2], dec):
            _close(got, want)
        for got, want in zip(rank[3], toks):
            assert np.array_equal(got, want)


def test_uneven_prefill_runs_by_head_group(uneven):
    """The prefill ran attention as head groups on local shards: each
    rank its group's one head and the kv head that head reads, on 2 of
    its 4 rows (``rows``), no ``run_on_rows`` for attention and no op of
    a layer with a DTensor operand; then each decode step ran
    flash-decoding on the rank's 2 slots of the ring, every head."""
    cfg = _cfg(*UNEVEN[:2])
    m = UNEVEN[2][1]
    want = {("attention", (("heads", 1), ("kv_heads", 1), ("rows", B // 2))),
            ("dense", (("ff", cfg.d_ff // m),)), ("norm", ()),
            ("run_on_rows", (("region", "embed"),)), ("dtensor_planned", ())}
    for i, (rank, _) in enumerate(uneven[1]):
        assert rank[4] == want, (rank[4], want)
        assert rank[5] == _decode_regions(cfg, m, UNEVEN_RING, i % m)


def test_uneven_prefill_equals_reference(uneven):
    """The prefill by head group against the JAX package's unsharded
    prefill on the same weights."""
    import jax.numpy as jnp
    from repro.configs import get_arch as j_get_arch
    from repro.models import model as j_model
    arch, kv, _ = UNEVEN
    _, ranks, params_np, x = uneven
    jc = dataclasses.replace(j_get_arch(arch).smoke, dtype=jnp.float32,
                             kv_cache_dtype=kv)
    want = np.asarray(j_model.prefill(jc, t_layers.tree_map(
        jnp.asarray, params_np), jnp.asarray(x))[0])
    _close(ranks[0][0][0], want)


def test_batch_one_prefill_takes_rows_path(uneven):
    """A prefill of one row on the (1, 8) mesh: a group of 2 ranks cannot
    split it, so attention runs every head on each rank's row
    (``run_on_rows``, so traced) and no attention region; its logits
    within ``TOL`` of the unsharded prefill's."""
    (_, (lg, _, _, _, _, _)), ranks = uneven[0], uneven[1]
    for _, one in ranks:
        _close(one[0], lg)
        assert ("run_on_rows", (("region", "attention"),)) in one[4]
        assert not any(n == "attention" for n, _ in one[4]), one[4]
