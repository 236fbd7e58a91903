"""The port's inference entry points under a mesh, on CPU process groups:
``prefill``, ``encode`` and ``decode_step`` on a (2, 2) ``("data",
"model")`` mesh of four gloo ranks (smoke configs in f32; qwen3-moe also
on (1, 4), where each pair of 'model' ranks shares a kv head), with the
parameters split by their templates' placements, the batch over 'data'
and the decode cache placed as the dry run places it
(``launch.shapes.cache_structs``: kv leaves over the batch and the
sequence, ``seq_axes`` 'model', recurrent states over the batch).
Prefill and encode run attention head-parallel over 'model' (each rank's
H / model heads on local shards), decode on each rank's rows.

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
TOL = 1e-5
PREFILL_TOL = 1.1e-6     # relative: the head-parallel prefill (PERF.md)


def _id(run) -> str:
    return "-".join(str(v).replace(" ", "") for v in run)


def _mesh_shape(run):
    return run[2] if len(run) > 2 else (2, 2)


def _cfg(arch: str, kv: str):
    return dataclasses.replace(get_arch(arch).smoke, dtype=torch.float32,
                               kv_cache_dtype=kv)


def _inputs(cfg, seed: int = 1) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if cfg.input_kind == "embed":
        return rng.standard_normal((B, T, cfg.d_frontend)).astype(np.float32)
    return rng.integers(0, cfg.vocab, (B, T), dtype=np.int32)


def _params(cfg):
    return t_model.init_params(cfg, torch.Generator().manual_seed(0))


def _flat(tree) -> dict:
    """Copies of the leaves (decode updates the state leaves in place)."""
    return {"/".join(k): v.float().numpy().copy()
            for k, v in t_layers.tree_items(tree)}


def _serve(cfg, params, x, place=None):
    """prefill (or encode) and NEW greedy decode steps -> (prefill logits,
    prefill cache, decode logits, tokens, the regions prefill ran).
    ``place(name, tensor)`` puts a tensor on the mesh (None: one
    device)."""
    from repro_torch.serve.kv_cache import pad_cache
    put = place or (lambda name, t: t)
    full = (lambda t: t.full_tensor()) if place else (lambda t: t)
    xs = put("batch", torch.from_numpy(x))
    t_layers.REGION_TRACE = []
    try:
        if not cfg.is_decoder:
            lg = full(t_model.encode(cfg, params, xs)).numpy()
        else:
            lg, cache = t_model.prefill(cfg, params, xs)
        regions = {(n, tuple(sorted(i.items())))
                   for n, i in t_layers.REGION_TRACE}
    finally:
        t_layers.REGION_TRACE = None
    if not cfg.is_decoder:
        return lg, {}, [], [], regions
    lg = full(lg)
    cache = t_layers.tree_map(full, cache)
    pre_cache = _flat(cache)
    # the decode cache: the prompt's cache padded to the budget, placed
    cache = put("cache", pad_cache(cfg, cache, T + NEW))
    logits, toks = [], []
    tok = torch.argmax(lg, -1).to(torch.int32)[:, None]
    for i in range(NEW):
        toks.append(tok.numpy())
        out, cache = t_model.decode_step(cfg, params, put("batch", tok),
                                         cache, T + i)
        out = full(out)
        logits.append(out.numpy())
        tok = torch.argmax(out, -1).to(torch.int32)[:, None]
    return lg.numpy(), pre_cache, logits, toks, regions


def _on_mesh(runs, params_np, xs):
    """On each rank: every run of ``runs`` on its mesh."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.configs.common import ShapeSpec
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch.shapes import cache_structs
    meshes = {shape: mesh_mod.make_mesh(shape, ("data", "model"), "cpu")
              for shape in sorted({_mesh_shape(r) for r in runs})}
    out = []
    for run, p_np, x in zip(runs, params_np, xs):
        arch, kv = run[:2]
        mesh = meshes[_mesh_shape(run)]
        cfg = dataclasses.replace(_cfg(arch, kv), batch_axes=("data",),
                                  seq_axes=("model",))
        params = t_layers.tree_map(
            lambda a, pl: distribute_tensor(torch.from_numpy(a), mesh, pl,
                                            src_data_rank=None), p_np,
            t_layers.sharding_tree(t_model.build_template(cfg), mesh))
        structs = cache_structs(cfg, ShapeSpec("decode", "decode", T + NEW,
                                               B), mesh)

        def place(name, t, cfg=cfg, structs=structs, mesh=mesh):
            if name == "batch":
                pl = t_layers.placements((cfg.batch_axes,), mesh)
                return distribute_tensor(t, mesh, pl, src_data_rank=None)
            return t_layers.tree_map(
                lambda a, st: distribute_tensor(a.contiguous(), mesh,
                                                st.placements,
                                                src_data_rank=None),
                t, structs)

        out.append(_serve(cfg, params, x, place))
    out.append(_embed_uneven(meshes[(2, 2)]))
    out.append(_moe_uneven(meshes[(2, 2)]))
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


@pytest.fixture(scope="module")
def runs():
    cfgs = [_cfg(*r[:2]) for r in RUNS]
    params = [_params(c) for c in cfgs]
    xs = [_inputs(c) for c in cfgs]
    params_np = [t_layers.tree_map(lambda v: v.numpy(), p) for p in params]
    sharded = run_local(_on_mesh, 4, RUNS, params_np, xs)
    plain = [_serve(c, p, x) for c, p, x in zip(cfgs, params, xs)]
    out = {r: (plain[i], [s[i] for s in sharded], params_np[i], xs[i])
           for i, r in enumerate(RUNS)}
    out["embed_uneven"] = [s[-2] for s in sharded]
    out["moe_uneven"] = [s[-1] for s in sharded]
    return out


def _close(got, want, tol=TOL):
    err = float(np.abs(got - want).max())
    assert err <= tol * max(1.0, float(np.abs(want).max())), err


@pytest.mark.parametrize("run", RUNS, ids=[_id(r) for r in RUNS])
def test_sharded_equals_unsharded(runs, run):
    plain, ranks, _, _ = runs[run]
    lg, cache, dec, toks, _ = plain
    for rank in ranks:                       # every rank holds the result
        _close(rank[0], lg)
        _close(rank[0], lg, PREFILL_TOL)
        for k, v in cache.items():
            _close(rank[1][k], v)
        for got, want in zip(rank[2], dec):
            _close(got, want)
        for got, want in zip(rank[3], toks):
            assert np.array_equal(got, want)


@pytest.mark.parametrize("run", RUNS, ids=[_id(r) for r in RUNS])
def test_prefill_runs_head_parallel(runs, run):
    """The sharded prefill (encode) ran attention on each rank's H / model
    query heads (and the kv heads they read: one shared where the kv
    heads are fewer than the 'model' ranks), the MoE on its E / model
    experts, and entered ``run_on_rows`` only for the embedding (the smoke
    vocabularies do not split over 'model')."""
    _, ranks, _, _ = runs[run]
    cfg = _cfg(*run[:2])
    m = _mesh_shape(run)[1]
    attn = any(k.startswith("attn") for k, _ in cfg.period_pattern)
    want = {("attention", (("heads", cfg.n_heads // m), (
        "kv_heads", max(cfg.n_kv_heads // m, 1))))} if attn else set()
    if cfg.n_experts:
        want.add(("moe", (("experts", cfg.n_experts // m),)))
    if cfg.input_kind == "tokens":
        want.add(("run_on_rows", (("region", "embed"),)))
    for rank in ranks:
        assert rank[4] == want, (rank[4], want)


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
