"""The port's inference entry points under a mesh, on CPU process groups:
``prefill``, ``encode`` and ``decode_step`` on a (2, 2) ``("data",
"model")`` mesh of four gloo ranks (smoke configs in f32), with the
parameters split by their templates' placements, the batch over 'data'
and the decode cache placed as the dry run places it
(``launch.shapes.cache_structs``: kv leaves over the batch and the
sequence, ``seq_axes`` 'model', recurrent states over the batch).

Each run is held against the port's unsharded run on the same weights and
tokens, and its prefill against the JAX package's unsharded ``prefill``.
Tolerance: f32, a sharded matmul sums its contraction in another order,
a few ulps per op over a dozen ops: 1e-5 of the largest |logit| (measured
<= 1.1e-6 relative against either); greedy tokens must be equal, and the
prefill's caches are held within the same bound of their largest |value|.

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
        ("hubert-xlarge", "bf16"))
B, T, NEW = 4, 8, 3
TOL = 1e-5


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
    prefill cache, decode logits, tokens).  ``place(name, tensor)`` puts a
    tensor on the mesh (None: one device)."""
    from repro_torch.serve.kv_cache import pad_cache
    put = place or (lambda name, t: t)
    full = (lambda t: t.full_tensor()) if place else (lambda t: t)
    xs = put("batch", torch.from_numpy(x))
    if not cfg.is_decoder:
        return full(t_model.encode(cfg, params, xs)).numpy(), {}, [], []
    lg, cache = t_model.prefill(cfg, params, xs)
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
    return lg.numpy(), pre_cache, logits, toks


def _on_mesh(runs, params_np, xs):
    """On each rank: every run of ``runs`` on a (2, 2) mesh."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.configs.common import ShapeSpec
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch.shapes import cache_structs
    mesh = mesh_mod.make_mesh((2, 2), ("data", "model"), "cpu")
    out = []
    for (arch, kv), p_np, x in zip(runs, params_np, xs):
        cfg = dataclasses.replace(_cfg(arch, kv), batch_axes=("data",),
                                  seq_axes=("model",))
        params = t_layers.tree_map(
            lambda a, pl: distribute_tensor(torch.from_numpy(a), mesh, pl,
                                            src_data_rank=None), p_np,
            t_layers.sharding_tree(t_model.build_template(cfg), mesh))
        structs = cache_structs(cfg, ShapeSpec("decode", "decode", T + NEW,
                                               B), mesh)

        def place(name, t, cfg=cfg, structs=structs):
            if name == "batch":
                pl = t_layers.placements((cfg.batch_axes,), mesh)
                return distribute_tensor(t, mesh, pl, src_data_rank=None)
            return t_layers.tree_map(
                lambda a, st: distribute_tensor(a.contiguous(), mesh,
                                                st.placements,
                                                src_data_rank=None),
                t, structs)

        out.append(_serve(cfg, params, x, place))
    return out


@pytest.fixture(scope="module")
def runs():
    cfgs = [_cfg(a, kv) for a, kv in RUNS]
    params = [_params(c) for c in cfgs]
    xs = [_inputs(c) for c in cfgs]
    params_np = [t_layers.tree_map(lambda v: v.numpy(), p) for p in params]
    sharded = run_local(_on_mesh, 4, RUNS, params_np, xs)
    plain = [_serve(c, p, x) for c, p, x in zip(cfgs, params, xs)]
    return {r: (plain[i], [s[i] for s in sharded], params_np[i], xs[i])
            for i, r in enumerate(RUNS)}


def _close(got, want, tol=TOL):
    err = float(np.abs(got - want).max())
    assert err <= tol * max(1.0, float(np.abs(want).max())), err


@pytest.mark.parametrize("run", RUNS, ids=[f"{a}-{k}" for a, k in RUNS])
def test_sharded_equals_unsharded(runs, run):
    plain, ranks, _, _ = runs[run]
    lg, cache, dec, toks = plain
    for rank in ranks:                       # every rank holds the result
        _close(rank[0], lg)
        for k, v in cache.items():
            _close(rank[1][k], v)
        for got, want in zip(rank[2], dec):
            _close(got, want)
        for got, want in zip(rank[3], toks):
            assert np.array_equal(got, want)


@pytest.mark.parametrize("run", RUNS, ids=[f"{a}-{k}" for a, k in RUNS])
def test_sharded_prefill_equals_reference(runs, run):
    """The sharded prefill (encode) against the JAX package's unsharded
    one on the same weights."""
    import jax.numpy as jnp
    from repro.configs import get_arch as j_get_arch
    from repro.models import model as j_model
    arch, kv = run
    _, ranks, params_np, x = runs[run]
    jc = dataclasses.replace(j_get_arch(arch).smoke, dtype=jnp.float32,
                             kv_cache_dtype=kv)
    jp = t_layers.tree_map(jnp.asarray, params_np)
    if jc.is_decoder:
        want = np.asarray(j_model.prefill(jc, jp, jnp.asarray(x))[0])
    else:
        want = np.asarray(j_model.encode(jc, jp, jnp.asarray(x)))
    _close(ranks[0][0], want)
