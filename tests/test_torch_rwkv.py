"""The port's rwkv6 (attention-free) LM against the JAX package's, on the
CPU, at the smoke config.

Each test hands the same numpy inputs, made from a seed, to the JAX
function and its counterpart in ``repro_torch``; weights cross with
``models.convert.params_from_reference`` (bitwise).  The token-shift mix
vectors initialise to ones (no shift), so the tests draw them uniform in
(0, 1) on both sides: the shift carries then matter.

Tolerances: f32 throughout, 1e-5 of the largest |value| (the dense
configs' tolerance, ``test_torch_lm.py``): the port forms the chunk's
pairwise decay exp(L_{t-1} - L_j) directly where the reference forms
r exp(L_{t-1}) . k exp(-L_j), so the intra-chunk sums round differently
(measured <= 4.2e-6 over this file).  The
reference's chunked prefill overflows f32 beyond chunk 16 at these
weights (ROADMAP C10), so the larger chunks are held against its
token-by-token recurrence.  Greedy tokens must be identical.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as j_get_arch  # noqa: E402
from repro.models import layers as j_layers  # noqa: E402
from repro.models import model as j_model  # noqa: E402
from repro.models import rwkv6 as j_rwkv  # noqa: E402
from repro.serve import engine as j_engine  # noqa: E402
from repro.serve import kv_cache as j_kv  # noqa: E402
from repro_torch.configs import get_arch as t_get_arch  # noqa: E402
from repro_torch.embed import EmbeddingExtractor, EmbeddingSource  # noqa: E402
from repro_torch.models import layers as t_layers  # noqa: E402
from repro_torch.models import model as t_model  # noqa: E402
from repro_torch.models import rwkv6 as t_rwkv  # noqa: E402
from repro_torch.models.convert import (cache_from_reference,  # noqa: E402
                                        params_from_reference)
from repro_torch.serve import engine as t_engine  # noqa: E402
from repro_torch.serve import kv_cache as t_kv  # noqa: E402

ARCH = "rwkv6-1.6b"
REL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """Small shapes: one intra-op thread is as fast as eight alone and
    much faster when test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def _close(got, want, rel: float = REL) -> None:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"max abs err {err} > {rel} x {scale}"


def _with_mixes(tree, rng):
    """Every ``mix_*`` leaf drawn uniform in (0, 1)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _with_mixes(v, rng)
        elif k.startswith("mix_"):
            out[k] = rng.uniform(0.0, 1.0, np.shape(v)).astype(np.float32)
        else:
            out[k] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def model():
    """The f32 smoke config in both packages with the same weights."""
    jc = dataclasses.replace(j_get_arch(ARCH).smoke, dtype=jnp.float32)
    tc = dataclasses.replace(t_get_arch(ARCH).smoke, dtype=torch.float32)
    jp = jax.device_get(j_layers.init_params(j_model.build_template(jc),
                                             jax.random.PRNGKey(0)))
    jp = _with_mixes(jp, np.random.default_rng(0))
    return jc, tc, jp, params_from_reference(jp)


def _tokens(jc, seed, b, t):
    return np.random.default_rng(seed).integers(0, jc.vocab, (b, t)
                                                ).astype(np.int32)


def _stepped_reference(jc, jp, x):
    """The reference's T == 1 recurrence over every token: (last logits,
    cache)."""
    b, t = x.shape
    cache = j_model.init_cache(jc, b, 1)
    step = jax.jit(j_model.decode_step, static_argnums=0)
    for i in range(t):
        logits, cache = step(jc, jp, jnp.asarray(x[:, i:i + 1]), cache,
                             jnp.int32(i))
    return np.asarray(logits), cache


# ------------------------------------------------------------ the mixers
@pytest.mark.parametrize("t,with_state", [(21, False), (13, True),
                                          (1, True)])
def test_mixer_and_channel_mix_match(model, t, with_state):
    jc, tc, jp, tp = model
    p = jp["stack"]["pos0"]
    pm = {k: v[0] for k, v in p["mixer"].items()}
    pc = {k: v[0] for k, v in p["mlp"].items()}
    rng = np.random.default_rng(t)
    d, h, kd = jc.d_model, jc.rwkv_heads, jc.rwkv_head_dim
    x = rng.normal(size=(2, t, d)).astype(np.float32)
    carry = rng.normal(size=(2, 1, d)).astype(np.float32)
    state = (0.3 * rng.normal(size=(2, h, kd, kd))).astype(np.float32)
    kw = dict(n_heads=h, head_dim=kd, chunk=jc.rwkv_chunk)
    js = dict(state=jnp.asarray(state), shift_carry=jnp.asarray(carry)) \
        if with_state else {}
    ts = dict(state=_t(state), shift_carry=_t(carry)) if with_state else {}
    want = j_rwkv.rwkv6_mixer({k: jnp.asarray(v) for k, v in pm.items()},
                              jnp.asarray(x), dtype=jnp.float32, **kw, **js)
    got = t_rwkv.rwkv6_mixer({k: _t(v) for k, v in pm.items()}, _t(x),
                             dtype=torch.float32, **kw, **ts)
    for g, w in zip(got, want):
        _close(g.numpy(), w)
    want = j_rwkv.channel_mix({k: jnp.asarray(v) for k, v in pc.items()},
                              jnp.asarray(x), jnp.asarray(carry), jnp.float32)
    got = t_rwkv.channel_mix({k: _t(v) for k, v in pc.items()}, _t(x),
                             _t(carry), torch.float32)
    for g, w in zip(got, want):
        _close(g.numpy(), w)


def test_chunk_does_not_overflow_where_the_reference_does():
    """A chunk of 128 steps of decay e^-1.14 a step (the full config's
    mean at init): the reference's k exp(-L) overflows f32, the port's
    pairwise form stays finite and equals the stepped recurrence."""
    rng = np.random.default_rng(3)
    b, h, q, kd = 1, 2, 128, 8
    r, k, v = (rng.normal(size=(b, h, q, kd)).astype(np.float32)
               for _ in range(3))
    w = np.full((b, h, q, kd), np.exp(-1.14), np.float32)
    u = rng.normal(size=(h, kd)).astype(np.float32)
    s0 = np.zeros((b, h, kd, kd), np.float32)
    o_ref, _ = j_rwkv._wkv_chunk(*(jnp.asarray(a) for a in (r, k, v, w, u,
                                                            s0)))
    assert not np.isfinite(np.asarray(o_ref)).all()
    o, s_end = t_rwkv._wkv_chunk(*(_t(a) for a in (r, k, v, w, u, s0)))
    s = s0.astype(np.float64)
    want = np.zeros((b, h, q, kd))
    for i in range(q):
        kv = k[:, :, i, :, None] * v[:, :, i, None, :]
        want[:, :, i] = np.einsum("bhk,bhkv->bhv", r[:, :, i],
                                  s + u[None, :, :, None] * kv)
        s = w[:, :, i, :, None] * s + kv
    _close(o.numpy(), want)
    _close(s_end.numpy(), s)


# --------------------------------------------------- backbone and prefill
def test_backbone_and_prefill_match_at_chunk_8(model):
    jc, tc, jp, tp = model
    x = _tokens(jc, 1, 3, 21)
    pos = np.broadcast_to(np.arange(21, dtype=np.int32), (3, 21)).copy()
    hj, _, _ = jax.jit(j_model.backbone, static_argnums=0)(
        jc, jp, jnp.asarray(x), jnp.asarray(pos))
    ht, _, _ = t_model.backbone(tc, tp, _t(x), _t(pos))
    _close(ht.numpy(), hj)
    lj, cj = jax.jit(j_model.prefill, static_argnums=0)(jc, jp,
                                                         jnp.asarray(x))
    lt, ct = t_model.prefill(tc, tp, _t(x))
    _close(lt.numpy(), lj)
    want = cache_from_reference(jax.device_get(cj))
    for path, leaf in t_layers.tree_items(ct):
        ref = want
        for key in path:
            ref = ref[key]
        assert leaf.dtype == ref.dtype == torch.float32, path
        _close(leaf.numpy(), ref.numpy())


@pytest.mark.parametrize("chunk", [8, 24, 128])
def test_prefill_equals_the_stepped_recurrence(model, chunk):
    """The port's chunked prefill at any chunk (the reference's chunked
    form is non-finite at 24 and 128 here) against the reference's token
    by token recurrence: logits and every state leaf."""
    jc, tc, jp, tp = model
    x = _tokens(jc, 2, 2, 40)
    want, cj = _stepped_reference(jc, jp, x)
    lt, ct = t_model.prefill(dataclasses.replace(tc, rwkv_chunk=chunk), tp,
                             _t(x))
    assert torch.isfinite(lt).all()
    _close(lt.numpy(), want)
    ref = cache_from_reference(jax.device_get(cj))["stack"]["pos0"]
    for name in ("wkv", "shift", "shift_ffn"):
        _close(ct["stack"]["pos0"][name].numpy(), ref[name].numpy())


def test_prefill_then_decode_equals_longer_prefill(model):
    """prefill(T) + decode(token T) == prefill(T + 1) (the twin of
    ``test_prefill_decode_consistency``); the cache keeps its structure
    and the state is written into it in place."""
    jc, tc, jp, tp = model
    x = _tokens(jc, 4, 2, 13)
    want, _ = t_model.prefill(tc, tp, _t(x))
    _, cache = t_model.prefill(tc, tp, _t(x[:, :12]))
    cache = t_kv.pad_cache(tc, cache, 16)
    before = {p: leaf.clone() for p, leaf in t_layers.tree_items(cache)}
    got, new = t_model.decode_step(tc, tp, _t(x[:, 12:13]), cache, 12)
    _close(got.numpy(), want.numpy())
    assert new is cache or new["stack"] is cache["stack"]
    assert [p for p, _ in t_layers.tree_items(new)] == list(before)
    for p, leaf in t_layers.tree_items(cache):
        assert not torch.equal(leaf, before[p]), p


def test_generate_greedy_tokens_identical(model):
    """Greedy tokens equal the reference's, and equal re-prefilling the
    whole sequence at every step (``test_generate_matches_rerun_prefill``)."""
    jc, tc, jp, tp = model
    prompt = _tokens(jc, 5, 2, 6)
    want = np.asarray(j_engine.generate(jc, jp, jnp.asarray(prompt), 6))
    got = t_engine.generate(tc, tp, _t(prompt), 6)
    np.testing.assert_array_equal(got.numpy(), want)
    cur = _t(prompt)
    for _ in range(6):
        logits, _ = t_model.prefill(tc, tp, cur)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        cur = torch.cat([cur.to(torch.int32), nxt], dim=1)
    assert torch.equal(got, cur)


def test_cache_bytes_constant_in_seq(model):
    jc, tc, _, _ = model
    sizes = {t_kv.cache_bytes(tc, 2, s) for s in (1, 64, 524_288)}
    assert sizes == {j_kv.cache_bytes(jc, 2, 64)}
    full = t_get_arch(ARCH).config
    per_layer = 4 * (2 * full.d_model + full.d_model * full.rwkv_head_dim)
    assert t_kv.cache_bytes(full, 1, 524_288) == full.n_layers * per_layer


def test_weights_carry_across_bitwise(model):
    jc, tc, jp, tp = model
    got = {p: (tuple(v.shape), v.dtype) for p, v in t_layers.tree_items(tp)}
    want = {p: (s.shape, s.dtype)
            for p, s in t_layers.tree_items(t_model.build_template(tc))}
    assert got == want
    jb = j_layers.init_params(
        j_model.build_template(j_get_arch(ARCH).smoke), jax.random.PRNGKey(1))
    leaf = np.asarray(jb["stack"]["pos0"]["mixer"]["wr"])
    assert leaf.dtype.name == "bfloat16"
    tb = params_from_reference(jax.device_get(jb))
    np.testing.assert_array_equal(
        tb["stack"]["pos0"]["mixer"]["wr"].view(torch.int16).numpy(),
        leaf.view(np.int16))
    assert t_get_arch(ARCH).config.param_count() == \
        j_get_arch(ARCH).config.param_count()


def test_extractor_rows_bitwise_invariant_to_block_and_chunk(model):
    """A row's pooled embedding is the same bits whether its block is full
    or a zero-padded tail, and whatever chunk size the source is read
    with; and it equals the reference's extractor within f32 noise."""
    from repro.embed import EmbeddingExtractor as JExtractor
    jc, tc, jp, tp = model
    tokens = _tokens(jc, 6, 37, 10)
    ex = EmbeddingExtractor(tc, tp, batch_size=8, device="cpu")
    full = ex(tokens[:8])
    for m in (1, 3, 7):
        np.testing.assert_array_equal(ex(tokens[:m]), full[:m])
    ref = EmbeddingSource(tokens, ex).materialize()
    for cs in (5, 16):
        rows = np.concatenate([c for _, c in
                               EmbeddingSource(tokens, ex).iter_chunks(cs)])
        np.testing.assert_array_equal(rows, ref)
    _close(ref[:8], JExtractor(jc, jp, batch_size=8)(tokens[:8]))
