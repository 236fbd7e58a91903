"""The port's MoE and mamba mixers, and the three configurations built on
them (qwen3-moe-235b-a22b, llama4-maverick-400b-a17b, jamba-v0.1-52b),
against the JAX package's, on the CPU, at the smoke configs.

Each test hands the same numpy inputs, made from a seed, to the JAX
function and its counterpart in ``repro_torch``; weights cross with
``models.convert.params_from_reference`` (bitwise).  The loss and
gradients of every architecture are held by ``test_torch_lm_train.py``
(parametrised over ``ARCH_IDS``); this file holds the forward, the
serving path, the mixers alone and the trees.

Tolerances (f32): logits, hidden states and the MoE outputs within 1e-4
of the largest |value| (the same products reduced in another order:
measured <= 1.4e-6 on the three configs); the mamba end state within
1e-5 (the port's doubling scan sums in another order than the
reference's associative scan: measured <= 1.2e-6).  Routing is integer
and must be equal: the experts each token chose, the kept and dropped
assignments, and their slot ids.  In bf16, the MoE output within 2e-2 of
its largest |value| (one bf16 rounding of each product and the sum over
k in another order), the routing still equal.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as j_get_arch  # noqa: E402
from repro.kernels.decode_attention.ref import (  # noqa: E402
    decode_attention_ref as j_decode_ref)
from repro.models import layers as j_layers  # noqa: E402
from repro.models import model as j_model  # noqa: E402
from repro.models import moe as j_moe  # noqa: E402
from repro.models import ssm as j_ssm  # noqa: E402
from repro.serve import kv_cache as j_kv  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_arch  # noqa: E402
from repro_torch.kernels.decode_attention import ops as t_dec_ops  # noqa: E402
from repro_torch.embed import EmbeddingExtractor, EmbeddingSource  # noqa: E402
from repro_torch.models import layers as t_layers  # noqa: E402
from repro_torch.models import model as t_model  # noqa: E402
from repro_torch.models import moe as t_moe  # noqa: E402
from repro_torch.models import ssm as t_ssm  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.serve import engine as t_engine  # noqa: E402
from repro_torch.serve import kv_cache as t_kv  # noqa: E402

ARCHS = ("qwen3-moe-235b-a22b", "llama4-maverick-400b-a17b",
         "jamba-v0.1-52b")
REL = 1e-4
STATE_REL = 1e-5


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


_MODELS: dict = {}


def _model(arch: str, **over):
    """Both packages' f32 smoke configs (with ``over`` applied), the JAX
    parameters from a seed and the port's copy of them."""
    key = (arch, tuple(sorted(over.items())))
    if key not in _MODELS:
        jc = dataclasses.replace(j_get_arch(arch).smoke, dtype=jnp.float32,
                                 **over)
        tc = dataclasses.replace(get_arch(arch).smoke, dtype=torch.float32,
                                 **over)
        jp = jax.device_get(j_layers.init_params(j_model.build_template(jc),
                                                 jax.random.PRNGKey(0)))
        _MODELS[key] = (jc, tc, jp, params_from_reference(jp))
    return _MODELS[key]


def _tokens(cfg, b: int, t: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, size=(b, t)).astype(np.int32)


def _drop_free(arch: str) -> dict:
    s = get_arch(arch).smoke
    return {"moe_capacity_factor": float(s.n_experts / max(s.top_k, 1))}


# ---------------------------------------------------------------- configs
@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_dims_match_assignment(arch):
    """CONFIG and SMOKE carry the reference's fields, field for field, the
    published dims, and the same parameter count (template only)."""
    expected = {
        "qwen3-moe-235b-a22b": (94, 4096, 1536, 151936, 128, 8, 1536),
        "llama4-maverick-400b-a17b": (48, 5120, 8192, 202048, 128, 1, 8192),
        "jamba-v0.1-52b": (32, 4096, 14336, 65536, 16, 2, 14336),
    }[arch]
    cfg = get_arch(arch).config
    assert (cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab, cfg.n_experts,
            cfg.top_k, cfg.moe_d_ff) == expected
    assert cfg.n_periods * cfg.period + cfg.tail == cfg.n_layers
    for full in (True, False):
        j = j_get_arch(arch).config if full else j_get_arch(arch).smoke
        t = cfg if full else get_arch(arch).smoke
        for f in dataclasses.fields(t):
            if f.name != "dtype":
                assert getattr(t, f.name) == getattr(j, f.name), f.name
        assert (t.d_inner, t.dt_rank) == (j.d_inner, j.dt_rank)
        assert t.param_count() == j.param_count()


@pytest.mark.parametrize("arch", ARCHS)
def test_weights_carry_across_bitwise(arch):
    """Every leaf of the bf16 smoke tree, the f32 router, ``a_log``,
    ``conv_w``, ``dt_proj_*`` and the stacked (n_periods, E, d, ff)
    experts among them, carries across bit for bit with its dtype."""
    jc = j_get_arch(arch).smoke
    jp = jax.device_get(j_layers.init_params(j_model.build_template(jc),
                                             jax.random.PRNGKey(1)))
    tp = params_from_reference(jp)
    want = {p: (tuple(s.shape), s.dtype) for p, s in t_layers.tree_items(
        t_model.build_template(get_arch(arch).smoke))}
    got = {p: (tuple(v.shape), v.dtype) for p, v in t_layers.tree_items(tp)}
    assert got == want
    names = set()
    for path, leaf in t_layers.tree_items(jp):
        node = tp
        for k in path:
            node = node[k]
        a = np.asarray(leaf)
        names.add(path[-1])
        if a.dtype.name == "bfloat16":
            np.testing.assert_array_equal(node.view(torch.int16).numpy(),
                                          a.view(np.int16))
        else:
            np.testing.assert_array_equal(node.numpy(), a)
    assert {"router", "wi", "wg", "wo"} <= names
    if arch == "jamba-v0.1-52b":
        assert {"a_log", "conv_w", "dt_proj_w", "dt_proj_b"} <= names
        assert tp["stack"]["pos1"]["mlp"]["wi"].dim() == 4


# ---------------------------------------------------------------- forward
@pytest.mark.parametrize("arch", ARCHS)
def test_backbone_and_aux_match(arch):
    """Hidden states and the summed MoE aux loss against the reference's
    backbone, T off the MoE chunk (the tail chunk zero-padded) and off
    the mamba chunk."""
    jc, tc, jp, tp = _model(arch)
    x = _tokens(jc, 3, 23, 0)
    pos = np.broadcast_to(np.arange(23, dtype=np.int32), (3, 23)).copy()
    hj, aj, _ = jax.jit(j_model.backbone, static_argnums=0)(
        jc, jp, jnp.asarray(x), jnp.asarray(pos))
    ht, at, _ = t_model.backbone(tc, tp, _t(x), _t(pos))
    _close(ht.numpy(), np.asarray(hj))
    _close(float(at), float(aj), 1e-5)
    assert float(at) > 0.0


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_pad_decode_match(arch):
    """prefill -> pad_cache -> three decode steps against the reference's
    serving steps: logits and every cache leaf (the mamba conv and scan
    states among them)."""
    jc, tc, jp, tp = _model(arch)
    x = _tokens(jc, 2, 15, 1)
    lj, cj = jax.jit(j_model.prefill, static_argnums=0)(jc, jp,
                                                        jnp.asarray(x[:, :12]))
    lt, ct = t_model.prefill(tc, tp, _t(x[:, :12]))
    _close(lt.numpy(), np.asarray(lj))
    cj = j_kv.pad_cache(jc, cj, 16)
    ct = t_kv.pad_cache(tc, ct, 16)
    step = jax.jit(j_model.decode_step, static_argnums=0)
    for j in range(3):
        lj, cj = step(jc, jp, jnp.asarray(x[:, 12 + j:13 + j]), cj,
                      jnp.int32(12 + j))
        lt, ct = t_model.decode_step(tc, tp, _t(x[:, 12 + j:13 + j]), ct,
                                     12 + j)
        _close(lt.numpy(), np.asarray(lj))
    want = dict(t_layers.tree_items(jax.device_get(cj)))
    for path, leaf in t_layers.tree_items(ct):
        _close(leaf.numpy(), np.asarray(want[path]))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_consistency(arch):
    """prefill(T) + decode(token T) == prefill(T + 1)'s last logits, at
    drop-free capacity (``test_arch_smoke.py``'s case), and the decode
    logits equal the reference's."""
    jc, tc, jp, tp = _model(arch, **_drop_free(arch))
    x = _tokens(jc, 2, 13, 4)
    want, _ = t_model.prefill(tc, tp, _t(x))
    _, cache = t_model.prefill(tc, tp, _t(x[:, :12]))
    cache = t_kv.pad_cache(tc, cache, 16)
    got, new = t_model.decode_step(tc, tp, _t(x[:, 12:13]), cache, 12)
    _close(got.numpy(), want.numpy())
    assert ([(k, v.shape) for k, v in t_layers.tree_items(new)]
            == [(k, v.shape) for k, v in t_layers.tree_items(cache)])
    _, cj = j_model.prefill(jc, jp, jnp.asarray(x[:, :12]))
    lj, _ = j_model.decode_step(jc, jp, jnp.asarray(x[:, 12:13]),
                                j_kv.pad_cache(jc, cj, 16), jnp.int32(12))
    _close(got.numpy(), np.asarray(lj))


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_generation_matches_reprefill(arch):
    """Greedy decode token by token equals greedy re-prefill at every
    step (drop-free capacity)."""
    _, tc, _, tp = _model(arch, **_drop_free(arch))
    prompt = _t(_tokens(tc, 2, 7, 5))
    got = t_engine.generate(tc, tp, prompt, 4)
    cur = prompt
    for _ in range(4):
        logits, _ = t_model.prefill(tc, tp, cur)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        cur = torch.cat([cur.to(torch.int32), nxt], dim=1)
    assert torch.equal(got, cur)


# ------------------------------------------------------------------- MoE
def _moe_case(arch: str, n_tok: int, seed: int, cf=None):
    """The first MoE layer's parameters of the f32 smoke model, and n_tok
    token rows."""
    jc, tc, jp, tp = _model(arch)
    i = next(i for i, (_, f) in enumerate(jc.period_pattern) if f == "moe")
    jpm = jax.tree.map(lambda a: a[0], jp["stack"][f"pos{i}"]["mlp"])
    tpm = {k: (v[0] if not isinstance(v, dict) else
               {kk: vv[0] for kk, vv in v.items()})
           for k, v in tp["stack"][f"pos{i}"]["mlp"].items()}
    x = np.random.default_rng(seed).normal(
        size=(1, n_tok, jc.d_model)).astype(np.float32)
    kw = dict(top_k=jc.top_k, n_experts=jc.n_experts, act=jc.act,
              capacity_factor=jc.moe_capacity_factor if cf is None else cf,
              chunk=jc.moe_chunk)
    return jpm, tpm, x, kw


def _reference_routing(logits, top_k, capacity, n_experts):
    """The reference's routing lines of ``_chunk_moe`` on its own
    ``_route``: (expert ids, kept (t k, E), slot ids)."""
    ct = logits.shape[0]
    _, idx = j_moe._route(logits, top_k)
    onehot = jax.nn.one_hot(idx, n_experts, dtype=jnp.int32)
    flat = onehot.reshape(ct * top_k, n_experts)
    pos = jnp.cumsum(flat, axis=0) * flat - 1
    keep = (pos < capacity) & (flat > 0)
    slot = jnp.sum(jnp.where(keep, idx.reshape(ct * top_k)[:, None]
                             * capacity + pos, 0), axis=1)
    slot = jnp.where(~jnp.any(keep, axis=1), n_experts * capacity, slot)
    return np.asarray(idx), np.asarray(keep), np.asarray(slot)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("impl", ["einsum", "gather"])
@pytest.mark.parametrize("cf", [None, 0.5])
def test_moe_mlp_matches_reference(arch, impl, cf):
    """``moe_mlp`` on 150 tokens (three chunks of 64, the last padded):
    output and aux loss against the reference's, and every chunk's expert
    ids, kept set and slot ids equal the reference's, at the config's
    capacity factor and at 0.5, where tokens are surely dropped."""
    jpm, tpm, x, kw = _moe_case(arch, 150, 7, cf)
    oj, aj = j_moe.moe_mlp({k: jnp.asarray(v) if not isinstance(v, dict)
                            else {kk: jnp.asarray(vv) for kk, vv in v.items()}
                            for k, v in jpm.items()}, jnp.asarray(x),
                           dtype=jnp.float32, impl=impl, **kw)
    ot, at = t_moe.moe_mlp(tpm, _t(x), dtype=torch.float32, impl=impl, **kw)
    _close(ot.numpy(), np.asarray(oj))
    _close(float(at), float(aj), 1e-5)
    chunk, n_e, k = kw["chunk"], kw["n_experts"], kw["top_k"]
    cap = t_moe.capacity_for(chunk, k, n_e, kw["capacity_factor"])
    xt = np.concatenate([x[0], np.zeros((3 * chunk - 150, x.shape[2]),
                                        np.float32)])
    dropped = 0
    for c in range(3):
        xc = xt[c * chunk:(c + 1) * chunk]
        logits = xc @ np.asarray(jpm["router"], np.float32)
        idx, keep, slot = _reference_routing(jnp.asarray(logits), k, cap, n_e)
        r = t_moe.route_chunk(_t(logits), k, cap, n_e)
        np.testing.assert_array_equal(r["idx"].numpy(), idx)
        np.testing.assert_array_equal(r["keep"].numpy(), keep)
        np.testing.assert_array_equal(r["slot"].numpy(), slot)
        dropped += int((~keep.any(1)).sum())
    assert dropped > 0 or cf is None


def test_moe_mlp_bf16_within_rounding():
    """In bf16 (the full configs' dtype) the routing is the reference's
    and the output within 2e-2 of its largest |value|."""
    jpm, tpm, x, kw = _moe_case("qwen3-moe-235b-a22b", 100, 8)
    jb = jax.tree.map(lambda a: np.asarray(jnp.asarray(a).astype(
        jnp.bfloat16 if a.ndim == 3 else a.dtype)), jpm)
    tb = params_from_reference(jb)
    xb = np.asarray(jnp.asarray(x).astype(jnp.bfloat16))
    for impl in ("einsum", "gather"):
        oj, _ = j_moe.moe_mlp(jax.tree.map(jnp.asarray, jb), jnp.asarray(xb),
                              dtype=jnp.bfloat16, impl=impl, **kw)
        ot, _ = t_moe.moe_mlp(tb, params_from_reference({"x": xb})["x"],
                              dtype=torch.bfloat16, impl=impl, **kw)
        _close(ot.float().numpy(), np.asarray(oj, np.float32), 2e-2)


def test_gather_equals_einsum_forward_and_grad():
    """``TestGatherMoE``'s first case: the loss and every gradient leaf."""
    _, tc, _, tp = _model("qwen3-moe-235b-a22b")
    tg = dataclasses.replace(tc, moe_impl="gather")
    toks = _t(_tokens(tc, 2, 32, 3))
    batch = {"inputs": toks, "labels": torch.roll(toks, -1, 1)}
    grads = []
    for c in (tc, tg):
        p = t_layers.tree_map(lambda a: a.clone().requires_grad_(True), tp)
        loss = t_model.loss_fn(c, p, batch)
        loss.backward()
        grads.append((float(loss.detach()), dict(t_layers.tree_items(
            t_layers.tree_map(lambda a: a.grad, p)))))
    assert abs(grads[0][0] - grads[1][0]) < 1e-6
    worst = max(float((grads[0][1][k] - grads[1][1][k]).abs().max())
                for k in grads[0][1])
    assert worst < 1e-5, worst


def test_gather_capacity_drops_match_einsum():
    """``TestGatherMoE``'s second case: with tight capacity both impls
    drop the same tokens (the same loss), and the reference agrees."""
    jc, tc, jp, tp = _model("jamba-v0.1-52b", moe_capacity_factor=0.5)
    toks = _tokens(tc, 2, 32, 5)
    labels = np.roll(toks, -1, 1)
    tb = {"inputs": _t(toks), "labels": _t(labels)}
    le = float(t_model.loss_fn(tc, tp, tb))
    lg = float(t_model.loss_fn(dataclasses.replace(tc, moe_impl="gather"),
                               tp, tb))
    assert abs(le - lg) < 1e-6
    lj = float(j_model.loss_fn(jc, jp, {"inputs": jnp.asarray(toks),
                                        "labels": jnp.asarray(labels)}))
    assert abs(le - lj) <= 1e-5 * abs(lj)


def test_route_breaks_ties_to_the_lower_expert():
    """A zero-padded token has every logit equal: the lower indices win,
    in order, as in ``lax.top_k``."""
    logits = torch.zeros((3, 8))
    logits[1, 5] = 1.0
    _, idx = t_moe._route(logits, 3)
    assert idx.tolist() == [[0, 1, 2], [5, 0, 1], [0, 1, 2]]
    _, jidx = j_moe._route(jnp.asarray(logits.numpy()), 3)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))


# ----------------------------------------------------------------- mamba
def _mamba_case(seed: int):
    """The first mamba layer's parameters of jamba's f32 smoke model,
    a_log and the conv drawn so the decays and the carry matter."""
    jc, tc, jp, tp = _model("jamba-v0.1-52b")
    jpm = {k: np.asarray(v[0]) for k, v in
           jp["stack"]["pos1"]["mixer"].items()}
    kw = dict(d_inner=jc.d_inner, d_state=jc.ssm_d_state,
              d_conv=jc.ssm_d_conv, dt_rank=jc.dt_rank)
    rng = np.random.default_rng(seed)
    jpm["conv_b"] = rng.normal(size=jpm["conv_b"].shape).astype(np.float32)
    return jc, jpm, params_from_reference(jpm), kw, rng


def _mamba_pair(jpm, tpm, x, kw, chunk, state=None, t_state=None):
    oj, sj = j_ssm.mamba_mixer({k: jnp.asarray(v) for k, v in jpm.items()},
                               jnp.asarray(x), dtype=jnp.float32,
                               chunk=chunk, state=state, **kw)
    ot, st = t_ssm.mamba_mixer(tpm, _t(x), dtype=torch.float32, chunk=chunk,
                               state=t_state, **kw)
    return (oj, sj), (ot, st)


@pytest.mark.parametrize("t,chunk", [(21, 8), (21, 5), (16, 8), (7, 256)])
def test_mamba_mixer_matches_reference(t, chunk):
    """Output and end state (conv carry, scan state) against the
    reference's chunked scan: T off the chunk (the tail padded with
    dt = 0), two chunk sizes, one chunk longer than T."""
    jc, jpm, tpm, kw, rng = _mamba_case(0)
    x = rng.normal(size=(2, t, jc.d_model)).astype(np.float32)
    (oj, sj), (ot, st) = _mamba_pair(jpm, tpm, x, kw, chunk)
    _close(ot.numpy(), np.asarray(oj))
    _close(st.ssm.numpy(), np.asarray(sj.ssm), STATE_REL)
    np.testing.assert_array_equal(st.conv.numpy(), np.asarray(sj.conv))


def test_mamba_state_carries_across_calls():
    """A prefill of T1 tokens continued from its state over T2 more (the
    conv carry crossing the edge) equals one prefill of T1 + T2, and the
    continued call equals the reference's."""
    jc, jpm, tpm, kw, rng = _mamba_case(1)
    x = rng.normal(size=(2, 19, jc.d_model)).astype(np.float32)
    _, (o_all, s_all) = _mamba_pair(jpm, tpm, x, kw, 4)
    (_, sj1), (o1, s1) = _mamba_pair(jpm, tpm, x[:, :11], kw, 4)
    (oj2, sj2), (o2, s2) = _mamba_pair(jpm, tpm, x[:, 11:], kw, 4,
                                       state=sj1, t_state=s1)
    _close(torch.cat([o1, o2], 1).numpy(), o_all.numpy(), STATE_REL)
    _close(s2.ssm.numpy(), s_all.ssm.numpy(), STATE_REL)
    np.testing.assert_array_equal(s2.conv.numpy(), s_all.conv.numpy())
    _close(o2.numpy(), np.asarray(oj2))
    _close(s2.ssm.numpy(), np.asarray(sj2.ssm), STATE_REL)


def test_mamba_prefill_equals_stepped_decode():
    """The end state of one chunked prefill against T single steps (the
    T == 1 closed form), in the port and against the reference's steps;
    the stepped outputs equal the prefill's."""
    jc, jpm, tpm, kw, rng = _mamba_case(2)
    x = rng.normal(size=(2, 13, jc.d_model)).astype(np.float32)
    _, (o_pre, s_pre) = _mamba_pair(jpm, tpm, x, kw, 4)
    zeros = lambda m: (np.zeros((2, jc.ssm_d_conv - 1, jc.d_inner),
                                np.float32),
                       np.zeros((2, jc.d_inner, jc.ssm_d_state), np.float32))
    c0, h0 = zeros(None)
    sj = j_ssm.SSMState(jnp.asarray(c0), jnp.asarray(h0))
    st = t_ssm.SSMState(_t(c0), _t(h0))
    outs = []
    for i in range(13):
        (oj, sj), (ot, st) = _mamba_pair(jpm, tpm, x[:, i:i + 1], kw, 4,
                                         state=sj, t_state=st)
        _close(ot.numpy(), np.asarray(oj))
        outs.append(ot)
    _close(torch.cat(outs, 1).numpy(), o_pre.numpy(), STATE_REL)
    _close(st.ssm.numpy(), s_pre.ssm.numpy(), STATE_REL)
    _close(st.ssm.numpy(), np.asarray(sj.ssm), STATE_REL)
    np.testing.assert_array_equal(st.conv.numpy(), s_pre.conv.numpy())


def test_scan_equals_the_recurrence():
    """The doubling scan against the plain loop h_t = a_t h_{t-1} + b_t,
    at lengths on and off a power of two."""
    gen = torch.Generator().manual_seed(0)
    for n in (1, 2, 5, 8, 33):
        a = torch.rand(2, n, 3, 4, generator=gen)
        b = torch.randn(2, n, 3, 4, generator=gen)
        h = torch.zeros(2, 3, 4)
        want = []
        for i in range(n):
            h = a[:, i] * h + b[:, i]
            want.append(h)
        _close(t_ssm._scan(a, b).numpy(), torch.stack(want, 1).numpy(),
               1e-6)


# ----------------------------------------------------------- caches, trees
def test_pad_cache_pads_only_kv():
    """The twin of ``test_serve_and_launch.py``'s case on jamba's smoke
    config: only k/v grow; the mamba conv leaf (axis 1 is d_conv - 1)
    and scan state keep their shapes."""
    cfg = get_arch("jamba-v0.1-52b").smoke
    cache = t_model.init_cache(cfg, batch=2, seq=8)
    padded = t_kv.pad_cache(cfg, cache, 16)
    before = dict(t_layers.tree_items(cache))
    after = dict(t_layers.tree_items(padded))
    assert before.keys() == after.keys()
    names = set()
    for path, leaf in before.items():
        names.add(path[-1])
        if path[-1] in ("k", "v"):
            assert after[path].shape[-3] == 16
        else:
            assert after[path].shape == leaf.shape
    assert {"k", "v", "conv", "ssm"} <= names


def test_cache_bytes_count_the_constant_mamba_state():
    """Decode-state bytes at jamba's full width: the seven mamba layers'
    O(1) states plus one attention layer's kv, as the reference counts."""
    full = get_arch("jamba-v0.1-52b").config
    one = dataclasses.replace(full, n_layers=8)
    per_mamba = 4 * (full.ssm_d_conv - 1 + full.ssm_d_state) * full.d_inner
    for seq in (2080, 524_288):
        kv = 2 * seq * full.n_kv_heads * full.head_dim * 2
        assert t_kv.cache_bytes(one, 1, seq) == 7 * per_mamba + kv
        assert t_kv.cache_bytes(one, 2, seq) == j_kv.cache_bytes(
            dataclasses.replace(j_get_arch("jamba-v0.1-52b").config,
                                n_layers=8), 2, seq)


def test_extractor_rows_bitwise_under_chunks_and_tail():
    """MoE capacity couples the rows of a block; the source computes only
    in blocks aligned to absolute offsets, so a row's bits do not depend
    on the chunk size it is read with, a ragged tail block included."""
    _, tc, _, tp = _model("jamba-v0.1-52b")
    tokens = _tokens(tc, 7, 19, 9)
    ex = EmbeddingExtractor(tc, tp, batch_size=3, device="cpu")
    ref = EmbeddingSource(tokens, ex).materialize()
    for cs in (2, 5):
        rows = np.concatenate([c for _, c in
                               EmbeddingSource(tokens, ex).iter_chunks(cs)])
        np.testing.assert_array_equal(rows, ref)
    ids = np.array([6, 0, 4, 3])
    np.testing.assert_array_equal(EmbeddingSource(tokens, ex).gather(ids),
                                  ref[ids])


# ---------------------------------------------------- B10 at the new groups
def test_b10_takes_every_group_of_the_configs():
    """Every config's GQA group (full and smoke) is one B10 takes: the
    kernel's own instance, or slices of one (16 as two of 8, and
    command-r-plus-104b's 12 as three of 4)."""
    groups = {c.n_heads // c.n_kv_heads for a in ARCH_IDS
              for c in (get_arch(a).config, get_arch(a).smoke)
              if any(m.startswith("attn") for m, _ in c.period_pattern)}
    assert {5, 12, 16} <= groups <= set(t_dec_ops.GROUPS)
    for g in t_dec_ops.GROUPS:
        gl, ng = t_dec_ops.group_slices(g)
        assert gl in t_dec_ops.KERNEL_GROUPS and gl * ng == g
    assert t_dec_ops.group_slices(16) == (8, 2)
    assert t_dec_ops.group_slices(12) == (4, 3)
    assert t_dec_ops.group_slices(5) == (5, 1)


@pytest.mark.parametrize("g,quant,pos,window", [
    (5, False, 40, 0), (5, True, 150, 0), (16, False, 69, 0),
    (16, True, 100, 24), (12, False, 30, 0)])
def test_decode_plain_matches_ref_at_the_moe_groups(g, quant, pos, window):
    """The wrapper's plain version (a CPU tensor) at G 5, 12 and 16 against
    the reference's plain decode attention in f32: partial and wrapped
    rings, int8 caches, a window."""
    rng = np.random.default_rng(g + pos)
    d = 128
    q = rng.normal(size=(2, 2, g, d)).astype(np.float32)
    k = rng.normal(size=(2, 70, 2, d)).astype(np.float32)
    v = rng.normal(size=(2, 70, 2, d)).astype(np.float32)
    ks = vs = None
    if quant:
        ks = (np.abs(k).max(-1, keepdims=True) / 127.0).astype(np.float32)
        vs = (np.abs(v).max(-1, keepdims=True) / 127.0).astype(np.float32)
        k = np.clip(np.round(k / ks), -127, 127).astype(np.int8)
        v = np.clip(np.round(v / vs), -127, 127).astype(np.int8)
    scale = d ** -0.5
    got = t_dec_ops.decode_attention_fused(
        _t(q), _t(k), _t(v), pos, scale, None if ks is None else _t(ks),
        None if vs is None else _t(vs), window=window)
    want = j_decode_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        jnp.int32(pos), scale,
                        None if ks is None else jnp.asarray(ks),
                        None if vs is None else jnp.asarray(vs), window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
