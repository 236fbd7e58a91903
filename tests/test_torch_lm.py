"""The port's LM slice against the JAX package's, on the CPU.

Each test hands the same numpy inputs, made from a seed, to the JAX
function and its counterpart in ``repro_torch``.  On the CPU the port's
kernel wrappers (flash attention B9, fused decode B10) run their plain
PyTorch versions; the JAX side runs its Pallas kernels in interpret mode
(``force_pallas=True``, as its own tests do) and its jnp references.
Weights cross with ``models.convert.params_from_reference`` (bitwise).

Tolerances and where they come from (smoke configs, seed 0):

* attention in f32: the port materialises the softmax, Pallas runs it
  online over 128-row tiles: f32 rounding of sums over <= 64 terms of
  values ~1, 2e-5 absolute (measured <= 7.2e-7).  int8 caches: the same,
  the dequantised values are equal on both sides.
* layers and the backbone in f32: another GEMM and reduction order, a few
  ulps per op over a dozen ops: 1e-5 of the largest |value| (measured
  <= 7.7e-7 relative).  bf16: every projection rounds to bf16 (2^-8
  relative), and a rounding that lands on the other side of a tie moves a
  value by one bf16 ulp that later layers carry: 5e-2 of the largest
  |value| (measured 1.45e-2 on the backbone, 8.3e-3 on pooled rows).
* greedy tokens in f32 must be identical: a flip would need two logits
  within ~1e-6 of each other (the f32 noise), and none is at these seeds.
* pooled embeddings: the same backbone noise, plus a mean over T in
  another order (f32 measured <= 5.6e-7 relative).
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as j_get_arch  # noqa: E402
from repro.configs import ARCH_IDS as J_ARCH_IDS  # noqa: E402
from repro.embed import EmbeddingExtractor as JExtractor  # noqa: E402
from repro.embed import params_digest as j_params_digest  # noqa: E402
from repro.kernels.decode_attention.ops import (  # noqa: E402
    decode_attention_fused as j_decode_fused)
from repro.kernels.decode_attention.ref import (  # noqa: E402
    decode_attention_ref as j_decode_ref)
from repro.kernels.flash_attention import ref as j_fa_ref  # noqa: E402
from repro.kernels.flash_attention.ops import (  # noqa: E402
    flash_attention as j_flash)
from repro.models import layers as j_layers  # noqa: E402
from repro.models import model as j_model  # noqa: E402
from repro.serve import engine as j_engine  # noqa: E402
from repro.serve import kv_cache as j_kv  # noqa: E402
from repro_torch.api.session import SVM  # noqa: E402
from repro_torch.configs import get_arch as t_get_arch  # noqa: E402
from repro_torch.configs import ARCH_IDS as T_ARCH_IDS  # noqa: E402
from repro_torch.embed import (EmbeddingExtractor, EmbeddingSource,  # noqa: E402
                               LabeledSource, embed_source, params_digest)
from repro_torch.embed.source import EmbedCache, EmbedCacheError  # noqa: E402
from repro_torch.kernels.decode_attention import ops as t_dec_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ops as t_fa_ops  # noqa: E402
from repro_torch.models import layers as t_layers  # noqa: E402
from repro_torch.models import model as t_model  # noqa: E402
from repro_torch.models.convert import (cache_from_reference,  # noqa: E402
                                        params_from_reference)
from repro_torch.pipeline.dataset import DataSourceError  # noqa: E402
from repro_torch.serve import EmbedServe, SVMEngine  # noqa: E402
from repro_torch.serve import engine as t_engine  # noqa: E402
from repro_torch.serve import kv_cache as t_kv  # noqa: E402
from repro_torch.train.svm_trainer import SVMTrainerConfig  # noqa: E402

ARCHS = ("stablelm-1.6b", "gemma3-4b")
SEQ, B = 10, 16


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy array; bf16 widens to f32 (exactly)."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _close(got, want, rel: float) -> None:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"max abs err {err} > {rel} x {scale}"


def _configs(arch: str, dtype: str):
    j = j_get_arch(arch).smoke
    t = t_get_arch(arch).smoke
    if dtype == "f32":
        j = dataclasses.replace(j, dtype=jnp.float32)
        t = dataclasses.replace(t, dtype=torch.float32)
    return j, t


_PARAMS: dict = {}


def _params(arch: str, dtype: str = "f32"):
    """JAX parameters of the smoke config and the port's copy of them."""
    if (arch, dtype) not in _PARAMS:
        jc, tc = _configs(arch, dtype)
        jp = j_layers.init_params(j_model.build_template(jc),
                                  jax.random.PRNGKey(0))
        _PARAMS[arch, dtype] = (jc, tc, jp,
                                params_from_reference(jax.device_get(jp)))
    return _PARAMS[arch, dtype]


# ------------------------------------------------------ B9: flash attention
@pytest.mark.parametrize("mask_kind,window,t,s,h,hk", [
    ("causal", 0, 40, 40, 4, 4),
    ("causal", 0, 24, 56, 4, 2),         # T != S, GQA 2
    ("window", 9, 40, 40, 4, 1),         # GQA 4
    ("window", 7, 17, 33, 2, 2),         # ragged T != S
    ("bidir", 0, 31, 45, 4, 2),
])
def test_flash_attention_plain_matches_pallas_and_ref(mask_kind, window, t,
                                                      s, h, hk):
    rng = np.random.default_rng(8)
    q = rng.normal(size=(2, t, h, 16)).astype(np.float32)
    k = rng.normal(size=(2, s, hk, 16)).astype(np.float32)
    v = rng.normal(size=(2, s, hk, 16)).astype(np.float32)
    got = t_fa_ops.flash_attention(_t(q), _t(k), _t(v), mask_kind, window)
    pallas = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     mask_kind=mask_kind, window=window, force_pallas=True)
    ref = j_fa_ref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), mask_kind, window)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), atol=2e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5)


def test_flash_attention_bf16_output_dtype_and_ref():
    rng = np.random.default_rng(9)
    q, k, v = (rng.normal(size=(1, 20, 2, 16)).astype(np.float32)
               for _ in range(3))
    got = t_fa_ops.flash_attention(_t(q).bfloat16(), _t(k).bfloat16(),
                                   _t(v).bfloat16())
    assert got.dtype == torch.bfloat16
    want = j_fa_ref.flash_attention_ref(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
        jnp.asarray(v, jnp.bfloat16), "causal", 0)
    # same bf16 inputs, f32 math, one bf16 rounding of the output each
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=2 ** -7)


def test_kernel_wrappers_raise_off_cpu_and_count_nothing_here():
    """A tensor that is not on the CPU goes to the kernel or raises (meta
    tensors raise); the plain path launches nothing."""
    q = torch.empty((1, 4, 2, 64), device="meta")
    with pytest.raises(ValueError):
        t_fa_ops.flash_attention(q, q, q)
    with pytest.raises(ValueError):
        t_dec_ops.decode_attention_fused(torch.empty((1, 2, 1, 64),
                                                     device="meta"),
                                         q, q, 3, 0.125)
    x = torch.zeros((1, 4, 2, 16))
    before = (t_fa_ops.launches["flash_attention"],
              t_dec_ops.launches["decode_attention"])
    t_fa_ops.flash_attention(x, x, x)
    t_dec_ops.decode_attention_fused(torch.zeros((1, 2, 1, 16)), x, x, 3,
                                     0.25)
    assert (t_fa_ops.launches["flash_attention"],
            t_dec_ops.launches["decode_attention"]) == before


# --------------------------------------------------------- B10: decode
def _decode_inputs(b, hk, g, d, s, quantize, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, hk, g, d)).astype(np.float32)
    k = rng.normal(size=(b, s, hk, d)).astype(np.float32)
    v = rng.normal(size=(b, s, hk, d)).astype(np.float32)
    ks = vs = None
    if quantize:
        ks = (np.abs(k).max(-1, keepdims=True) / 127.0).astype(np.float32)
        vs = (np.abs(v).max(-1, keepdims=True) / 127.0).astype(np.float32)
        k = np.clip(np.round(k / ks), -127, 127).astype(np.int8)
        v = np.clip(np.round(v / vs), -127, 127).astype(np.int8)
    return q, k, v, ks, vs


@pytest.mark.parametrize("case,quantize,pos,window,g", [
    ("full", False, 299, 0, 2),
    ("full_int8", True, 299, 0, 4),
    ("partial", False, 100, 0, 1),
    ("partial_int8", True, 57, 0, 2),
    ("ring_wrap", False, 613, 0, 2),      # pos >= S: every slot valid
    ("window", False, 200, 64, 2),
    ("window_wrap_int8", True, 350, 40, 1),
])
def test_decode_plain_matches_pallas_and_ref(case, quantize, pos, window, g):
    q, k, v, ks, vs = _decode_inputs(2, 2, g, 32, 300, quantize)
    scale = 32 ** -0.5
    tt = [_t(a) if a is not None else None for a in (q, k, v, ks, vs)]
    got = t_dec_ops.decode_attention_fused(tt[0], tt[1], tt[2], pos, scale,
                                           tt[3], tt[4], window=window)
    jj = [jnp.asarray(a) if a is not None else None for a in (q, k, v, ks, vs)]
    pallas = j_decode_fused(jj[0], jj[1], jj[2], jnp.int32(pos), scale,
                            k_scale=jj[3], v_scale=jj[4], window=window,
                            force_pallas=True)
    ref = j_decode_ref(jj[0], jj[1], jj[2], jnp.int32(pos), scale, jj[3],
                       jj[4], window)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), atol=2e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5)


def test_decode_bf16_cache():
    q, k, v, _, _ = _decode_inputs(1, 2, 2, 32, 64, False, seed=3)
    qb, kb, vb = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want = j_decode_ref(qb, kb, vb, jnp.int32(40), 0.25)
    got = t_dec_ops.decode_attention_fused(
        *(params_from_reference({"x": np.asarray(a)})["x"]
          for a in (qb, kb, vb)), 40, 0.25)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(to_numpy(got), np.asarray(want, np.float32),
                               atol=2 ** -7)


# ----------------------------------------------------------------- layers
@pytest.mark.parametrize("frac", [0.25, 1.0])
def test_rope_matches(frac):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 7, 3, 16)).astype(np.float32)
    pos = np.broadcast_to(np.arange(3, 10, dtype=np.int32), (2, 7)).copy()
    want = j_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0,
                               frac)
    got = t_layers.apply_rope(_t(x), _t(pos), 10000.0, frac)
    _close(got.numpy(), want, 1e-6)


def test_norms_and_glu_mlp_match():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, 5, 32)).astype(np.float32)
    w = rng.normal(size=(32,)).astype(np.float32)
    bb = rng.normal(size=(32,)).astype(np.float32)
    _close(t_layers.rms_norm(_t(x), _t(w)).numpy(),
           j_layers.rms_norm(jnp.asarray(x), jnp.asarray(w)), 1e-6)
    _close(t_layers.layer_norm(_t(x), _t(w), _t(bb)).numpy(),
           j_layers.layer_norm(jnp.asarray(x), jnp.asarray(w),
                               jnp.asarray(bb)), 1e-6)
    p = {n: rng.normal(size=sh).astype(np.float32) * 0.2
         for n, sh in (("wi", (32, 48)), ("wg", (32, 48)), ("wo", (48, 32)))}
    for act in ("silu", "gelu"):
        want = j_layers.glu_mlp({n: jnp.asarray(a) for n, a in p.items()},
                                jnp.asarray(x), act, jnp.float32)
        got = t_layers.glu_mlp({n: _t(a) for n, a in p.items()}, _t(x), act,
                               torch.float32)
        _close(got.numpy(), want, 1e-5)


def test_param_tree_keys_shapes_and_bf16_bits_carry_across():
    jc, tc, jp, tp = _params("gemma3-4b", "bf16")
    tmpl = t_model.build_template(tc)
    got = {p: (tuple(v.shape), v.dtype) for p, v in t_layers.tree_items(tp)}
    want = {p: (s.shape, s.dtype) for p, s in t_layers.tree_items(tmpl)}
    assert got == want
    leaf = np.asarray(jp["stack"]["pos0"]["mixer"]["wq"])
    assert leaf.dtype.name == "bfloat16"
    back = tp["stack"]["pos0"]["mixer"]["wq"].view(torch.int16).numpy()
    np.testing.assert_array_equal(back, leaf.view(np.int16))
    assert tc.param_count() == jc.param_count()


@pytest.mark.parametrize("arch", J_ARCH_IDS)
def test_every_reference_arch_resolves(arch):
    """Each of the JAX package's ten arch ids resolves through the port's
    registry to its config and smoke config; an unknown id raises
    KeyError."""
    spec = t_get_arch(arch)
    assert spec.arch_id == arch and arch in T_ARCH_IDS
    assert spec.config.name == j_get_arch(arch).config.name
    assert spec.smoke.name == j_get_arch(arch).smoke.name
    assert len(T_ARCH_IDS) == len(J_ARCH_IDS) == 10
    with pytest.raises(KeyError):
        t_get_arch(arch + "-unknown")


# ---------------------------------------------------------------- backbone
@pytest.mark.parametrize("arch,dtype,rel", [
    ("stablelm-1.6b", "f32", 1e-5), ("gemma3-4b", "f32", 1e-5),
    ("gemma3-4b", "bf16", 5e-2)])
def test_backbone_matches(arch, dtype, rel):
    jc, tc, jp, tp = _params(arch, dtype)
    x = np.random.default_rng(0).integers(0, jc.vocab, size=(3, 12)
                                          ).astype(np.int32)
    pos = np.broadcast_to(np.arange(12, dtype=np.int32), (3, 12)).copy()
    hj, _, _ = jax.jit(j_model.backbone, static_argnums=0)(
        jc, jp, jnp.asarray(x), jnp.asarray(pos))
    ht, _, _ = t_model.backbone(tc, tp, _t(x), _t(pos))
    _close(to_numpy(ht), np.asarray(hj, np.float32), rel)


@pytest.mark.parametrize("arch,kv", [("stablelm-1.6b", "bf16"),
                                     ("gemma3-4b", "int8")])
def test_prefill_pad_decode_match(arch, kv):
    """prefill -> pad_cache -> three decode steps; logits and caches.  The
    JAX side runs its jitted serving steps (one compile for the steps)."""
    jc, tc, jp, tp = _params(arch, "f32")
    jc = dataclasses.replace(jc, kv_cache_dtype=kv)
    tc = dataclasses.replace(tc, kv_cache_dtype=kv)
    rng = np.random.default_rng(4)
    x = rng.integers(0, jc.vocab, size=(2, 11)).astype(np.int32)
    lj, cj = j_engine.prefill_step(jc, jp, jnp.asarray(x))
    lt, ct = t_model.prefill(tc, tp, _t(x))
    _close(lt.numpy(), lj, 1e-5)
    cj = j_kv.pad_cache(jc, cj, 20)      # window 8 < 20: the ring matters
    ct = t_kv.pad_cache(tc, ct, 20)
    for step in range(3):
        tok = rng.integers(0, jc.vocab, size=(2, 1)).astype(np.int32)
        lj, cj = j_engine.serve_step(jc, jp, jnp.asarray(tok), cj,
                                     jnp.int32(11 + step))
        lt, ct = t_model.decode_step(tc, tp, _t(tok), ct, 11 + step)
        _close(lt.numpy(), lj, 1e-5)
    want = cache_from_reference(jax.device_get(cj))
    for path, leaf in t_layers.tree_items(ct):
        ref = want
        for k in path:
            ref = ref[k]
        assert leaf.dtype == ref.dtype and leaf.shape == ref.shape, path
        if leaf.dtype == torch.int8:   # one rounding step on a tie at most
            assert (leaf.int() - ref.int()).abs().max() <= 1, path
        else:
            _close(to_numpy(leaf), to_numpy(ref), 1e-5)
    assert t_kv.cache_bytes(tc, 2, 20) == j_kv.cache_bytes(jc, 2, 20)


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_greedy_tokens_identical(arch):
    jc, tc, jp, tp = _params(arch, "f32")
    prompt = np.random.default_rng(5).integers(0, jc.vocab, size=(2, 6)
                                               ).astype(np.int32)
    want = j_engine.generate(jc, jp, jnp.asarray(prompt), 8)
    got = t_engine.generate(tc, tp, _t(prompt), 8)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_generate_eos_and_sampling():
    _, tc, _, tp = _params("stablelm-1.6b", "f32")
    prompt = _t(np.random.default_rng(6).integers(0, tc.vocab, size=(2, 5)))
    greedy = t_engine.generate(tc, tp, prompt, 6)
    eos = int(greedy[0, 6])              # row 0 hits eos at its 2nd token
    out = t_engine.generate(tc, tp, prompt, 6, eos_id=eos)
    assert out.shape == (2, 11)
    assert (out[0, 6:] == eos).all()
    a = t_engine.generate(tc, tp, prompt, 6, temperature=1.0,
                          generator=torch.Generator().manual_seed(3))
    b = t_engine.generate(tc, tp, prompt, 6, temperature=1.0,
                          generator=torch.Generator().manual_seed(3))
    assert torch.equal(a, b) and a.shape == (2, 11)
    with pytest.raises(ValueError, match="Generator"):
        t_engine.generate(tc, tp, prompt, 2, temperature=1.0)


# ------------------------------------------------------------------ embed
@pytest.fixture(scope="module")
def smoke():
    """The bf16 stablelm smoke backbone of ``tests/test_embed.py`` in both
    packages, with the same weights, and a 103-sequence corpus."""
    jc, tc, jp, tp = _params("stablelm-1.6b", "bf16")
    tokens = np.random.default_rng(0).integers(
        0, tc.vocab, size=(103, SEQ)).astype(np.int32)
    ex = EmbeddingExtractor(tc, tp, batch_size=B, device="cpu")
    return jc, tc, jp, tp, tokens, ex


@pytest.mark.parametrize("pooling", ["mean", "last"])
def test_extractor_pooled_embeddings_match(smoke, pooling):
    jc, tc, jp, tp, tokens, _ = smoke
    # f32 backbone: the pooling and the block logic, at f32 noise
    jc32, tc32, jp32, tp32 = _params("stablelm-1.6b", "f32")
    want = JExtractor(jc32, jp32, pooling=pooling, batch_size=B)(tokens[:20])
    got = EmbeddingExtractor(tc32, tp32, pooling=pooling, batch_size=B,
                             device="cpu")(tokens[:20])
    assert got.shape == (20, tc.d_model) and got.dtype == np.float32
    _close(got, want, 1e-5)
    # the bf16 backbone the JAX embed tests run: bf16 noise
    want = JExtractor(jc, jp, pooling=pooling, batch_size=B)(tokens[:20])
    got = EmbeddingExtractor(tc, tp, pooling=pooling, batch_size=B,
                             device="cpu")(tokens[:20])
    _close(got, want, 5e-2)


def test_params_digest_equal_across_packages(smoke):
    jc, tc, jp, tp, _, ex = smoke
    assert params_digest(tp) == j_params_digest(jp)
    assert ex.digest() == j_params_digest(jp)
    flipped = dict(reversed(list(tp.items())))
    assert params_digest(flipped) == params_digest(tp)


def test_rows_bitwise_invariant_to_block_company_and_chunk_size(smoke):
    """A row's embedding is the same bits whether its block is full or a
    zero-padded tail, and whatever chunk size the source is read with."""
    _, _, _, _, tokens, ex = smoke
    full = ex(tokens[:B])
    for m in (1, 5, 11):
        np.testing.assert_array_equal(ex(tokens[:m]), full[:m])
    ref = EmbeddingSource(tokens, ex).materialize()
    for cs in (7, 16, 50):
        src = EmbeddingSource(tokens, ex)
        rows = np.concatenate([c for _, c in src.iter_chunks(cs)])
        np.testing.assert_array_equal(rows, ref)
    ids = np.asarray([102, 0, 17, 17, 64])
    np.testing.assert_array_equal(EmbeddingSource(tokens, ex).gather(ids),
                                  ref[ids])


def test_fingerprint_sensitivity(smoke):
    _, tc, _, _, _, ex = smoke
    fp = ex.fingerprint(SEQ)
    assert ex.fingerprint(SEQ) == fp and ex.fingerprint(SEQ + 1) != fp
    other = EmbeddingExtractor(tc, pooling="last", batch_size=B, seed=0,
                               device="cpu")
    seeded = EmbeddingExtractor(tc, batch_size=B, seed=0, device="cpu")
    assert other.fingerprint(SEQ) != seeded.fingerprint(SEQ)
    assert EmbeddingExtractor(tc, batch_size=B, seed=1, device="cpu"
                              ).fingerprint(SEQ) != seeded.fingerprint(SEQ)
    assert EmbeddingExtractor(tc, batch_size=2 * B, seed=0, device="cpu"
                              ).fingerprint(SEQ) == seeded.fingerprint(SEQ)


# ------------------------------------------ EmbedCache (test_embed.py cases)
class TestEmbedCache:
    def test_write_through_seals_and_replays(self, smoke, tmp_path):
        _, _, _, _, tokens, ex = smoke
        src = EmbeddingSource(tokens, ex, cache=str(tmp_path))
        assert not src.cache_complete()
        cold = src.materialize()
        assert src.cache_complete()
        warm = EmbeddingSource(tokens, ex, cache=str(tmp_path))
        assert warm.cache_complete()
        np.testing.assert_array_equal(warm.materialize(), cold)
        names = os.listdir(src.cache.path)
        assert "meta.json" in names and not [n for n in names
                                             if ".tmp." in n]

    def test_partial_cache_resumes_not_recomputes(self, smoke, tmp_path):
        _, _, _, _, tokens, ex = smoke
        s1 = EmbeddingSource(tokens, ex, cache=str(tmp_path))
        next(iter(s1.iter_chunks(B)))
        shard0 = os.path.join(s1.cache.path, "shard_00000.npz")
        before = open(shard0, "rb").read()
        s2 = EmbeddingSource(tokens, ex, cache=str(tmp_path))
        full = s2.materialize()
        assert s2.cache_complete()
        assert open(shard0, "rb").read() == before
        np.testing.assert_array_equal(
            full, EmbeddingSource(tokens, ex).materialize())

    def test_fingerprint_and_geometry_mismatch_raise(self, smoke, tmp_path):
        _, tc, _, _, tokens, ex = smoke
        EmbeddingSource(tokens, ex, cache=str(tmp_path)).materialize()
        other = EmbeddingExtractor(tc, batch_size=B, seed=7, device="cpu")
        fp_dir = os.path.join(str(tmp_path), ex.fingerprint(SEQ)[:12])
        with pytest.raises(EmbedCacheError, match="identity"):
            EmbedCache(fp_dir, other.fingerprint(SEQ), n_rows=103,
                       dim=ex.dim, block=B, seq_len=SEQ)
        assert not EmbeddingSource(tokens, other,
                                   cache=str(tmp_path)).cache_complete()
        cache = EmbedCache(str(tmp_path / "c"), ex.fingerprint(SEQ),
                           n_rows=50, dim=ex.dim, block=B, seq_len=SEQ)
        with pytest.raises(EmbedCacheError, match="geometry"):
            EmbeddingSource(tokens, ex, cache=cache)

    def test_corrupt_shard_names_file_and_rows(self, smoke, tmp_path):
        _, _, _, _, tokens, ex = smoke
        src = EmbeddingSource(tokens, ex, cache=str(tmp_path))
        src.materialize()
        shard1 = os.path.join(src.cache.path, "shard_00001.npz")
        with open(shard1, "wb") as f:
            f.write(b"not a zip")
        fresh = EmbedCache(src.cache.path, ex.fingerprint(SEQ), n_rows=103,
                           dim=ex.dim, block=B, seq_len=SEQ)
        with pytest.raises(DataSourceError, match=r"shard_00001\.npz"):
            fresh.get(1)

    def test_pad_rows_never_surface(self, smoke):
        _, _, _, _, tokens, ex = smoke
        src = EmbeddingSource(tokens, ex)
        assert sum(c.shape[0] for _, c in src.iter_chunks(9)) == 103
        pad = ex(np.zeros((1, SEQ), np.int32))[0]
        assert not np.array_equal(src.gather(np.arange(96, 103))[-1], pad)


def test_embed_source_front_door(smoke, tmp_path):
    _, tc, _, tp, tokens, _ = smoke
    src = embed_source(tokens, arch="stablelm-1.6b:smoke", batch_size=16,
                       cache_dir=str(tmp_path), params=tp, device="cpu")
    assert isinstance(src, EmbeddingSource) and src.dim == tc.d_model
    src.materialize()
    assert embed_source(tokens, arch="stablelm-1.6b:smoke", batch_size=16,
                        cache_dir=str(tmp_path), params=tp,
                        device="cpu").cache_complete()


# ----------------------------------------------------- labels and sessions
def test_labeled_source_pairs_and_streams(tmp_path):
    x = np.random.default_rng(2).normal(size=(57, 4)).astype(np.float32)
    y = np.where(np.random.default_rng(3).random(57) > .5, 1., -1.)
    paths = []
    for i, (lo, hi) in enumerate([(0, 20), (20, 21), (21, 57)]):
        p = tmp_path / f"y{i}.npz"
        np.savez(p, y=y[lo:hi])
        paths.append(str(p))
    ls = LabeledSource(x, paths)
    np.testing.assert_array_equal(ls.labels_vector(), y.astype(np.float32))
    ids = np.asarray([56, 0, 20, 20, 33])
    np.testing.assert_array_equal(ls.gather_labels(ids),
                                  y[ids].astype(np.float32))
    with pytest.raises(DataSourceError, match="mismatch"):
        LabeledSource(x, np.zeros(9))


SVM_CFG = SVMTrainerConfig(scenario="binary", n_folds=2, max_iters=60,
                           cell_method="voronoi", cell_size=60)


@pytest.fixture(scope="module")
def served(smoke):
    """SVM(y=None) over a label-carrying EmbeddingSource, to a bank."""
    _, _, _, _, tokens, ex = smoke
    y = np.where(np.random.default_rng(7).random(103) > .5, 1., -1.
                 ).astype(np.float32)
    src = EmbeddingSource(tokens, ex, labels=y)
    sel = SVM(src, None, SVM_CFG, device="cpu").train().select()
    res = sel.test(EmbeddingSource(tokens, ex), y)
    return sel, res, EmbedServe(SVMEngine(sel.to_bank(), device="cpu"), ex)


def test_svm_takes_labels_from_the_source(served):
    sel, res, _ = served
    assert 0.0 <= res.error <= 1.0 and res.n == 103
    with pytest.raises(ValueError, match="label-carrying"):
        SVM(np.zeros((20, 3), np.float32), None, SVM_CFG,
            device="cpu").train()


def test_unlabeled_embedding_source_raises(smoke):
    _, _, _, _, tokens, ex = smoke
    with pytest.raises(DataSourceError, match="no labels"):
        EmbeddingSource(tokens, ex).labels_vector()


def test_embed_serve_breakdowns_sum_exactly(served, smoke):
    _, _, srv = served
    tokens, ex = smoke[4], smoke[5]
    ids = srv.submit_tokens(tokens[:9])
    while srv.pending:
        srv.step()
    for rid in ids:
        b = srv.breakdown(int(rid))
        assert b["embed_ms"] > 0.0
        parts = (b["embed_ms"] + b["queue_ms"] + b["pack_ms"]
                 + b["dispatch_ms"] + b["device_ms"] + b["collect_ms"])
        assert parts == pytest.approx(b["total_ms"], abs=1e-6)
    st = srv.stats()
    assert st["per_stage"]["embed"]["count"] >= 1
    emb = ex(tokens[9:12])
    rid = srv.submit(emb)
    while srv.pending:
        srv.step()
    assert srv.breakdown(int(rid[0]))["embed_ms"] == 0.0
    results = srv.run_tokens(tokens[i:i + 8] for i in range(12, 60, 8))
    assert len(results) == 48


def test_embed_serve_predict_tokens_equals_engine(served, smoke):
    _, _, srv = served
    tokens, ex = smoke[4], smoke[5]
    want = srv.engine.predict(ex(tokens[:5]))
    np.testing.assert_array_equal(srv.predict_tokens(tokens[:5]), want)

    class Narrow:
        dim = 3
    with pytest.raises(ValueError, match="d=3"):
        EmbedServe(srv.engine, Narrow())
