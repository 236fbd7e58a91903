"""Every dense-attention family of the JAX package, in the port, on the CPU.

stablelm-12b (head_dim 160), hubert-xlarge (embed front end, bidirectional
``encode``, head_dim 80), internvl2-76b (embed front end) and
command-r-plus-104b (head_dim 8 at its smoke config) against the JAX
package at their smoke configs: the same numpy inputs, made from a seed,
and the same weights (``models.convert.params_from_reference``, bitwise).
On the CPU the port's kernel wrappers (B9, B10) run their plain versions;
the plain versions are also held against the reference's at the head dims
the full configs use (8, 80, 160), where the kernels take new paths on the
card.

Tolerances (as in ``test_torch_lm.py``, where they were measured):
f32 backbones, logits and pooled rows within 1e-5 of the largest |value|
(another GEMM and reduction order over a dozen ops); bf16 within 5e-2 (a
bf16 rounding on the other side of a tie moves a value one bf16 ulp that
later layers carry); the plain attention within 2e-5 absolute on values
~1 (f32 sums in another order); greedy tokens identical in f32.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as j_get_arch  # noqa: E402
from repro.embed import EmbeddingExtractor as JExtractor  # noqa: E402
from repro.kernels.decode_attention.ref import (  # noqa: E402
    decode_attention_ref as j_decode_ref)
from repro.kernels.flash_attention import ref as j_fa_ref  # noqa: E402
from repro.models import layers as j_layers  # noqa: E402
from repro.models import model as j_model  # noqa: E402
from repro.serve import engine as j_engine  # noqa: E402
from repro.serve import kv_cache as j_kv  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_arch  # noqa: E402
from repro_torch.embed import EmbeddingExtractor  # noqa: E402
from repro_torch.kernels.decode_attention import ops as t_dec_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ops as t_fa_ops  # noqa: E402
from repro_torch.models import layers as t_layers  # noqa: E402
from repro_torch.models import model as t_model  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.serve import EmbedServe, SVMEngine  # noqa: E402
from repro_torch.serve import engine as t_engine  # noqa: E402
from repro_torch.serve import kv_cache as t_kv  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """The shapes here are small: one intra-op thread runs them as fast as
    eight on an idle machine, and when the test workers (or other jobs)
    share the cores, eight threads a process spin against each other and
    run many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


FAMILIES = ("stablelm-12b", "hubert-xlarge", "internvl2-76b",
            "command-r-plus-104b")
EMBED = ("hubert-xlarge", "internvl2-76b")


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _close(got, want, rel: float) -> None:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"max abs err {err} > {rel} x {scale}"


_PARAMS: dict = {}


def _params(arch: str, dtype: str = "f32"):
    """The smoke config in both packages, JAX parameters from a seed and
    the port's copy of them."""
    if (arch, dtype) not in _PARAMS:
        jc, tc = j_get_arch(arch).smoke, get_arch(arch).smoke
        if dtype == "f32":
            jc = dataclasses.replace(jc, dtype=jnp.float32)
            tc = dataclasses.replace(tc, dtype=torch.float32)
        jp = j_layers.init_params(j_model.build_template(jc),
                                  jax.random.PRNGKey(0))
        _PARAMS[arch, dtype] = (jc, tc, jp,
                                params_from_reference(jax.device_get(jp)))
    return _PARAMS[arch, dtype]


def _inputs(cfg, b: int, t: int, seed: int) -> np.ndarray:
    """Token ids, or frame features for an embed front end."""
    rng = np.random.default_rng(seed)
    if cfg.input_kind == "tokens":
        return rng.integers(0, cfg.vocab, size=(b, t)).astype(np.int32)
    return rng.normal(size=(b, t, cfg.d_frontend)).astype(np.float32)


# ---------------------------------------------------------------- configs
@pytest.mark.parametrize("arch_id", FAMILIES)
def test_full_config_dims_match_assignment(arch_id):
    """The CONFIG carries the published dims, field for field the JAX
    package's, and the same parameter count."""
    expected = {
        "stablelm-12b": (40, 5120, 13824, 100352, 160),
        "command-r-plus-104b": (64, 12288, 33792, 256000, 128),
        "internvl2-76b": (80, 8192, 28672, 128256, 128),
        "hubert-xlarge": (48, 1280, 5120, 504, 80),
    }[arch_id]
    cfg = get_arch(arch_id).config
    assert arch_id in ARCH_IDS
    assert (cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab,
            cfg.head_dim) == expected
    assert cfg.n_periods * cfg.period + cfg.tail == cfg.n_layers
    for full in (True, False):
        j = j_get_arch(arch_id).config if full else j_get_arch(arch_id).smoke
        t = cfg if full else get_arch(arch_id).smoke
        for f in dataclasses.fields(t):
            if f.name != "dtype":
                assert getattr(t, f.name) == getattr(j, f.name), f.name
        assert t.param_count() == j.param_count()


@pytest.mark.parametrize("arch_id", FAMILIES)
def test_param_tree_keys_and_shapes_carry_across(arch_id):
    _, tc, _, tp = _params(arch_id)
    tmpl = t_model.build_template(tc)
    got = {p: tuple(v.shape) for p, v in t_layers.tree_items(tp)}
    assert got == {p: s.shape for p, s in t_layers.tree_items(tmpl)}
    assert ("frontend", "proj") in got if tc.input_kind == "embed" else \
        ("embed", "tok") in got


# --------------------------------------------------------------- backbone
@pytest.mark.parametrize("arch_id", FAMILIES)
def test_backbone_matches(arch_id):
    jc, tc, jp, tp = _params(arch_id)
    x = _inputs(tc, 3, 12, 0)
    pos = np.broadcast_to(np.arange(12, dtype=np.int32), (3, 12)).copy()
    hj, _, _ = jax.jit(j_model.backbone, static_argnums=0)(
        jc, jp, jnp.asarray(x), jnp.asarray(pos))
    ht, _, _ = t_model.backbone(tc, tp, _t(x), _t(pos))
    _close(_np(ht), np.asarray(hj, np.float32), 1e-5)


@pytest.mark.parametrize("arch_id,dtype,rel", [
    ("hubert-xlarge", "f32", 1e-5), ("hubert-xlarge", "bf16", 5e-2),
    ("internvl2-76b", "f32", 1e-5)])
def test_encode_matches(arch_id, dtype, rel):
    jc, tc, jp, tp = _params(arch_id, dtype)
    x = _inputs(tc, 2, 14, 1)
    want = jax.jit(j_model.encode, static_argnums=0)(jc, jp, jnp.asarray(x))
    got = t_model.encode(tc, tp, _t(x))
    assert got.dtype == torch.float32 and got.shape == (2, 14, tc.vocab)
    _close(got.numpy(), np.asarray(want), rel)


# ------------------------------------------------------- prefill / decode
@pytest.mark.parametrize("arch_id,kv", [("stablelm-12b", "bf16"),
                                        ("internvl2-76b", "int8"),
                                        ("command-r-plus-104b", "int8")])
def test_prefill_pad_decode_match(arch_id, kv):
    """prefill -> pad_cache -> three decode steps (frames of one position
    for the embed front end); logits within f32 noise."""
    jc, tc, jp, tp = _params(arch_id)
    jc = dataclasses.replace(jc, kv_cache_dtype=kv)
    tc = dataclasses.replace(tc, kv_cache_dtype=kv)
    x = _inputs(tc, 2, 11, 4)
    lj, cj = j_engine.prefill_step(jc, jp, jnp.asarray(x))
    lt, ct = t_model.prefill(tc, tp, _t(x))
    _close(lt.numpy(), lj, 1e-5)
    cj = j_kv.pad_cache(jc, cj, 16)
    ct = t_kv.pad_cache(tc, ct, 16)
    for step in range(3):
        tok = _inputs(tc, 2, 1, 10 + step)
        lj, cj = j_engine.serve_step(jc, jp, jnp.asarray(tok), cj,
                                     jnp.int32(11 + step))
        lt, ct = t_model.decode_step(tc, tp, _t(tok), ct, 11 + step)
        _close(lt.numpy(), lj, 1e-5)


@pytest.mark.parametrize("arch_id", ["stablelm-12b", "command-r-plus-104b"])
def test_generate_greedy_tokens_identical(arch_id):
    jc, tc, jp, tp = _params(arch_id)
    prompt = _inputs(tc, 2, 6, 5)
    want = j_engine.generate(jc, jp, jnp.asarray(prompt), 8)
    got = t_engine.generate(tc, tp, _t(prompt), 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------------------------ embed
@pytest.mark.parametrize("arch_id", EMBED)
@pytest.mark.parametrize("pooling", ["mean", "last"])
def test_extractor_rows_over_frames_match(arch_id, pooling):
    """(m, T, d_frontend) frames -> (m, d_model) pooled rows, a ragged tail
    block included; f32 noise, and bf16 noise on the bf16 backbone."""
    for dtype, rel in (("f32", 1e-5), ("bf16", 5e-2)):
        jc, tc, jp, tp = _params(arch_id, dtype)
        frames = _inputs(tc, 11, 9, 6)
        want = JExtractor(jc, jp, pooling=pooling, batch_size=4)(frames)
        got = EmbeddingExtractor(tc, tp, pooling=pooling, batch_size=4,
                                 device="cpu")(frames)
        assert got.shape == (11, tc.d_model) and got.dtype == np.float32
        _close(got, want, rel)


def test_extractor_refuses_tokens_for_an_embed_front_end():
    _, tc, _, tp = _params("hubert-xlarge")
    ex = EmbeddingExtractor(tc, tp, batch_size=4, device="cpu")
    with pytest.raises(ValueError):
        ex(np.zeros((2, 9), np.int32))
    with pytest.raises(ValueError):
        ex(np.zeros((2, 9, tc.d_frontend + 1), np.float32))


def test_embed_serve_takes_frames():
    """EmbedServe over hubert frames: the served decisions are the engine's
    on the extractor's rows."""
    from repro_torch.api.session import SVM
    from repro_torch.train.svm_trainer import SVMTrainerConfig
    _, tc, _, tp = _params("hubert-xlarge")
    ex = EmbeddingExtractor(tc, tp, batch_size=8, device="cpu")
    frames = _inputs(tc, 48, 9, 7)
    rows = ex(frames)
    y = np.where(rows[:, 0] > np.median(rows[:, 0]), 1, -1)
    sess = SVM(rows, y, config=SVMTrainerConfig(n_folds=2, max_iters=100,
                                                adaptivity_control=2),
               device="cpu")
    sess.train()
    eng = SVMEngine(sess.select("argmin").to_bank(), device="cpu")
    serve = EmbedServe(eng, ex)
    np.testing.assert_array_equal(serve.predict_tokens(frames[:10]),
                                  eng.predict(rows[:10]))
    ids = serve.submit_tokens(frames[10:15])
    assert len(ids) == 5


# ------------------------------------ plain B9 / B10 at the new head dims
@pytest.mark.parametrize("d", [8, 80, 160])
@pytest.mark.parametrize("mask_kind,window,t,s,h,hk", [
    ("causal", 0, 17, 33, 4, 1),      # GQA 4, T != S
    ("window", 9, 40, 40, 4, 2),
    ("bidir", 0, 21, 21, 2, 2),
])
def test_flash_attention_plain_matches_ref_at_new_head_dims(d, mask_kind,
                                                            window, t, s, h,
                                                            hk):
    rng = np.random.default_rng(d + t)
    q = rng.normal(size=(2, t, h, d)).astype(np.float32)
    k = rng.normal(size=(2, s, hk, d)).astype(np.float32)
    v = rng.normal(size=(2, s, hk, d)).astype(np.float32)
    got = t_fa_ops.flash_attention(_t(q), _t(k), _t(v), mask_kind, window)
    want = j_fa_ref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), mask_kind, window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


@pytest.mark.parametrize("d", [8, 80, 160])
@pytest.mark.parametrize("quant,pos,window,g", [
    (False, 60, 0, 4),                 # partial cache
    (True, 150, 0, 2),                 # int8, ring wrapped
    (False, 130, 24, 1),               # window, wrapped
])
def test_decode_plain_matches_ref_at_new_head_dims(d, quant, pos, window, g):
    rng = np.random.default_rng(d + pos)
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


def test_wrappers_take_the_new_head_dims():
    """The dims every configuration uses are the kernels' (a CUDA tensor
    at another dim raises); bf16 at D 8 runs the CUDA-core kernel."""
    dims = {get_arch(a).config.head_dim for a in ARCH_IDS} | {
        get_arch(a).smoke.head_dim for a in ARCH_IDS}
    assert dims <= set(t_fa_ops.HEAD_DIMS) == set(t_dec_ops.HEAD_DIMS)
    assert t_fa_ops.kernel_name(torch.bfloat16, 8) == "flash_fwd_kernel"
    assert t_fa_ops.kernel_name(torch.bfloat16, 160) == "flash_fwd_tc_kernel"
    assert t_fa_ops.kernel_name(torch.float32, 80) == "flash_fwd_kernel"
