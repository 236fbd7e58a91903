"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Marked ``gpu``: each test skips when no CUDA device is present (decided
inside the fixture, never at import).  On a machine with a card and the
CUDA toolkit run them with

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_cuda.py

The shapes are chosen for the kernels' edges rather than for speed: query
rows not a multiple of the 8-row tile, SV counts not a multiple of the
128/256-row tiles, feature widths not a multiple of the 16/32-wide shared
chunks, every column-count instantiation of the predict kernel (P = 1..64)
and banks wider than one 64-column block (P = 66, 130), and an empty SV
table; for the attention kernels T = 1, T and S off the 64-row tile, GQA
groups up to 8, head_dim 16 to 256, windows wider than T, S = 1, wrapped
ring caches and int8 caches; B1 and B3 at the SVM head's d = 2048; and
greedy generation at the smoke configs through the kernels against the
plain path.  This file imports no jax.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.kernel_matrix import ops as km_ops  # noqa: E402
from repro_torch.kernels.kernel_matrix import ref as km_ref  # noqa: E402
from repro_torch.kernels.svm_predict import ops as sp_ops  # noqa: E402
from repro_torch.kernels.svm_predict import ref as sp_ref  # noqa: E402

EPS = float(np.finfo(np.float32).eps)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _rand(gen, *shape, scale=1.0):
    return torch.randn(*shape, generator=gen) * scale


@pytest.mark.gpu
@pytest.mark.parametrize("b,n,m,d", [(1, 1, 1, 1), (3, 13, 300, 54),
                                     (2, 40, 129, 33), (5, 8, 2048, 7)])
def test_sq_dists_kernel_matches_plain(cuda, b, n, m, d):
    gen = torch.Generator().manual_seed(b * 1000 + n)
    x = _rand(gen, b, n, d, scale=3.0).to(cuda)
    z = _rand(gen, b, m, d, scale=3.0).to(cuda)
    before = km_ops.launches["sq_dists"]
    got = km_ops.sq_dists(x, z)
    want = km_ref.sq_dists_ref(x, z)
    torch.cuda.synchronize()
    assert km_ops.launches["sq_dists"] == before + 1
    scale = float((x * x).sum(-1).max() + (z * z).sum(-1).max())
    assert float((got - want).abs().max()) <= 64 * EPS * scale
    one = km_ops.sq_dists(x[0], z[0])                 # unbatched entry point
    assert torch.equal(one, got[0])


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["gauss_rbf", "laplacian"])
@pytest.mark.parametrize("din,dout", [("f32", "f32"), ("f32", "bf16"),
                                      ("bf16", "f32"), ("bf16", "bf16")])
def test_gram_from_d2_kernel_matches_plain(cuda, kind, din, dout):
    gen = torch.Generator().manual_seed(7)
    d2 = (torch.rand(3, 17, 301, generator=gen) * 20.0).to(cuda)
    if din == "bf16":
        d2 = d2.to(torch.bfloat16)
    ga = (torch.rand(3, 5, generator=gen) * 3.0 + 0.3).to(cuda)
    got = km_ops.gram_from_d2(d2, ga, kind=kind, out_dtype=dout)
    want = km_ref.gram_from_d2_ref(d2[:, None], ga[:, :, None, None], kind,
                                   dout)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and got.shape == (3, 5, 17, 301)
    tol = 2.0 ** -8 if dout == "bf16" else 8 * EPS
    assert float((got.float() - want.float()).abs().max()) <= tol
    one = km_ops.gram_from_d2(d2[1], float(ga[1, 2]), kind=kind,
                              out_dtype=dout)
    assert torch.equal(one, got[1, 2])


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["gauss_rbf", "laplacian"])
@pytest.mark.parametrize("c,m,k,d,p", [(4, 13, 300, 54, 1), (2, 8, 2048, 54, 7),
                                       (3, 21, 513, 17, 9), (2, 5, 100, 33, 17),
                                       (2, 3, 257, 70, 33), (1, 2, 64, 5, 64),
                                       (3, 11, 300, 54, 66),
                                       (2, 9, 130, 6, 130)])
def test_svm_predict_cells_kernel_matches_plain(cuda, kind, c, m, k, d, p):
    gen = torch.Generator().manual_seed(c * 100 + p)
    xt = _rand(gen, c, m, d).to(cuda)
    sv = _rand(gen, c, k, d).to(cuda)
    co = _rand(gen, c, k, p).to(cuda)
    co[:, k // 2:] = 0.0                                # zero-coefficient rows
    ga = (torch.rand(c, p, generator=gen) * 3.0 + 0.5).to(cuda) * (d ** 0.5)
    before = sp_ops.launches["svm_predict_cells"]
    got = sp_ops.svm_predict_cells(xt, sv, co, ga, kind=kind)
    want = sp_ref.svm_predict_cells_ref(xt, sv, co, ga, kind=kind)
    torch.cuda.synchronize()
    assert sp_ops.launches["svm_predict_cells"] == before + 1
    assert got.shape == (c, m, p)
    assert float((got - want).abs().max()) <= 1e-4 * max(
        1.0, float(want.abs().max()))


@pytest.mark.gpu
def test_svm_predict_cells_empty_sv_table_is_zero(cuda):
    xt = torch.ones(2, 8, 4, device=cuda)
    out = sp_ops.svm_predict_cells(xt, torch.ones(2, 0, 4, device=cuda),
                                   torch.ones(2, 0, 3, device=cuda),
                                   torch.ones(2, 3, device=cuda))
    assert out.shape == (2, 8, 3) and not out.any()


@pytest.mark.gpu
def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    x = torch.ones(2, 8, 4, device=cuda)
    with pytest.raises(ValueError):
        km_ops.sq_dists(x.transpose(1, 2).contiguous().transpose(1, 2), x)
    with pytest.raises(ValueError):
        km_ops.sq_dists(x, x.cpu())
    with pytest.raises(TypeError):
        sp_ops.svm_predict_cells(x, x, x.double(), torch.ones(2, 4, device=cuda))
    with pytest.raises(ValueError):                   # shared tiles overflow
        wide = torch.ones(1, 8, 60000, device=cuda)
        sp_ops.svm_predict_cells(wide, wide, torch.ones(1, 8, 2, device=cuda),
                                 torch.ones(1, 2, device=cuda))


# ------------------------------------------------ training slice: B1-sym, B4, B5
from repro_torch.kernels.cd_solver import ops as cd_ops  # noqa: E402
from repro_torch.kernels.cd_solver import ref as cd_ref  # noqa: E402


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 127, 129, 1824])
@pytest.mark.parametrize("d", [1, 54, 300])
def test_sq_dists_sym_kernel_is_symmetric_and_matches_plain(cuda, k, d):
    gen = torch.Generator().manual_seed(k * 7 + d)
    b = 3 if k < 1000 else 2
    x = _rand(gen, b, k, d, scale=2.0).to(cuda)
    before = km_ops.launches["sq_dists_sym"]
    got = km_ops.sq_dists(x, x, symmetric=True)
    want = km_ref.sq_dists_ref(x, x, symmetric=True)
    torch.cuda.synchronize()
    assert km_ops.launches["sq_dists_sym"] == before + 1
    assert got.shape == (b, k, k)
    # bitwise symmetric, diagonal tiles included
    assert torch.equal(got.view(torch.int32),
                       got.transpose(1, 2).contiguous().view(torch.int32))
    scale = float(2 * (x * x).sum(-1).max())
    assert float((got - want).abs().max()) <= 64 * EPS * scale
    one = km_ops.sq_dists(x[0], x[0], symmetric=True)     # unbatched
    assert torch.equal(one, got[0])


def _cd_problem(gen, s, f, n, p, pad):
    """A wave of hinge-like box QPs on PSD Grams, symmetric bitwise as the
    kernel requires; the last ``pad`` coordinates of each slot are padding
    (lo == hi == 0)."""
    x = torch.randn(s, n, 5, generator=gen)
    k = torch.exp(-km_ref.sq_dists_ref(x, x, symmetric=True) / 4.0)
    y = torch.sign(torch.randn(s, 1, n, 1, generator=gen)).expand(s, f, n, p)
    cost = torch.rand(s, f, 1, p, generator=gen) * 3.0 + 0.1
    lo = torch.clamp(y * cost, max=0.0).contiguous()
    hi = torch.clamp(y * cost, min=0.0).contiguous()
    if pad:
        lo[:, :, n - pad:] = 0.0
        hi[:, :, n - pad:] = 0.0
    c = torch.clamp(torch.randn(s, f, n, p, generator=gen), min=lo, max=hi)
    g = cd_ops.slot_matmul(k, c) - y
    return k, c, g.contiguous(), lo, hi


@pytest.mark.gpu
@pytest.mark.parametrize("s,f,n,p,pad", [(2, 3, 37, 1, 0), (3, 2, 129, 70, 9),
                                         (1, 1, 300, 130, 0),
                                         (2, 5, 201, 70, 17)])
def test_cd_wave_epoch_bitwise_equals_plain_sweep(cuda, s, f, n, p, pad):
    gen = torch.Generator().manual_seed(s * 1000 + n + p)
    k, c, g, lo, hi = (t.to(cuda) for t in _cd_problem(gen, s, f, n, p, pad))
    before = cd_ops.launches["cd_wave_epoch"]
    kc, kg = c, g
    pc, pg = c, g
    for _ in range(2):
        kc, kg = cd_ops.cd_wave_epoch(k, kc, kg, lo, hi)
        pc, pg = cd_ref.cd_wave_epoch_ref(k, pc, pg, lo, hi)
    torch.cuda.synchronize()
    assert cd_ops.launches["cd_wave_epoch"] == before + 2
    assert torch.equal(kc, pc) and torch.equal(kg, pg)
    if pad:
        assert not kc[:, :, n - pad:].any()
    # B5: each slot's first problem alone (the one-cell entry point) equals
    # its slot of the wave
    for si in range(s):
        b5_before = cd_ops.launches["cd_epoch"]
        oc, og = c[si, 0], g[si, 0]
        for _ in range(2):
            oc, og = cd_ops.cd_epoch(k[si], oc, og, lo[si, 0], hi[si, 0])
        torch.cuda.synchronize()
        assert cd_ops.launches["cd_epoch"] == b5_before + 2
        assert torch.equal(oc, kc[si, 0]) and torch.equal(og, kg[si, 0])


@pytest.mark.gpu
def test_cd_polish_runs_on_the_card_and_descends(cuda):
    gen = torch.Generator().manual_seed(3)
    k, c, g, lo, hi = (t.to(cuda) for t in _cd_problem(gen, 2, 3, 90, 7, 5))
    y = cd_ops.slot_matmul(k, c) - g
    before = cd_ops.launches["cd_wave_epoch"]
    out = cd_ops.cd_polish(k, y, lo, hi, c, epochs=3)
    torch.cuda.synchronize()
    assert cd_ops.launches["cd_wave_epoch"] == before + 3

    def obj(cc):
        return (0.5 * (cc * cd_ops.slot_matmul(k, cc)).sum((-2, -1))
                - (cc * y).sum((-2, -1)))
    assert bool((obj(out) <= obj(c) + 1e-4).all())


@pytest.mark.gpu
def test_tracer_spans_carry_device_time(cuda):
    from repro_torch.obs import Tracer
    tr = Tracer(enabled=True)
    a = torch.randn(1024, 1024, device=cuda)
    with tr.span("outer", cuda) as sp:
        sp.set(wave=0)
        with tr.span("inner", cuda):
            a @ a
    rows = tr.breakdown_ms("outer")
    assert rows[0]["attrs"] == {"wave": 0}
    inner = [s for s in tr.spans if s.name == "inner"][0]
    assert inner.events is not None
    assert 0.0 < rows[0]["inner"] <= rows[0]["outer"]


# --------------------------------------------- LM slice: B9, B10, d = 2048
from repro_torch.kernels.decode_attention import ops as dec_ops  # noqa: E402
from repro_torch.kernels.decode_attention import ref as dec_ref  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fa_ref  # noqa: E402


def _attn_tol(want: torch.Tensor) -> float:
    """f32: sums of <= S products in another order, 2e-5 on values ~1.
    bf16: the same, then one bf16 rounding of the output on each side,
    which may land one ulp (2^-7 relative) apart."""
    if want.dtype == torch.bfloat16:
        return 2.0 ** -7 * max(1.0, float(want.float().abs().max()))
    return 2e-5 * max(1.0, float(want.abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("mask_kind,window,b,t,s,h,hk,d", [
    ("causal", 0, 2, 1, 77, 4, 4, 64),        # T = 1 against a long S
    ("causal", 0, 1, 100, 100, 2, 2, 64),     # T not a multiple of 64
    ("causal", 0, 2, 70, 130, 8, 1, 128),     # GQA g = 8, T != S
    ("window", 300, 1, 90, 90, 4, 2, 256),    # window wider than T
    ("window", 40, 1, 200, 200, 2, 1, 256),   # tiles skipped left of band
    ("bidir", 0, 2, 33, 65, 4, 2, 16),        # smoke head_dim
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_matches_plain(cuda, mask_kind, window, b, t,
                                              s, h, hk, d, dtype):
    gen = torch.Generator().manual_seed(t * 31 + s + d)
    q, k, v = (_rand(gen, b, n, hh, d).to(cuda, dtype)
               for n, hh in ((t, h), (s, hk), (s, hk)))
    before = fa_ops.launches["flash_attention"]
    got = fa_ops.flash_attention(q, k, v, mask_kind, window)
    want = fa_ref.flash_attention_ref(q, k, v, mask_kind, window)
    torch.cuda.synchronize()
    assert fa_ops.launches["flash_attention"] == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    assert float((got.float() - want.float()).abs().max()) <= _attn_tol(want)


@pytest.mark.gpu
@pytest.mark.parametrize("s,pos,window,g,d,quant", [
    (1, 0, 0, 1, 64, False),                  # S = 1
    (333, 332, 0, 2, 64, True),               # int8, S off any tile, pos S-1
    (333, 666, 0, 1, 64, True),               # ring wrapped: pos = 2S
    (300, 120, 0, 8, 16, False),              # partial cache, G = 8
    (257, 500, 64, 2, 256, True),             # window by ring age
    (96, 95, 0, 4, 128, False),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_kernel_matches_plain(cuda, s, pos, window, g, d,
                                               quant, dtype):
    gen = torch.Generator().manual_seed(s * 7 + g + d)
    b, hk = 3, 2
    q = _rand(gen, b, hk, g, d).to(cuda, dtype)
    k = _rand(gen, b, s, hk, d)
    v = _rand(gen, b, s, hk, d)
    ks = vs = None
    if quant:
        ks = k.abs().amax(-1, keepdim=True).div(127.0).clamp(min=1e-10)
        vs = v.abs().amax(-1, keepdim=True).div(127.0).clamp(min=1e-10)
        k = torch.round(k / ks).clamp(-127, 127).to(torch.int8)
        v = torch.round(v / vs).clamp(-127, 127).to(torch.int8)
        ks, vs = ks.to(cuda), vs.to(cuda)
    else:
        k, v = k.to(dtype), v.to(dtype)
    k, v = k.to(cuda), v.to(cuda)
    before = dec_ops.launches["decode_attention"]
    got = dec_ops.decode_attention_fused(q, k, v, pos, d ** -0.5, ks, vs,
                                         window=window)
    want = dec_ref.decode_attention_ref(q, k, v, pos, d ** -0.5, ks, vs,
                                        window)
    torch.cuda.synchronize()
    assert dec_ops.launches["decode_attention"] == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    assert float((got.float() - want.float()).abs().max()) <= _attn_tol(want)


@pytest.mark.gpu
def test_attention_wrappers_reject_what_the_kernels_do_not_take(cuda):
    x = torch.ones(1, 4, 2, 32, device=cuda)
    with pytest.raises(ValueError):                   # head_dim 32
        fa_ops.flash_attention(x, x, x)
    q = torch.ones(1, 2, 3, 64, device=cuda)          # G = 3
    c = torch.ones(1, 8, 2, 64, device=cuda)
    with pytest.raises(ValueError):
        dec_ops.decode_attention_fused(q, c, c, 3, 0.125)
    with pytest.raises(ValueError):                   # int8 without scales
        dec_ops.decode_attention_fused(q[:, :, :1], c.to(torch.int8),
                                       c.to(torch.int8), 3, 0.125)


@pytest.mark.gpu
def test_sq_dists_and_predict_at_embedding_width(cuda):
    """The SVM head's features are d_model = 2048 wide (stablelm-1.6b)."""
    gen = torch.Generator().manual_seed(2048)
    x = _rand(gen, 2, 40, 2048).to(cuda)
    z = _rand(gen, 2, 300, 2048).to(cuda)
    got = km_ops.sq_dists(x, z)
    want = km_ref.sq_dists_ref(x, z)
    scale = float((x * x).sum(-1).max() + (z * z).sum(-1).max())
    assert float((got - want).abs().max()) <= 64 * EPS * scale
    co = _rand(gen, 2, 300, 7).to(cuda)
    ga = (torch.rand(2, 7, generator=gen) * 3.0 + 0.5).to(cuda) * 2048 ** 0.5
    for kind in ("gauss_rbf", "laplacian"):
        xs = x[:, :13].contiguous()
        got = sp_ops.svm_predict_cells(xs, z, co, ga, kind=kind)
        want = sp_ref.svm_predict_cells_ref(xs, z, co, ga, kind=kind)
        torch.cuda.synchronize()
        assert float((got - want).abs().max()) <= 1e-4 * max(
            1.0, float(want.abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["stablelm-1.6b", "gemma3-4b"])
@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_generate_through_kernels_equals_plain_path(cuda, arch, kv):
    """Smoke configs in f32: greedy tokens through B9/B10 equal the plain
    path's (attn_impl="ref") token for token."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.models import model as model_mod
    from repro_torch.serve import engine
    cfg = dataclasses.replace(get_arch(arch).smoke, dtype=torch.float32,
                              kv_cache_dtype=kv)
    params = model_mod.init_params(
        cfg, torch.Generator(device=cuda).manual_seed(0))
    prompt = torch.randint(0, cfg.vocab, (3, 9),
                           generator=torch.Generator().manual_seed(1)
                           ).to(cuda)
    n0 = (fa_ops.launches["flash_attention"],
          dec_ops.launches["decode_attention"])
    got = engine.generate(cfg, params, prompt, 12)
    n1 = (fa_ops.launches["flash_attention"],
          dec_ops.launches["decode_attention"])
    want = engine.generate(dataclasses.replace(cfg, attn_impl="ref"), params,
                           prompt, 12)
    assert (fa_ops.launches["flash_attention"],
            dec_ops.launches["decode_attention"]) == n1
    assert n1[0] - n0[0] == cfg.n_layers
    assert n1[1] - n0[1] == cfg.n_layers * 11
    assert torch.equal(got, want)
