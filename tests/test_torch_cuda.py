"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Marked ``gpu``: each test skips when no CUDA device is present (decided
inside the fixture, never at import).  On a machine with a card and the
CUDA toolkit run them with

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_cuda.py

The shapes are chosen for the kernels' edges rather than for speed: query
rows not a multiple of the 8-row tile, SV counts not a multiple of the
128-row tile, feature widths off the copy widths and wider than one
64-feature chunk, every column-count instantiation of the predict kernel
(P = 1..64) and banks wider than one 64-column block (P = 66, 130), slots
too few to fill the card (the SV axis split, k d odd), each case twice
for bitwise equal outputs, and an empty SV table; for the attention
kernels T = 1, T and S off the 64-row tile, GQA groups up to 8,
head_dim 16 to 256, windows wider than T, S = 1, wrapped ring caches and
int8 caches; B10 also through its split over the keys (B =
1 at S = 32768, gemma3-4b's local layers with a window over a wrapped
ring), with two and four kv heads a block and on its direct path, each
case twice for bitwise equal outputs, and a misaligned cache refused; the
Gauss-Seidel epoch (B4, B5) bitwise where n is off and below its
32-coordinate panel, with 8-column blocks and with 8 rows a thread; B9's
bf16 kernel over 16 kv tiles (its TMA ring wraps) and at gemma3-4b's local
layers (D = 256, window 1024), and a misaligned view refused; B2 with one
gamma per row bitwise equal to its plain version where rows straddle
16-byte chunks (N % 8 = 1, 7) and where they do not; B1 and B3 at the SVM head's d = 2048;
greedy generation at the smoke configs through the kernels against the
plain path; for the nearest-center kernel (B6) a center table larger than
shared memory, tables just under and over the resident limit, C and d off
every tile, d odd, duplicated centers, one row and one center; for the
one-shot Gram (B7) and the one-cell predict (B8) one row, SV counts off
the tile and P = 1.  This file imports no jax.
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
@pytest.mark.parametrize("din", ["bf16", "f32"])
@pytest.mark.parametrize("dout", ["f32", "bf16"])
@pytest.mark.parametrize("b,n,m", [(4, 3, 67), (3, 1, 263), (2, 16, 512)])
def test_gram_from_d2_ragged_rows_bitwise(cuda, kind, din, dout, b, n, m):
    """One gamma per row (the CV gamma step) with N = n m off the 16-byte
    chunk (N % 8 = 1 and 7: chunks straddle two rows) and on it: the
    kernel's bits are the plain version's."""
    gen = torch.Generator().manual_seed(n * m)
    d2 = (torch.rand(b, n, m, generator=gen) * 20.0).to(cuda)
    if din == "bf16":
        d2 = d2.to(torch.bfloat16)
    ga = (torch.rand(b, 1, generator=gen) * 3.0 + 0.3).to(cuda)
    before = km_ops.launches["gram_from_d2"]
    got = km_ops.gram_from_d2(d2, ga, kind=kind, out_dtype=dout)
    want = km_ref.gram_from_d2_ref(d2[:, None], ga[:, :, None, None], kind,
                                   dout)
    torch.cuda.synchronize()
    assert km_ops.launches["gram_from_d2"] == before + 1
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["gauss_rbf", "laplacian"])
@pytest.mark.parametrize("c,m,k,d,p", [(4, 13, 300, 54, 1), (2, 8, 2048, 54, 7),
                                       (3, 21, 513, 17, 9), (2, 5, 100, 33, 17),
                                       (2, 3, 257, 70, 33), (1, 2, 64, 5, 64),
                                       (3, 11, 300, 54, 66),
                                       (2, 9, 130, 6, 130),
                                       (1, 8, 2048, 54, 7), (3, 8, 2048, 54, 7),
                                       (1, 8, 4099, 17, 9), (3, 8, 4099, 33, 7),
                                       (1, 8, 4099, 33, 66),
                                       (3, 8, 4099, 17, 130),
                                       (3, 8, 2048, 54, 65),
                                       (2, 8, 2048, 54, 6),
                                       (2, 8, 2048, 54, 8),
                                       (2, 8, 2048, 54, 32),
                                       (2, 8, 2048, 54, 16),
                                       (3, 5, 2048, 54, 17),
                                       (1, 8, 2048, 54, 33)])
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
    again = sp_ops.svm_predict_cells(xt, sv, co, ga, kind=kind)
    torch.cuda.synchronize()
    assert sp_ops.launches["svm_predict_cells"] == before + 2
    assert got.shape == (c, m, p)
    assert float((got - want).abs().max()) <= 1e-4 * max(
        1.0, float(want.abs().max()))
    assert torch.equal(got, again)      # fixed sum order, splits included


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
                                         (2, 5, 201, 70, 17),
                                         (2, 5, 1824, 70, 17),   # 8-col blocks
                                         (1, 1, 33, 1, 0),       # n < panel + 2
                                         (1, 2, 2000, 9, 3)])    # 8 rows a thread
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
    bf16: the same, P rounded to bf16 before P V (2^-8 of each p), then
    one bf16 rounding of the output on each side, which may land one ulp
    (2^-7 relative) apart."""
    if want.dtype == torch.bfloat16:
        return 2.0 ** -7 * max(1.0, float(want.float().abs().max()))
    return 2e-5 * max(1.0, float(want.abs().max()))


def _attn_bound(q, k, v, mask_kind, window, want):
    """bf16, value by value: the two output roundings (2^-8 |o| each) and P
    rounded to bf16 (2^-8 p_j each, so 2^-8 sum_j p_j |v_j| / l: the plain
    attention of |v|); 2^-14 of that for the f32 sums' order."""
    a = fa_ref.flash_attention_ref(q.float(), k.float(), v.float().abs(),
                                   mask_kind, window)
    return 2.0 ** -7 * want.float().abs() + (2.0 ** -8 + 2.0 ** -14) * a


@pytest.mark.gpu
@pytest.mark.parametrize("mask_kind,window,b,t,s,h,hk,d", [
    ("causal", 0, 2, 1, 77, 4, 4, 64),        # T = 1 against a long S
    ("causal", 0, 1, 100, 100, 2, 2, 64),     # T not a multiple of 64
    ("causal", 0, 2, 70, 130, 8, 1, 128),     # GQA g = 8, T != S
    ("window", 300, 1, 90, 90, 4, 2, 256),    # window wider than T
    ("window", 40, 1, 200, 200, 2, 1, 256),   # tiles skipped left of band
    ("bidir", 0, 2, 33, 65, 4, 2, 16),        # smoke head_dim
    ("causal", 0, 1, 1024, 1024, 4, 2, 64),   # 16 kv tiles: the ring wraps
    ("window", 1024, 1, 1536, 1536, 2, 1, 256),  # gemma3-4b's local layers
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
    if dtype == torch.bfloat16:
        bnd = _attn_bound(q, k, v, mask_kind, window, want)
        assert bool(((got.float() - want.float()).abs() <= bnd).all())


@pytest.mark.gpu
def test_flash_attention_refuses_a_misaligned_view(cuda):
    """TMA reads from 16-byte boundaries: a view that starts off one is
    refused, not copied."""
    b, t, h, d = 1, 64, 2, 64
    buf = torch.zeros(b * t * h * d + 1, dtype=torch.bfloat16, device=cuda)
    q = buf[1:].view(b, t, h, d)
    k = torch.zeros(b, t, h, d, dtype=torch.bfloat16, device=cuda)
    assert q.is_contiguous() and q.data_ptr() % 16
    before = fa_ops.launches["flash_attention"]
    with pytest.raises(ValueError):
        fa_ops.flash_attention(q, k, k)
    assert fa_ops.launches["flash_attention"] == before


@pytest.mark.gpu
@pytest.mark.parametrize("b,hk,s,pos,window,g,d,quant", [
    (3, 2, 1, 0, 0, 1, 64, False),            # S = 1
    (3, 2, 333, 332, 0, 2, 64, True),         # int8, S off any tile, pos S-1
    (3, 2, 333, 666, 0, 1, 64, True),         # ring wrapped: pos = 2S
    (3, 2, 300, 120, 0, 8, 16, False),        # partial cache, G = 8
    (3, 2, 257, 500, 64, 2, 256, True),       # window by ring age
    (3, 2, 96, 95, 0, 4, 128, False),
    (8, 32, 320, 319, 0, 1, 64, False),       # the LM path's step (direct)
    (1, 32, 32768, 32767, 0, 1, 64, False),   # B = 1 long context: splits
    (1, 2, 5000, 12000, 1024, 2, 256, True),  # gemma3 local: window, wrapped
    (1, 2, 5000, 4000, 1024, 2, 256, False),  # window, ring not wrapped
    (2, 8, 8192, 9000, 0, 1, 64, True),       # int8, 4 heads a block, splits
    (9, 32, 4096, 4095, 0, 1, 64, False),     # bf16, 2 heads a block
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_kernel_matches_plain(cuda, b, hk, s, pos, window,
                                               g, d, quant, dtype):
    gen = torch.Generator().manual_seed(s * 7 + g + d)
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
    again = dec_ops.decode_attention_fused(q, k, v, pos, d ** -0.5, ks, vs,
                                           window=window)
    torch.cuda.synchronize()
    assert dec_ops.launches["decode_attention"] == before + 2
    assert got.dtype == dtype and got.shape == q.shape
    assert float((got.float() - want.float()).abs().max()) <= _attn_tol(want)
    assert torch.equal(got, again)      # split merges in a fixed order


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
    q1 = torch.ones(1, 2, 1, 64, device=cuda)
    buf = torch.ones(8 * 2 * 64 + 1, device=cuda)     # a cache off 16 bytes
    before = dec_ops.launches["decode_attention"]
    with pytest.raises(ValueError):
        dec_ops.decode_attention_fused(q1, buf[1:].view(1, 8, 2, 64), c, 3,
                                       0.125)
    assert dec_ops.launches["decode_attention"] == before


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


# ------------------------------ cell-construction slice: B6, B7 and B8
from repro_torch.kernels.assign import ops as as_ops  # noqa: E402
from repro_torch.kernels.assign import ref as as_ref  # noqa: E402
from repro_torch.pipeline import assign as pl_assign  # noqa: E402


def _assign_flips_within_bound(x, c, got, want):
    """Rows whose owner differs between the kernel and the plain version
    must be near-ties: if each computes D² within dd2 of the true value
    (B1's 64 ulps of the largest |x|^2 + |c|^2), the kernel's center is
    at most 2 dd2 farther than the plain version's, in exact (f64)
    distances.  Returns the flip count."""
    flips = torch.nonzero(got != want).flatten()
    if flips.numel():
        xf = x[flips].double()
        near = ((xf - c[got[flips].long()].double()) ** 2).sum(1)
        plain = ((xf - c[want[flips].long()].double()) ** 2).sum(1)
        dd2 = 64 * EPS * float((x * x).sum(1).max() + (c * c).sum(1).max())
        assert float((near - plain).max()) <= 2 * dd2
    return int(flips.numel())


@pytest.mark.gpu
@pytest.mark.parametrize("n,c,d", [(1, 1, 1), (1, 300, 54), (4097, 1, 3),
                                   (777, 67, 19), (2000, 5500, 28),
                                   (65536, 291, 54), (130, 64, 32),
                                   (3000, 552, 54), (3000, 553, 54),
                                   (1001, 291, 55), (999, 700, 33),
                                   (300, 70, 2048)])
def test_assign_kernel_matches_plain(cuda, n, c, d):
    """C and d off every tile, one row, one center, a center table of 5500
    x 28 (616 KB) larger than a block's shared memory, tables just under
    and just over the resident limit (552 and 553 centers at d 54), d odd
    and rows wider than one 32-feature chunk of the streamed path."""
    gen = torch.Generator().manual_seed(n + c + d)
    x = _rand(gen, n, d, scale=2.0).to(cuda)
    cen = x[torch.randint(0, n, (c,), generator=gen).to(cuda)] + _rand(
        gen, c, d, scale=0.5).to(cuda)
    before = as_ops.launches["assign"]
    got = as_ops.assign(x, cen)
    want = as_ref.assign_ref(x, cen)
    torch.cuda.synchronize()
    assert as_ops.launches["assign"] == before + 1
    assert got.dtype == torch.int32 and got.shape == (n,)
    assert int(got.min()) >= 0 and int(got.max()) < c
    flips = _assign_flips_within_bound(x, cen, got, want)
    assert flips <= max(1, n // 1000)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [5, 54])
def test_assign_kernel_duplicated_centers_lowest_index_wins(cuda, d):
    gen = torch.Generator().manual_seed(d)
    base = _rand(gen, 70, d, scale=3.0)
    cen = torch.cat([base, base.flip(0), base]).to(cuda)  # 3 copies, 210 rows
    x = torch.cat([base, base + _rand(gen, 70, d, scale=0.1),
                   _rand(gen, 500, d, scale=3.0)]).to(cuda)
    got = as_ops.assign(x, cen)
    want = as_ref.assign_ref(x, cen)
    torch.cuda.synchronize()
    assert int(got.max()) < 70                    # the first copy always wins
    assert torch.equal(got[:70].cpu(), torch.arange(70, dtype=torch.int32))
    _assign_flips_within_bound(x, cen, got, want)


@pytest.mark.gpu
def test_assign_stream_and_lloyd_on_the_card(cuda):
    """The device backends against the host's numpy over a chunk source:
    owners within the flip bound; one launch per chunk and sweep."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(5000, 9)).astype(np.float32)
    init = x[rng.choice(5000, 40, replace=False)]
    want = pl_assign.assign_stream(x, init, chunk_size=1024)
    xt, ct = torch.as_tensor(x).to(cuda), torch.as_tensor(init).to(cuda)
    for backend in ("torch", "kernel"):
        before = as_ops.launches["assign"]
        got = pl_assign.assign_stream(x, init, chunk_size=1024,
                                      backend=backend)
        n_launch = as_ops.launches["assign"] - before
        assert n_launch == (5 if backend == "kernel" else 0)
        _assign_flips_within_bound(xt, ct, torch.as_tensor(got).to(cuda),
                                   torch.as_tensor(want).to(cuda))
    before = as_ops.launches["assign"]
    swept = pl_assign.lloyd_stream(x, init, 2, chunk_size=1024,
                                   backend="kernel")
    assert as_ops.launches["assign"] - before == 2 * 5
    host = pl_assign.lloyd_stream(x, init, 2, chunk_size=1024)
    assert swept.shape == host.shape and np.isfinite(swept).all()
    assert np.abs(swept - host).max() <= 1e-3 * np.abs(host).max()


@pytest.mark.gpu
def test_minibatch_kmeans_on_the_card_is_deterministic(cuda):
    rng = np.random.default_rng(6)
    x = rng.normal(size=(3000, 7)).astype(np.float32)
    a = pl_assign.minibatch_kmeans(x, 16, iters=10, batch_size=512, seed=2)
    b = pl_assign.minibatch_kmeans(x, 16, iters=10, batch_size=512, seed=2)
    assert np.array_equal(a, b)
    host = pl_assign.minibatch_kmeans(x, 16, iters=10, batch_size=512,
                                      seed=2, device="cpu")
    assert np.abs(a - host).max() <= 1e-3 * np.abs(host).max()


def _gram_bound(x, z, gamma, kind):
    """What a D² error within B1's tolerance (64 ulps of the largest
    |x|^2 + |z|^2) can do to each kernel value, plus 8 ulps of 1."""
    dd2 = 64 * EPS * float((x * x).sum(-1).max() + (z * z).sum(-1).max())
    d2 = km_ref.sq_dists_ref(x, z)
    kk = km_ref.gram_from_d2_ref(d2, gamma, kind)
    if kind == "gauss_rbf":
        rel = np.expm1(dd2 / max(gamma * gamma, 1e-12))
    else:
        root = torch.sqrt(d2 + 1e-12)
        rel = torch.expm1(torch.clamp(dd2 / (2.0 * root), max=dd2 ** 0.5)
                          / max(gamma, 1e-12))
    return kk * rel + 8 * EPS


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["gauss_rbf", "laplacian"])
@pytest.mark.parametrize("n,m,d", [(1, 130, 3), (300, 257, 54),
                                   (2048, 2048, 54), (9, 1, 1)])
def test_gram_kernel_matches_plain(cuda, kind, n, m, d):
    gen = torch.Generator().manual_seed(n + m + d)
    x = _rand(gen, n, d).to(cuda)
    z = _rand(gen, m, d).to(cuda)
    gamma = 0.7 * d ** 0.5
    before = km_ops.launches["gram"]
    got = km_ops.kernel_matrix(x, z, gamma, kind=kind)
    want = km_ref.kernel_matrix_ref(x, z, gamma, kind)
    torch.cuda.synchronize()
    assert km_ops.launches["gram"] == before + 1
    assert got.shape == (n, m)
    assert bool(((got - want).abs() <= _gram_bound(x, z, gamma, kind)).all())
    # one pass computes what B1 then B2 compute, value for value
    two = km_ops.gram_from_d2(km_ops.sq_dists(x, z), gamma, kind=kind)
    assert torch.equal(got, two)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["gauss_rbf", "laplacian"])
@pytest.mark.parametrize("nt,ns,d,p", [(1, 130, 3, 1), (300, 257, 54, 7),
                                       (77, 2048, 54, None), (8, 1, 5, 3),
                                       (19, 600, 28, 70)])
def test_svm_predict_kernel_matches_plain(cuda, kind, nt, ns, d, p):
    """One row, ns off the 256-row SV tile, P = 1, 1-D coefs, and more
    than one 64-column block."""
    gen = torch.Generator().manual_seed(nt + ns + d)
    x = _rand(gen, nt, d).to(cuda)
    sv = _rand(gen, ns, d).to(cuda)
    co = _rand(gen, *((ns,) if p is None else (ns, p))).to(cuda)
    gamma = 0.7 * d ** 0.5
    before = dict(sp_ops.launches)
    got = sp_ops.svm_predict(x, sv, co, gamma, kind=kind)
    want = sp_ref.svm_predict_ref(x, sv, co, gamma, kind)
    torch.cuda.synchronize()
    assert sp_ops.launches["svm_predict"] == before["svm_predict"] + 1
    assert sp_ops.launches["svm_predict_cells"] == before["svm_predict_cells"]
    if p is None:
        want = want[:, 0]
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= 1e-4 * max(
        1.0, float(want.abs().max()))
    if p is not None:      # 1-D coefs give the 2-D call's column, bitwise
        one = sp_ops.svm_predict(x, sv, co[:, 0].contiguous(), gamma,
                                 kind=kind)
        if p <= 8:         # one kernel instantiation for P <= 8
            assert torch.equal(one, got[:, 0])


@pytest.mark.gpu
def test_cell_wrappers_reject_what_the_kernels_do_not_take(cuda):
    x = torch.ones(8, 4, device=cuda)
    with pytest.raises(ValueError):
        as_ops.assign(x, x.cpu())
    with pytest.raises(ValueError):
        as_ops.assign(x.t().contiguous().t(), x)
    with pytest.raises(ValueError):
        as_ops.assign(x, x[:0])
    with pytest.raises(TypeError):
        km_ops.kernel_matrix(x, x.double(), 1.0)
    with pytest.raises(ValueError):
        sp_ops.svm_predict(x, x, torch.ones(8, 2), 1.0)
