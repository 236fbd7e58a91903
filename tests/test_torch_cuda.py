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
layers (D = 256, window 1024), and a misaligned view refused; B9's f32
kernel through its split over the keys (gemma3-4b's head-group rank, a
4096-key causal head, T off the tile), its bits equal from run to run and
for a row launched alone or in a batch of 3, rows whose largest logit
keeps growing (the offsets move at every tile), and its blocks an SM as
the split planner counts them; B2 with one
gamma per row bitwise equal to its plain version where rows straddle
16-byte chunks (N % 8 = 1, 7) and where they do not; B1 and B3 at the
SVM head's d = 2048; B1 and B1-sym on every path of their launch plan
(few and many query rows, TMA spans and per-thread copies of tables
that are not 16-byte aligned, whole and chunked features, d 1 to 2048,
n and m at 1, 127, 129 and 1825, more slots than SMs) and their bitwise
invariants (B1-sym(x) equals B1(x, x), a slot alone equals the same
slot in a batch, B7 equals B2 over B1); greedy generation at the smoke configs through the kernels against the
plain path; for the nearest-center kernel (B6) a center table larger than
shared memory, tables just under and over the resident limit, C and d off
every tile, d odd, duplicated centers, one row and one center; for the
one-shot Gram (B7) and the one-cell predict (B8) one row, SV counts off
the tile and P = 1; the ridge, expectile and quantile solvers on CUDA
operands with no mask and no warm start; B9 and B10 refusing an operand
that requires grad; rwkv6's smoke config on the card against its own
stepped recurrence and the CPU's greedy tokens; the serve launcher on the
card launching B9 and B10.  This file imports no jax.
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


def _table(gen, dev, b, m, d, offset=0, scale=3.0):
    """(b, m, d) on ``dev``, ``offset`` floats into its allocation: offset
    1 leaves the table only 4-byte aligned."""
    flat = _rand(gen, b * m * d + offset, scale=scale).to(dev)
    return flat[offset:].view(b, m, d)


@pytest.mark.gpu
@pytest.mark.parametrize("b,n,m,d,offset", [
    (1, 1, 1, 1, 0), (3, 13, 300, 54, 0), (2, 40, 129, 33, 0),
    (5, 8, 2048, 7, 0),
    # few query rows (z streamed): the serving wave by the TMA unit (256
    # slots), per-thread copies of an unaligned table at the ragged edge,
    # 16-byte copies in chunks of 64 features, d 2048
    (256, 8, 2048, 54, 0), (3, 8, 1825, 54, 1), (2, 16, 129, 300, 0),
    (2, 9, 127, 2048, 0), (140, 5, 300, 54, 1),
    # many query rows (the register tile): staged whole just past the
    # streamed regime and unaligned, streamed features, d 1, d 2048, more
    # slots than SMs, n and m off the 128-row tile and off 4
    (2, 17, 1825, 54, 1), (2, 129, 127, 300, 0), (1, 1825, 129, 1, 0),
    (2, 127, 1825, 2048, 0), (140, 20, 130, 7, 0), (3, 600, 1824, 54, 0)])
def test_sq_dists_kernel_matches_plain(cuda, b, n, m, d, offset):
    gen = torch.Generator().manual_seed(b * 1000 + n)
    x = _rand(gen, b, n, d, scale=3.0).to(cuda)
    z = _table(gen, cuda, b, m, d, offset)
    assert (z.data_ptr() % 16 == 0) == (offset == 0)
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
@pytest.mark.parametrize("k", [1, 127, 129, 1824, 1825])
@pytest.mark.parametrize("d", [1, 54, 300, 7, 2048])
def test_sq_dists_sym_kernel_is_symmetric_and_matches_plain(cuda, k, d):
    """Whole-staged (d <= 104) and streamed features, diagonal and
    mirrored tiles, n off the 128-row tile and off 4 (scalar stores)."""
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


# (invariant, shape): every D² value is one ascending fp32 FMA chain a
# pair, whichever kernel, tile, copy path or slot computes it
_D2_INVARIANTS = [
    # B1-sym(x) == B1(x, x): the training wave, B1 on its streamed path
    # (n <= 16), streamed features, d 1
    ("sym_is_cross", (16, 1824, 54)), ("sym_is_cross", (3, 12, 54)),
    ("sym_is_cross", (2, 300, 2048)), ("sym_is_cross", (3, 129, 7)),
    ("sym_is_cross", (3, 127, 1)),
    # one slot alone (its table aligned otherwise: another copy path) ==
    # the same slot inside a batch of more slots than SMs
    ("slot_alone", (140, 8, 2048, 54)), ("slot_alone", (140, 40, 300, 54)),
    ("slot_alone", (3, 16, 1825, 300)), ("slot_alone_sym", (140, 200, 54)),
    # B7 == B2(B1): one pass computes what B1 then B2 compute
    *[("gram_is_epilogue", (kind, n, m, d))
      for kind in ("gauss_rbf", "laplacian")
      for n, m, d in ((1, 130, 3), (300, 257, 54), (2048, 2048, 54),
                      (9, 1, 1))],
]


@pytest.mark.gpu
@pytest.mark.parametrize("invariant,shape", _D2_INVARIANTS)
def test_d2_kernels_bitwise_invariants(cuda, invariant, shape):
    gen = torch.Generator().manual_seed(
        len(invariant) * 1000 + sum(v for v in shape if isinstance(v, int)))
    if invariant == "sym_is_cross":
        b, n, d = shape
        x = _rand(gen, b, n, d, scale=2.0).to(cuda)
        got = km_ops.sq_dists(x, x, symmetric=True)
        assert torch.equal(got, km_ops.sq_dists(x, x))
    elif invariant == "slot_alone":
        b, n, m, d = shape
        x = _rand(gen, b, n, d).to(cuda)
        z = _table(gen, cuda, b, m, d)
        got = km_ops.sq_dists(x, z)
        for s in (0, 1, b - 1):
            assert torch.equal(km_ops.sq_dists(x[s:s + 1], z[s:s + 1])[0],
                               got[s])
    elif invariant == "slot_alone_sym":
        b, n, d = shape
        x = _rand(gen, b, n, d).to(cuda)
        got = km_ops.sq_dists(x, x, symmetric=True)
        for s in (0, 1, b - 1):
            assert torch.equal(km_ops.sq_dists(x[s], x[s], symmetric=True),
                               got[s])
    else:
        kind, n, m, d = shape
        x = _rand(gen, n, d).to(cuda)
        z = _rand(gen, m, d).to(cuda)
        gamma = 0.7 * d ** 0.5
        got = km_ops.kernel_matrix(x, z, gamma, kind=kind)
        two = km_ops.gram_from_d2(km_ops.sq_dists(x, z), gamma, kind=kind)
        assert torch.equal(got, two)


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
    ("causal", 0, 1, 300, 300, 32, 8, 160),   # stablelm-12b: 5 panels of 32
    ("causal", 0, 2, 100, 260, 4, 1, 160),    # D 160, GQA 4, T != S
    ("window", 70, 1, 200, 200, 4, 2, 160),
    ("bidir", 0, 2, 130, 130, 16, 16, 80),    # hubert-xlarge: 5 panels of 16
    ("causal", 0, 1, 257, 257, 4, 2, 80),
    ("causal", 0, 2, 77, 77, 8, 2, 8),        # command-r smoke: CUDA cores
    ("bidir", 0, 1, 65, 33, 8, 8, 8),
    ("window", 16, 1, 150, 150, 4, 4, 8),
    # local heads of head-parallel prefill at 16 'model' ranks: a rank's
    # query heads and the one kv head they share
    ("causal", 0, 1, 300, 300, 2, 1, 160),    # stablelm-12b
    ("causal", 0, 1, 300, 300, 4, 1, 128),    # qwen3-moe, internvl2
    ("causal", 0, 1, 300, 300, 6, 1, 128),    # command-r-plus: G 6
    ("bidir", 0, 2, 130, 130, 1, 1, 80),      # hubert-xlarge
    # a rank of a head group where 16 'model' ranks do not divide the
    # heads: its group's query heads on its block of the rows
    ("window", 100, 1, 300, 300, 1, 1, 256),  # gemma3-4b: 1 head, local
    ("causal", 0, 1, 300, 300, 1, 1, 256),    # gemma3-4b: global layers
    ("causal", 0, 1, 300, 300, 5, 1, 128),    # llama4-maverick: G 5
    # f32: the CUDA-core kernel splits the keys of these rows' blocks
    ("window", 1024, 1, 2048, 2048, 1, 1, 256),  # gemma3-4b's group rank
    ("causal", 0, 1, 4096, 4096, 1, 1, 128),
    ("bidir", 0, 1, 2048, 2048, 2, 2, 80),
    ("causal", 0, 1, 1000, 1500, 2, 1, 160),  # T not a multiple of 64
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
@pytest.mark.parametrize("mask_kind,window,t,s,h,hk,d,split", [
    ("window", 1024, 2048, 2048, 1, 1, 256, True),   # gemma3-4b group rank
    ("causal", 0, 300, 300, 16, 4, 80, False),
])
def test_flash_attention_f32_bits_do_not_depend_on_run_or_batch(
        cuda, mask_kind, window, t, s, h, hk, d, split):
    """The CUDA-core kernel's split merges in split order and its split
    count ignores B: two launches give equal bits, and row b of a B = 3
    launch equals the same row launched alone."""
    from repro_torch.kernels import runtime
    assert (fa_ops.split_count(t, s, h, d, mask_kind, window,
                               runtime.sm_count(cuda)) > 1) == split
    gen = torch.Generator().manual_seed(t + d)
    q, k, v = (_rand(gen, 3, n, hh, d).to(cuda)
               for n, hh in ((t, h), (s, hk), (s, hk)))
    got = fa_ops.flash_attention(q, k, v, mask_kind, window)
    again = fa_ops.flash_attention(q, k, v, mask_kind, window)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    for b in range(3):
        one = fa_ops.flash_attention(q[b:b + 1].contiguous(),
                                     k[b:b + 1].contiguous(),
                                     v[b:b + 1].contiguous(), mask_kind,
                                     window)
        assert torch.equal(one[0], got[b])
    want = fa_ref.flash_attention_ref(q, k, v, mask_kind, window)
    assert float((got - want).abs().max()) <= _attn_tol(want)


@pytest.mark.gpu
@pytest.mark.parametrize("mask_kind,window,t,s,h,d", [
    ("bidir", 0, 300, 700, 2, 80), ("causal", 0, 500, 500, 2, 64),
    ("window", 1024, 2048, 2048, 1, 256)])
def test_flash_attention_f32_rows_whose_max_keeps_growing(
        cuda, mask_kind, window, t, s, h, d):
    """Keys scaled up along the sequence, so that a row's largest logit
    grows from tile to tile: the f32 kernel moves the rows' offsets
    (rescaling the sums and the output) again and again, split or not,
    and stays within ``_attn_tol``."""
    gen = torch.Generator().manual_seed(t + s + d)
    q = _rand(gen, 1, t, h, d).abs() * 3
    k = (_rand(gen, 1, s, h, d).abs()
         * torch.linspace(0.1, 6.0, s)[None, :, None, None])
    v = _rand(gen, 1, s, h, d)
    q, k, v = (x.to(cuda) for x in (q, k, v))
    got = fa_ops.flash_attention(q, k, v, mask_kind, window)
    want = fa_ref.flash_attention_ref(q, k, v, mask_kind, window)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= _attn_tol(want)


@pytest.mark.gpu
def test_flash_attention_cc_occupancy_is_the_planners(cuda):
    """The split planner's blocks an SM (``CC_BLOCKS_PER_SM``) are what the
    card's occupancy calculator gives the CUDA-core kernel."""
    got = {d: fa_ops.cc_blocks_per_sm(d) for d in fa_ops.HEAD_DIMS}
    assert got == fa_ops.CC_BLOCKS_PER_SM


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
    (2, 8, 2048, 2047, 0, 4, 160, False),     # stablelm-12b's step: 20 of 32 lanes
    (2, 8, 2048, 2047, 0, 4, 160, True),
    (3, 2, 333, 666, 0, 1, 160, True),        # int8 at G 1: 10 of 16 lanes, wrapped
    (1, 8, 9000, 9100, 1024, 2, 160, False),  # window, wrapped, splits
    (3, 4, 300, 120, 0, 2, 80, False),        # 10 of 16 lanes, partial cache
    (2, 16, 1024, 1500, 0, 1, 80, True),      # int8 at G 1: 5 of 8 lanes
    (3, 2, 100, 99, 0, 4, 8, False),          # command-r smoke: one lane a key
    (3, 2, 100, 250, 0, 4, 8, True),          # int8 rows of 8 bytes, wrapped
    (1, 2, 5000, 4999, 0, 2, 8, True),        # splits at D 8
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
@pytest.mark.parametrize("b,hk,s,pos,window,g,d,quant", [
    (2, 8, 2064, 2047, 0, 5, 128, False),     # llama4's step: G 5 (direct)
    (2, 8, 2064, 2062, 0, 5, 128, True),
    (2, 4, 2064, 2047, 0, 16, 128, False),    # qwen3's step: 2 slices of 8
    (2, 4, 2064, 2062, 0, 16, 128, True),
    (1, 4, 32768, 32767, 0, 16, 128, False),  # splits, both halves
    (1, 8, 9000, 9100, 1024, 5, 128, True),   # window, wrapped, splits
    (3, 2, 300, 120, 0, 5, 64, False),        # partial cache
    (3, 4, 333, 666, 0, 5, 64, True),         # int8, 2 heads a block
    (3, 2, 100, 250, 0, 16, 8, True),         # int8 rows of 8 bytes
    (2, 8, 2064, 2047, 0, 12, 128, False),    # command-r's step: 3 slices of 4
    (1, 8, 9000, 8999, 0, 12, 128, True),     # splits
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_kernel_at_the_moe_groups(cuda, b, hk, s, pos,
                                                   window, g, d, quant,
                                                   dtype):
    """B10 at G 5 (llama4-maverick: 40 / 8), G 16 (qwen3-moe: 64 / 4) and
    G 12 (command-r-plus: 96 / 8) against its plain version; a group of
    16 runs as two slices of 8 in one launch, 12 as three of 4."""
    gen = torch.Generator().manual_seed(s * 5 + g + d)
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
    assert dec_ops.group_slices(g) == {16: (8, 2), 12: (4, 3)}.get(g, (g, 1))
    before = dec_ops.launches["decode_attention"]
    got = dec_ops.decode_attention_fused(q, k, v, pos, d ** -0.5, ks, vs,
                                         window=window)
    again = dec_ops.decode_attention_fused(q, k, v, pos, d ** -0.5, ks, vs,
                                           window=window)
    want = dec_ref.decode_attention_ref(q, k, v, pos, d ** -0.5, ks, vs,
                                        window)
    torch.cuda.synchronize()
    assert dec_ops.launches["decode_attention"] == before + 2
    assert got.dtype == dtype and got.shape == q.shape
    assert float((got.float() - want.float()).abs().max()) <= _attn_tol(want)
    assert torch.equal(got, again)


@pytest.mark.gpu
@pytest.mark.parametrize("b,hk,g,d,ring,pos,window,lo,n", [
    (4, 16, 1, 64, 1024, 1023, 0, 512, 512),    # stablelm's half of a ring
    (2, 8, 4, 128, 4096, 4095, 0, 0, 2048),     # splits over the keys
    (2, 4, 16, 128, 2064, 2047, 0, 1032, 1032),  # qwen3: 2 slices of 8
    (3, 2, 1, 64, 12, 12, 8, 0, 6),             # window: both block ends
    (3, 2, 4, 128, 16, 3, 0, 8, 8),             # no visible key: no launch
    # gemma3-4b's last block of a ring of 2052 over 16 'model' ranks, its
    # window of 1024 (the decode after the prefill by head group)
    (2, 4, 2, 256, 2052, 2048, 1024, 1935, 129),
])
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_decode_attention_partials_match_plain(cuda, b, hk, g, d, ring, pos,
                                               window, lo, n, quant):
    """B10's partials mode on one block [lo, lo + n) of a ring (the
    flash-decoding split) against the plain partials on the same block:
    the f32 output within ``_attn_tol`` of the plain one (f32 sums in
    another order), the log-sum-exp within 1e-5 of its magnitude; a block
    with no visible key gives zeros and -inf without a launch.  Merged
    with the ring's other blocks (``attention.merge_partials`` over no
    group: one block's weight), the whole ring's plain output."""
    gen = torch.Generator().manual_seed(ring + lo + g + d)
    q = _rand(gen, b, hk, g, d).to(cuda, torch.bfloat16)
    k = _rand(gen, b, ring, hk, d)
    v = _rand(gen, b, ring, hk, d)
    ks = vs = None
    if quant:
        ks = k.abs().amax(-1, keepdim=True).div(127.0).clamp(min=1e-10)
        vs = v.abs().amax(-1, keepdim=True).div(127.0).clamp(min=1e-10)
        k = torch.round(k / ks).clamp(-127, 127).to(torch.int8)
        v = torch.round(v / vs).clamp(-127, 127).to(torch.int8)
        ks, vs = ks.to(cuda), vs.to(cuda)
    else:
        k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
    k, v = k.to(cuda), v.to(cuda)
    scale = d ** -0.5
    parts = []
    for l0 in range(0, ring, n):              # every block of the ring
        blk = [t[:, l0:l0 + n].contiguous() if t is not None else None
               for t in (k, v, ks, vs)]
        before = dec_ops.launches["decode_attention_partials"]
        o, lse = dec_ops.decode_attention_partials(
            q, blk[0], blk[1], pos, scale, blk[2], blk[3], window=window,
            block=(l0, ring))
        s0, nvis = dec_ops.block_visible_range(ring, pos, window, l0, n)
        wo, wl = dec_ref.decode_attention_partials_ref(
            q, blk[0], blk[1], s0, nvis, scale, blk[2], blk[3])
        torch.cuda.synchronize()
        assert dec_ops.launches["decode_attention_partials"] == (
            before + (1 if nvis else 0))
        assert o.dtype == torch.float32 and o.shape == q.shape
        if nvis == 0:
            assert torch.equal(o, torch.zeros_like(o))
            assert bool(torch.isneginf(lse).all())
        else:
            assert float((o - wo).abs().max()) <= _attn_tol(wo)
            assert float((lse - wl).abs().max()) <= 1e-5 * max(
                1.0, float(wl.abs().max()))
        if l0 == lo:
            mine = (o, lse)
        parts.append((o, lse))
    assert mine[0].shape == q.shape
    m = torch.stack([p[1] for p in parts]).amax(0)
    w = [torch.exp(p[1] - m)[..., None] for p in parts]
    got = sum(p[0] * wi for p, wi in zip(parts, w)) / sum(w)
    want = dec_ref.decode_attention_ref(q.float(), k.float() * (
        ks if quant else 1), v.float() * (vs if quant else 1), pos, scale,
        window=window)
    assert float((got - want).abs().max()) <= _attn_tol(want)


@pytest.mark.gpu
def test_attention_wrappers_reject_what_the_kernels_do_not_take(cuda):
    x = torch.ones(1, 4, 2, 12, device=cuda)
    with pytest.raises(ValueError):                   # head_dim 12: no instance
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
@pytest.mark.parametrize("arch", ["stablelm-1.6b", "gemma3-4b",
                                  "stablelm-12b", "command-r-plus-104b"])
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


# ------------------------- repairs: solvers on the card, kernels and grad
@pytest.mark.gpu
def test_public_solvers_take_cuda_operands(cuda):
    """The ridge, expectile and quantile solvers with no mask and no warm
    start build their constants on the operand's device and agree with
    the same call on the CPU."""
    from repro_torch.core.solvers import expectile, least_squares, quantile
    gen = torch.Generator().manual_seed(9)
    x = _rand(gen, 60, 3)
    k = torch.exp(-torch.cdist(x, x) ** 2 / 2.0)
    y = torch.sin(x[:, 0])
    taus = torch.tensor([0.2, 0.5, 0.8])
    lam = torch.full((3,), 1e-2)
    calls = [
        lambda k, y, t, l: least_squares.solve_krr_chol(k, y, 1e-2, 60.0),
        lambda k, y, t, l: expectile.solve_expectile(k, y, t, l, 60.0),
        lambda k, y, t, l: quantile.solve_quantile(k, y, t, l, 60.0).c,
    ]
    for call in calls:
        want = call(k, y, taus, lam)
        got = call(*(a.to(cuda) for a in (k, y, taus, lam)))
        assert got.device.type == "cuda"
        assert float((got.cpu() - want).abs().max()) <= 5e-3 * max(
            1.0, float(want.abs().max()))


@pytest.mark.gpu
def test_attention_kernels_refuse_operands_that_require_grad(cuda):
    """B9 and B10 have no backward: with grad enabled an operand that
    requires grad raises before any launch; the same call under no_grad
    launches."""
    q = torch.randn(1, 40, 2, 64, device=cuda, dtype=torch.bfloat16)
    qg = q.clone().requires_grad_(True)
    n0 = (fa_ops.launches["flash_attention"],
          dec_ops.launches["decode_attention"])
    with pytest.raises(ValueError, match="requires grad"):
        fa_ops.flash_attention(qg, q, q)
    c = torch.randn(1, 40, 2, 64, device=cuda, dtype=torch.bfloat16)
    qd = torch.randn(1, 2, 1, 64, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="requires grad"):
        dec_ops.decode_attention_fused(qd, c.requires_grad_(True), c, 39,
                                       0.125)
    assert (fa_ops.launches["flash_attention"],
            dec_ops.launches["decode_attention"]) == n0
    with torch.no_grad():
        fa_ops.flash_attention(qg, q, q)
    assert fa_ops.launches["flash_attention"] == n0[0] + 1


@pytest.mark.gpu
def test_rwkv6_generate_on_the_card_equals_the_cpu(cuda):
    """rwkv6's smoke config in f32: the card's prefill equals its own
    stepped recurrence and the CPU's, and greedy tokens are the CPU's;
    no attention kernel runs."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.models import model as model_mod
    from repro_torch.models.layers import tree_map
    from repro_torch.serve import engine
    cfg = dataclasses.replace(get_arch("rwkv6-1.6b").smoke,
                              dtype=torch.float32, rwkv_chunk=16)
    params = model_mod.init_params(cfg, torch.Generator().manual_seed(0))
    prompt = torch.randint(0, cfg.vocab, (2, 40),
                           generator=torch.Generator().manual_seed(1))
    n0 = (fa_ops.launches["flash_attention"],
          dec_ops.launches["decode_attention"])
    pc = tree_map(lambda t: t.to(cuda), params)
    got = engine.generate(cfg, pc, prompt.to(cuda), 8)
    want = engine.generate(cfg, params, prompt, 8)
    assert torch.equal(got.cpu(), want)
    logits, _ = model_mod.prefill(cfg, pc, prompt.to(cuda))
    cache = model_mod.init_cache(cfg, 2, 1, device=cuda)
    for i in range(40):
        step, cache = model_mod.decode_step(cfg, pc,
                                            prompt[:, i:i + 1].to(cuda),
                                            cache, i)
    assert float((logits - step).abs().max()) <= 1e-5 * float(
        step.abs().max())
    assert (fa_ops.launches["flash_attention"],
            dec_ops.launches["decode_attention"]) == n0


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b",
                                  "llama4-maverick-400b-a17b",
                                  "jamba-v0.1-52b"])
def test_moe_ssm_smoke_on_the_card_equals_the_cpu(cuda, arch):
    """The MoE and mamba smoke configs in f32: a prefill and three decode
    steps through B9/B10 on the card against the CPU on the same weights,
    within 1e-4 of the largest |logit|, with one B9 launch a prefill
    attention layer and one B10 launch a decode attention layer."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.models import model as model_mod
    from repro_torch.models.layers import tree_map
    from repro_torch.serve import engine
    from repro_torch.serve.kv_cache import pad_cache
    cfg = dataclasses.replace(get_arch(arch).smoke, dtype=torch.float32)
    p_cpu = model_mod.init_params(cfg, torch.Generator().manual_seed(0))
    p_dev = tree_map(lambda a: a.to(cuda), p_cpu)
    x = torch.randint(0, cfg.vocab, (3, 27),
                      generator=torch.Generator().manual_seed(1))
    n_attn = sum(m == "attn" for m, _ in cfg.period_pattern) * cfg.n_periods

    def run(p, dev):
        xd = x.to(dev)
        logits, cache = engine.prefill_step(cfg, p, xd[:, :24])
        cache = pad_cache(cfg, cache, 27)
        out = [logits]
        for j in range(3):
            lj, cache = engine.serve_step(cfg, p, xd[:, 24 + j:25 + j],
                                          cache, 24 + j)
            out.append(lj)
        return [o.cpu() for o in out]
    n0 = (fa_ops.launches["flash_attention"],
          dec_ops.launches["decode_attention"])
    got = run(p_dev, cuda)
    n1 = (fa_ops.launches["flash_attention"],
          dec_ops.launches["decode_attention"])
    assert n1[0] - n0[0] == n_attn
    assert n1[1] - n0[1] == 3 * n_attn
    for a, b in zip(got, run(p_cpu, torch.device("cpu"))):
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= 1e-4 * scale


@pytest.mark.gpu
def test_one_rank_nccl_mesh_fit_equals_unmeshed_fit(cuda, tmp_path):
    """A fit on a (1, 1) ("data", "model") mesh of one NCCL rank in this
    process equals the fit without a mesh bitwise: every array of the
    train result and the held-out decisions (the wave is one rank's whole
    block, gathered through a one-rank group)."""
    import torch.distributed as dist
    from repro_torch.data.synthetic import covtype_like
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.train.svm_trainer import LiquidSVM, SVMTrainerConfig
    x, y = covtype_like(n=900, d=5, seed=1, label_noise=0.02, n_modes=3)
    y = np.where(y == 0, -1, 1)
    cfg = SVMTrainerConfig(n_folds=3, max_iters=150, cell_method="voronoi",
                           cell_size=100, seed=0, n_slots_per_wave=4)
    plain = LiquidSVM(cfg, device=cuda).fit(x, y)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        mesh = mesh_mod.make_mesh((1, 1), ("data", "model"))
        meshed = LiquidSVM(cfg, device=cuda, mesh=mesh,
                           mesh_axes=("data", "model")).fit(x, y)
        for k in ("coefs", "gamma", "lam", "tau", "val_loss", "surf_loss",
                  "surf_fa", "surf_det", "iters"):
            assert np.array_equal(getattr(plain.train_result, k),
                                  getattr(meshed.train_result, k)), k
        assert np.array_equal(plain.decision_function(x[:300]),
                              meshed.decision_function(x[:300]))
    finally:
        dist.destroy_process_group()


@pytest.mark.gpu
def test_serve_launcher_on_the_card_launches_b9_and_b10(cuda, capsys):
    """``launch.serve`` at its defaults (the card): the prefill runs B9
    and the decode steps B10."""
    import json
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch import serve
    fa_ops.launches["flash_attention"] = 0
    dec_ops.launches["decode_attention"] = 0
    assert serve.main(["--arch", "stablelm-1.6b"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["out_shape"] == [4, 32]
    assert fa_ops.launches["flash_attention"] >= 1
    assert dec_ops.launches["decode_attention"] >= 1
