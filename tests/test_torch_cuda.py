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
table.  This file imports no jax.
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
