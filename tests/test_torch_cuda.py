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
