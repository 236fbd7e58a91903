"""The port's kernel wrappers against the JAX package's, on the CPU.

On the CPU each ``repro_torch`` wrapper runs its plain PyTorch version
(``ref.py``); the JAX side runs both its Pallas kernel in interpret mode
(``force_pallas=True``, as ``tests/test_serve_svm.py`` runs it) and its jnp
oracle.  Inputs are made from a seed with numpy and handed to both.

Tolerances, each beside the reference's own Pallas-vs-oracle gap measured
at these shapes (C=3, m=20, k=72, d=7, P=6, seed 0):

  * B1 ``sq_dists``: the port differs from both by 3.8e-6 on a D² scale of
    ~55 (1 ulp); the reference's own gap is 0.  Tolerance: 8 ulps of the
    largest D², ~5e-5.
  * B2 ``gram_from_d2``: f32 out differs by 3e-8 (1 ulp of K <= 1) in all
    four in/out combinations; bf16 out is bit-equal; the reference's own
    gap is 0.  Tolerance: 4 f32 ulps of 1.0, one bf16 ulp (2^-8) for a bf16
    write.
  * B3 ``svm_predict_cells``: the port differs by 1.9e-6 (Gaussian) and
    1.4e-6 (Laplacian) on decisions up to ~6; the reference's own gap is
    4.8e-7 and 9.5e-7.  Tolerance: 1e-5 times the largest decision.
  * B1 symmetric: the reference's Pallas kernel (interpret mode) mirrors
    one triangle, its oracle averages D and D^T; the port's plain version
    averages as the oracle does.  Tolerance: B1's 8 ulps of the largest D².
  * B7 ``kernel_matrix`` (one-shot Gram, d 3 to 54, ragged n and m): the
    port differs from the Pallas kernel and the oracle by at most 3.5 f32
    ulps of K <= 1; the reference's own gap is up to 0.06 ulp.
    Tolerance: 8 ulps of 1.0.
  * B8 ``svm_predict`` (one cell, one gamma; P = 1, 6 and 1-D coefs): the
    port differs by at most 5.4e-7 times the largest |decision| (or 1);
    the reference's own gap is up to 7.7e-7.  Tolerance: B3's 1e-5 times
    the largest |decision| (or 1).
  * B9 ``flash_attention`` on bf16 inputs: the card's kernel runs both
    products on the tensor cores and rounds P to bf16 before P V (as the
    TPU kernel's ``jax.lax.dot(p, v)`` does on the MXU at jax's default
    precision).  A plain emulation of that arithmetic (kv tiles of 64, f32
    online softmax, l summing the f32 P) is held against the reference's
    Pallas kernel in interpret mode within the card checks' bf16 budget,
    2^-7 times max(1, the largest |output|).
  * B4/B5: the reference's Pallas CD kernels no longer run on this jax
    (ROADMAP C1); their parity with the jnp oracles is in
    ``tests/test_torch_train.py::TestCD``.  Here: dispatch and checks.
"""
from __future__ import annotations

import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import ops as jf_ops  # noqa: E402
from repro.kernels.kernel_matrix import ops as jk_ops  # noqa: E402
from repro.kernels.kernel_matrix import ref as jk_ref  # noqa: E402
from repro.kernels.svm_predict import ops as js_ops  # noqa: E402
from repro.kernels.svm_predict import ref as js_ref  # noqa: E402
from repro_torch.kernels import runtime  # noqa: E402
from repro_torch.kernels.cd_solver import ops as tc_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as tf_ref  # noqa: E402
from repro_torch.kernels.kernel_matrix import ops as tk_ops  # noqa: E402
from repro_torch.kernels.svm_predict import ops as ts_ops  # noqa: E402

EPS = float(np.finfo(np.float32).eps)
C, M, K, D, P = 3, 20, 72, 7, 6


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    return {
        "xt": rng.normal(size=(C, M, D)).astype(np.float32),
        "sv": rng.normal(size=(C, K, D)).astype(np.float32),
        "co": rng.normal(size=(C, K, P)).astype(np.float32),
        "ga": rng.uniform(0.5, 3.0, size=(C, P)).astype(np.float32),
    }


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.to(torch.float32).numpy()


class TestSqDists:
    @pytest.mark.parametrize("c", range(C))
    def test_matches_pallas_and_oracle(self, inputs, c):
        x, z = inputs["xt"][c], inputs["sv"][c]
        pal = np.asarray(jk_ops.sq_dists(jnp.asarray(x), jnp.asarray(z),
                                         force_pallas=True))
        orc = np.asarray(jk_ref.sq_dists_ref(jnp.asarray(x), jnp.asarray(z)))
        got = _np(tk_ops.sq_dists(_t(x), _t(z)))
        tol = 8 * EPS * float(orc.max())
        assert got.shape == (M, K)
        assert np.abs(got - pal).max() <= tol
        assert np.abs(got - orc).max() <= tol
        assert (got >= 0).all()

    def test_batched_equals_per_slot(self, inputs):
        """The engine's batched wave D² is the per-slot D², slot by slot."""
        got = tk_ops.sq_dists(_t(inputs["xt"]), _t(inputs["sv"]))
        assert got.shape == (C, M, K)
        for c in range(C):
            one = tk_ops.sq_dists(_t(inputs["xt"][c]), _t(inputs["sv"][c]))
            np.testing.assert_allclose(_np(got[c]), _np(one),
                                       atol=8 * EPS * float(one.max()))

    def test_rejects_bad_operands(self, inputs):
        x = _t(inputs["xt"])
        with pytest.raises(TypeError):
            tk_ops.sq_dists(x.double(), x.double())
        with pytest.raises(ValueError):
            tk_ops.sq_dists(x, x[:, :, :3])


class TestGramFromD2:
    @pytest.mark.parametrize("kind", ["gauss_rbf", "laplacian"])
    @pytest.mark.parametrize("din,dout", [("f32", "f32"), ("f32", "bf16"),
                                          ("bf16", "f32"), ("bf16", "bf16")])
    def test_matches_pallas_and_oracle(self, inputs, kind, din, dout):
        d2 = np.asarray(jk_ref.sq_dists_ref(jnp.asarray(inputs["xt"][0]),
                                            jnp.asarray(inputs["sv"][0])))
        gamma = 1.3
        jd2 = jnp.asarray(d2)
        td2 = _t(d2)
        if din == "bf16":
            jd2 = jd2.astype(jnp.bfloat16)
            td2 = td2.to(torch.bfloat16)
        pal = np.asarray(jk_ops.gram_from_d2(
            jd2, gamma, kind=kind, out_dtype=dout,
            force_pallas=True).astype(jnp.float32))
        orc = np.asarray(jk_ref.gram_from_d2_ref(
            jd2, gamma, kind, dout).astype(jnp.float32))
        got = tk_ops.gram_from_d2(td2, gamma, kind=kind, out_dtype=dout)
        assert got.dtype == (torch.bfloat16 if dout == "bf16"
                             else torch.float32)
        tol = 2.0 ** -8 if dout == "bf16" else 4 * EPS
        assert np.abs(_np(got) - pal).max() <= tol
        assert np.abs(_np(got) - orc).max() <= tol

    @pytest.mark.parametrize("kind", ["gauss_rbf", "laplacian"])
    def test_batched_gammas_equal_scalar_calls(self, inputs, kind):
        """(B, n, m) x (B, G) -> (B, G, n, m): plane (b, g) is the scalar
        call with gamma[b, g], bitwise."""
        d2 = tk_ops.sq_dists(_t(inputs["xt"]), _t(inputs["sv"]))
        ga = _t(inputs["ga"])
        got = tk_ops.gram_from_d2(d2, ga, kind=kind)
        assert got.shape == (C, P, M, K)
        for b in range(C):
            for g in range(P):
                one = tk_ops.gram_from_d2(d2[b], float(ga[b, g]), kind=kind)
                assert torch.equal(got[b, g], one)

    def test_rejects_unknown_kind_and_dtype(self, inputs):
        d2 = torch.zeros((4, 4))
        with pytest.raises(ValueError):
            tk_ops.gram_from_d2(d2, 1.0, kind="poly")
        with pytest.raises(ValueError):
            tk_ops.gram_from_d2(d2, 1.0, out_dtype="f16")
        with pytest.raises(ValueError):
            tk_ops.gram_from_d2(d2[None], torch.ones(2, 3))


class TestSvmPredictCells:
    @pytest.mark.parametrize("kind", ["gauss_rbf", "laplacian"])
    def test_matches_pallas_and_oracle(self, inputs, kind):
        j = [jnp.asarray(inputs[n]) for n in ("xt", "sv", "co", "ga")]
        pal = np.asarray(js_ops.svm_predict_cells(*j, kind=kind,
                                                  force_pallas=True))
        orc = np.asarray(js_ref.svm_predict_cells_ref(*j, kind=kind))
        got = _np(ts_ops.svm_predict_cells(
            *[_t(inputs[n]) for n in ("xt", "sv", "co", "ga")], kind=kind))
        assert got.shape == (C, M, P)
        tol = 1e-5 * max(1.0, float(np.abs(orc).max()))
        assert np.abs(got - pal).max() <= tol
        assert np.abs(got - orc).max() <= tol

    def test_zero_coefficient_padding_is_exact(self, inputs):
        """Zero-coefficient SV rows contribute exactly zero: padding the SV
        axis with them changes decisions only by summation order."""
        args = [_t(inputs[n]) for n in ("xt", "sv", "co", "ga")]
        base = ts_ops.svm_predict_cells(*args)
        xt, sv, co, ga = args
        gen = torch.Generator().manual_seed(0)
        sv_p = torch.cat([sv, torch.randn(C, 8, D, generator=gen)], dim=1)
        co_p = torch.cat([co, torch.zeros(C, 8, P)], dim=1)
        padded = ts_ops.svm_predict_cells(xt, sv_p, co_p, ga)
        np.testing.assert_allclose(_np(padded), _np(base),
                                   atol=1e-5 * float(base.abs().max()))

    def test_rejects_mismatched_shapes(self, inputs):
        args = [_t(inputs[n]) for n in ("xt", "sv", "co", "ga")]
        with pytest.raises(ValueError):
            ts_ops.svm_predict_cells(args[0], args[1], args[2], args[3][:, :2])
        with pytest.raises(ValueError):
            ts_ops.svm_predict_cells(*args, kind="poly")


class TestSqDistsSymmetric:
    @pytest.mark.parametrize("c", range(C))
    def test_matches_pallas_and_oracle(self, inputs, c):
        x = inputs["sv"][c]
        before = dict(tk_ops.launches)
        got = _np(tk_ops.sq_dists(_t(x), _t(x), symmetric=True))
        assert tk_ops.launches == before        # the CPU runs no kernel
        tol = 8 * EPS * float(4 * (x * x).sum(-1).max())
        for force in (True, False):
            want = np.asarray(jk_ops.sq_dists(jnp.asarray(x), jnp.asarray(x),
                                              symmetric=True,
                                              force_pallas=force))
            assert np.abs(got - want).max() <= tol
        assert np.array_equal(got, got.T)

    def test_rejects_different_points(self, inputs):
        x = _t(inputs["sv"][0])
        with pytest.raises(ValueError):
            tk_ops.sq_dists(x, x[:5], symmetric=True)


KM_SHAPES = [(20, 72, 7), (1, 130, 3), (129, 1, 54), (33, 257, 19)]


class TestKernelMatrix:
    @pytest.mark.parametrize("kind", ["gauss_rbf", "laplacian"])
    @pytest.mark.parametrize("n,m,d", KM_SHAPES)
    def test_matches_pallas_and_oracle(self, n, m, d, kind):
        rng = np.random.default_rng(n * 1000 + m)
        x = rng.normal(size=(n, d)).astype(np.float32)
        z = rng.normal(size=(m, d)).astype(np.float32)
        gamma = float(rng.uniform(0.8, 3.0)) * np.sqrt(d / 7)
        pal = np.asarray(jk_ops.kernel_matrix(jnp.asarray(x), jnp.asarray(z),
                                              gamma, kind=kind,
                                              force_pallas=True))
        orc = np.asarray(jk_ref.kernel_matrix_ref(jnp.asarray(x),
                                                  jnp.asarray(z), gamma,
                                                  kind))
        before = dict(tk_ops.launches)
        got = tk_ops.kernel_matrix(_t(x), _t(z), gamma, kind=kind)
        assert tk_ops.launches == before        # the CPU runs no kernel
        assert got.shape == (n, m) and got.dtype == torch.float32
        assert np.abs(_np(got) - pal).max() <= 8 * EPS
        assert np.abs(_np(got) - orc).max() <= 8 * EPS

    @pytest.mark.parametrize("kind", ["gauss_rbf", "laplacian"])
    def test_equals_epilogue_over_d2(self, inputs, kind):
        """One pass computes what B1 then B2 compute, value for value."""
        x, z = _t(inputs["xt"][0]), _t(inputs["sv"][0])
        got = tk_ops.kernel_matrix(x, z, torch.tensor(1.3), kind=kind)
        want = tk_ops.gram_from_d2(tk_ops.sq_dists(x, z), 1.3, kind=kind)
        assert torch.equal(got, want)

    def test_rejects_bad_operands(self, inputs):
        x = _t(inputs["xt"][0])
        with pytest.raises(ValueError):
            tk_ops.kernel_matrix(x, x[:, :3], 1.0)
        with pytest.raises(ValueError):
            tk_ops.kernel_matrix(x, x, 1.0, kind="poly")
        with pytest.raises(ValueError):
            tk_ops.kernel_matrix(x[None], x[None], 1.0)
        with pytest.raises(TypeError):
            tk_ops.kernel_matrix(x.double(), x.double(), 1.0)


class TestSvmPredict:
    @pytest.mark.parametrize("kind", ["gauss_rbf", "laplacian"])
    @pytest.mark.parametrize("p", [1, 6, None])
    @pytest.mark.parametrize("nt,ns,d", [(20, 72, 7), (1, 130, 3),
                                         (129, 1, 54)])
    def test_matches_pallas_and_oracle(self, nt, ns, d, p, kind):
        rng = np.random.default_rng(nt * 1000 + ns)
        x = rng.normal(size=(nt, d)).astype(np.float32)
        sv = rng.normal(size=(ns, d)).astype(np.float32)
        co = rng.normal(size=(ns,) if p is None else (ns, p)).astype(
            np.float32)
        gamma = 1.7
        j = [jnp.asarray(a) for a in (x, sv, co)]
        pal = np.asarray(js_ops.svm_predict(*j, gamma, kind=kind,
                                            force_pallas=True))
        orc = np.asarray(js_ops.svm_predict(*j, gamma, kind=kind))
        before = dict(ts_ops.launches)
        got = _np(ts_ops.svm_predict(_t(x), _t(sv), _t(co), gamma,
                                     kind=kind))
        assert ts_ops.launches == before        # the CPU runs no kernel
        assert got.shape == pal.shape == ((nt,) if p is None else (nt, p))
        tol = 1e-5 * max(1.0, float(np.abs(orc).max()))
        assert np.abs(got - pal).max() <= tol
        assert np.abs(got - orc).max() <= tol

    def test_one_cell_of_the_multi_cell_entry(self, inputs):
        """B8 is B3 at one cell with one gamma in every column; 1-D coefs
        give the first column of the 2-D call."""
        xt, sv, co = (_t(inputs[n][1]) for n in ("xt", "sv", "co"))
        got = ts_ops.svm_predict(xt, sv, co, 0.9)
        cells = ts_ops.svm_predict_cells(xt[None], sv[None], co[None],
                                         torch.full((1, P), 0.9))[0]
        np.testing.assert_allclose(_np(got), _np(cells),
                                   atol=1e-5 * float(cells.abs().max()))
        one = ts_ops.svm_predict(xt, sv, co[:, 0].contiguous(), 0.9)
        assert one.shape == (M,)
        np.testing.assert_allclose(_np(one), _np(got[:, 0]),
                                   atol=1e-5 * float(got.abs().max()))

    def test_rejects_mismatched_shapes(self, inputs):
        xt, sv, co = (_t(inputs[n][0]) for n in ("xt", "sv", "co"))
        with pytest.raises(ValueError):
            ts_ops.svm_predict(xt, sv[:5], co, 1.0)
        with pytest.raises(ValueError):
            ts_ops.svm_predict(xt, sv[:, :3], co, 1.0)
        with pytest.raises(ValueError):
            ts_ops.svm_predict(xt, sv, co[None], 1.0)
        with pytest.raises(ValueError):
            ts_ops.svm_predict(xt, sv, co, 1.0, kind="poly")


class TestCDWrappers:
    def _problem(self, s=2, f=3, n=12, p=4):
        rng = np.random.default_rng(5)
        x = rng.normal(size=(s, n, 2)).astype(np.float32)
        k = np.exp(-((x[:, :, None] - x[:, None]) ** 2).sum(-1))
        lo = -rng.uniform(0, 1, size=(s, f, n, p)).astype(np.float32)
        hi = rng.uniform(0, 1, size=(s, f, n, p)).astype(np.float32)
        c = np.zeros((s, f, n, p), np.float32)
        g = -rng.normal(size=(s, f, n, p)).astype(np.float32)
        return [_t(a.astype(np.float32)) for a in (k, c, g, lo, hi)]

    def test_cpu_runs_the_plain_sweep_and_counts_nothing(self):
        from repro_torch.kernels.cd_solver import ref as tc_ref
        k, c, g, lo, hi = self._problem()
        before = dict(tc_ops.launches)
        got = tc_ops.cd_wave_epoch(k, c, g, lo, hi)
        want = tc_ref.cd_wave_epoch_ref(k, c, g, lo, hi)
        assert tc_ops.launches == before
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        one = tc_ops.cd_epoch(k[1], c[1, 2], g[1, 2], lo[1, 2], hi[1, 2])
        assert torch.equal(one[0], got[0][1, 2])
        assert torch.equal(one[1], got[1][1, 2])

    def test_rejects_mismatched_operands(self):
        k, c, g, lo, hi = self._problem()
        with pytest.raises(ValueError):
            tc_ops.cd_wave_epoch(k[:, :5], c, g, lo, hi)
        with pytest.raises(ValueError):
            tc_ops.cd_wave_epoch(k, c, g[:, :2], lo, hi)
        with pytest.raises(TypeError):
            tc_ops.cd_wave_epoch(k.double(), c, g, lo, hi)

    @pytest.mark.parametrize("n,p,bc", [(1824, 70, 16), (100, 3, 3),
                                        (4000, 70, 4), (14000, 1, 1)])
    def test_block_columns_fit_shared_memory(self, n, p, bc):
        """The kernel keeps g in registers: a thread's rows (480 of them
        cover n) times the block's columns stay within 64."""
        assert tc_ops.block_cols(n, p) == bc
        assert bc * tc_ops.thread_rows(n) <= 64
        assert 480 * tc_ops.thread_rows(n) >= n
        # 8 columns where 16-column blocks would leave SMs idle (B5's row)
        assert tc_ops.block_cols(1824, 350, 1, 132) == 8
        assert tc_ops.block_cols(1824, 350, 16, 132) == 16
        with pytest.raises(ValueError):
            tc_ops.block_cols(60000, 4)


def _panel_sweep(k, c, g, lo, hi, panel, bc):
    """B4's kernel order in plain PyTorch (a test model, on no path): each
    block takes ``bc`` of a slot's F x P columns (folds packed together);
    per panel of ``panel`` coordinates a sweeper updates only the panel's
    rows of g, with the panel's diagonal block of K, and publishes the
    deltas; the bulk then applies them in coordinate order to the next
    panel's rows first (the look-ahead) and then to every other row, each
    product and sum rounded on its own, K read by rows.  Asserts that the
    bulk's copy of the panel rows equals the sweeper's."""
    s, f, n, p = c.shape

    def cols(t):
        return t.permute(0, 2, 1, 3).reshape(s, n, f * p).clone()
    cc, gg, ll, hh = (cols(t) for t in (c, g, lo, hi))
    diag = torch.clamp(torch.diagonal(k, dim1=-2, dim2=-1), min=1e-12)
    for j0 in range(0, f * p, bc):
        js = slice(j0, min(j0 + bc, f * p))
        for i0 in range(0, n, panel):
            i1 = min(i0 + panel, n)
            gp = gg[:, i0:i1, js].clone()
            dl = []
            for t in range(i1 - i0):
                i = i0 + t
                ci = cc[:, i, js]
                tg = torch.clamp(ci - gp[:, t] / diag[:, i, None],
                                 min=ll[:, i, js], max=hh[:, i, js])
                dl.append(tg - ci)
                cc[:, i, js] = tg
                gp = gp + k[:, i, i0:i1, None] * dl[-1][:, None, :]
            ahead = torch.arange(i1, min(i1 + panel, n))
            rest = torch.tensor([r for r in range(n)
                                 if not i1 <= r < i1 + panel], dtype=torch.long)
            for rows in (ahead, rest):
                for t, d in enumerate(dl):
                    gg[:, rows, js] = (gg[:, rows, js]
                                       + k[:, i0 + t, rows, None] * d[:, None])
            assert torch.equal(gg[:, i0:i1, js], gp)

    def back(t):
        return t.reshape(s, n, f, p).permute(0, 2, 1, 3).contiguous()
    return back(cc), back(gg)


@pytest.mark.parametrize("n,panel,bc", [
    (203, 32, 16),      # n not a multiple of the panel, P > bc
    (203, 7, 16),
    (203, 1, 5),        # one-coordinate panels, columns straddle folds
    (203, 64, 16),
    (203, 256, 16),     # n < panel
    (29, 32, 1),        # n < panel, one column a block
])
def test_panel_sweep_order_is_bitwise_the_exact_sweep(n, panel, bc):
    """The kernel's blocked schedule (panels, look-ahead, folds packed into
    column blocks) gives the exact sweep's c and g bit for bit: an element
    of g depends only on the order of its own updates.  Padding coordinates
    (lo == hi == 0) stay 0."""
    from repro_torch.kernels.cd_solver import ref as tc_ref
    rng = np.random.default_rng(n + panel + bc)
    s, f, p, pad = 2, 3, 19, 5
    x = rng.normal(size=(s, n, 3))
    d2 = ((x[:, :, None] - x[:, None]) ** 2).sum(-1)
    a = _t(np.exp(-d2 / 3.0).astype(np.float32))
    k = a + a.transpose(1, 2)                      # symmetric bit for bit
    y = np.sign(rng.normal(size=(s, 1, n, 1)))
    cost = rng.uniform(0.1, 3.0, size=(s, f, 1, p))
    lo = _t(np.minimum(y * cost, 0.0).astype(np.float32))
    hi = _t(np.maximum(y * cost, 0.0).astype(np.float32))
    lo[:, :, n - pad:] = 0.0
    hi[:, :, n - pad:] = 0.0
    c = torch.clamp(_t(rng.normal(size=(s, f, n, p)).astype(np.float32)),
                    min=lo, max=hi)
    g = (tc_ops.slot_matmul(k, c) - _t(y.astype(np.float32))).contiguous()
    kc, kg, pc, pg = c, g, c, g
    for _ in range(2):
        kc, kg = _panel_sweep(k, kc, kg, lo, hi, panel, bc)
        pc, pg = tc_ref.cd_wave_epoch_ref(k, pc, pg, lo, hi)
    assert torch.equal(kc, pc) and torch.equal(kg, pg)
    assert not kc[:, :, n - pad:].any()
    assert (kc != c).any()


class TestNoSilentCpuFallback:
    def test_no_gpu_raises_for_default_and_cuda_device(self, monkeypatch):
        from repro_torch.serve import ModelBank, SVMEngine
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError):
            runtime.resolve_device(None)
        with pytest.raises(RuntimeError):
            runtime.resolve_device("cuda")
        rng = np.random.default_rng(1)
        bank = ModelBank.from_cells(
            rng.normal(size=(2, 8, 3)).astype(np.float32),
            np.ones((2, 8), np.float32),
            rng.normal(size=(2, 8, 1, 1)).astype(np.float32),
            np.ones((2, 1, 1), np.float32),
            rng.normal(size=(2, 3)).astype(np.float32))
        with pytest.raises(RuntimeError):
            SVMEngine(bank)
        with pytest.raises(RuntimeError):
            SVMEngine(bank, device="cuda")
        assert runtime.resolve_device("cpu").type == "cpu"

    def test_non_cpu_tensor_never_takes_the_plain_path(self):
        """Dispatch goes by the tensor's device: anything that is not a CPU
        tensor goes to a kernel or raises — here a meta tensor raises."""
        x = torch.empty((2, 4, 3), device="meta")
        with pytest.raises(ValueError):
            tk_ops.sq_dists(x, x)
        with pytest.raises(ValueError):
            tk_ops.gram_from_d2(torch.empty((4, 4), device="meta"), 1.0)
        co = torch.empty((2, 4, 2), device="meta")
        with pytest.raises(ValueError):
            ts_ops.svm_predict_cells(x, x, co,
                                     torch.empty((2, 2), device="meta"))
        with pytest.raises(ValueError):
            tk_ops.sq_dists(x, x, symmetric=True)
        with pytest.raises(ValueError):
            tk_ops.kernel_matrix(x[0], x[0], 1.0)
        with pytest.raises(ValueError):
            ts_ops.svm_predict(x[0], x[0], co[0], 1.0)
        k = torch.empty((2, 4, 4), device="meta")
        c = torch.empty((2, 1, 4, 3), device="meta")
        with pytest.raises(ValueError):
            tc_ops.cd_wave_epoch(k, c, c, c, c)


def _flash_bf16_p_emulation(q, k, v, mask_kind, window, block_k=64):
    """The arithmetic of B9's bf16 kernel in plain PyTorch: S = Q K^T on
    bf16 inputs with f32 sums, f32 online softmax over kv tiles of
    ``block_k``, P rounded to bf16 before P V, l the sum of the f32 P;
    returns bf16 (B, T, H, D)."""
    b, t, h, d = q.shape
    s, hk = k.shape[1], k.shape[2]
    g = h // hk
    qf = q.float().reshape(b, t, hk, g, d)
    kf, vf = k.float(), v.float()
    allowed = tf_ref.attention_mask(t, s, mask_kind, window)
    m = torch.full((b, hk, g, t, 1), tf_ref.NEG_INF)
    l = torch.zeros((b, hk, g, t, 1))
    acc = torch.zeros((b, hk, g, t, d))
    for c0 in range(0, s, block_k):
        c1 = min(c0 + block_k, s)
        logit = torch.einsum("bthgd,bshd->bhgts", qf, kf[:, c0:c1]) * d ** -0.5
        logit = torch.where(allowed[:, c0:c1], logit,
                            torch.tensor(tf_ref.NEG_INF))
        m_new = torch.maximum(m, logit.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(logit - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        pv = torch.einsum("bhgts,bshd->bhgtd", p.to(torch.bfloat16).float(),
                          vf[:, c0:c1])
        acc = acc * alpha + pv
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(b, t, h, d).to(torch.bfloat16)


@pytest.mark.parametrize("mask_kind,window,t,s,h,hk", [
    ("causal", 0, 300, 300, 4, 2),
    ("causal", 0, 100, 260, 2, 1),       # T != S: rows offset by S - T
    ("window", 64, 200, 200, 4, 2),
    ("window", 100, 150, 290, 2, 2),
    ("bidir", 0, 100, 260, 4, 2),
])
def test_flash_bf16_p_arithmetic_within_the_card_budget(mask_kind, window, t,
                                                         s, h, hk):
    rng = np.random.default_rng(t + s)
    d = 64
    q, k, v = (rng.normal(size=(2, n, hh, d)).astype(np.float32)
               for n, hh in ((t, h), (s, hk), (s, hk)))
    tq, tk, tv = (_t(a).to(torch.bfloat16) for a in (q, k, v))
    got = _flash_bf16_p_emulation(tq, tk, tv, mask_kind, window)
    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    pallas = np.asarray(jf_ops.flash_attention(
        jq, jk, jv, mask_kind=mask_kind, window=window,
        force_pallas=True).astype(jnp.float32))
    budget = 2.0 ** -7 * max(1.0, float(np.abs(pallas).max()))
    assert np.abs(_np(got) - pallas).max() <= budget
    plain = tf_ref.flash_attention_ref(tq, tk, tv, mask_kind, window)
    assert (got.float() - plain.float()).abs().max() <= budget
    # value by value: the output roundings, 2^-8 |o| on each side, and the
    # bf16 P, 2^-8 sum_j p_j |v_j| / l (the plain attention of |v|)
    a = tf_ref.flash_attention_ref(tq.float(), tk.float(), tv.float().abs(),
                                   mask_kind, window)
    bnd = 2.0 ** -7 * plain.float().abs() + (2.0 ** -8 + 2.0 ** -14) * a
    assert bool(((got.float() - plain.float()).abs() <= bnd).all())


@pytest.mark.parametrize("s", [1, 7, 300, 5000])
def test_decode_visible_range_is_the_reference_mask(s):
    """B10's wrapper hands the kernel one run of ring positions; it holds
    exactly the keys the plain version's mask lets through."""
    from repro_torch.kernels.decode_attention import ops as td_ops
    idx = torch.arange(s)
    for pos in sorted({0, 1, s // 2, s - 1, s, s + 3, 2 * s + 1, 3 * s - 1}):
        for window in (0, 1, 5, s - 1, s, s + 9, 1024):
            valid = (idx <= pos) | (pos >= s)
            if window > 0:
                valid &= torch.remainder(pos - idx, s) < window
            s0, nvis = td_ops.visible_range(s, pos, window)
            run = torch.zeros(s, dtype=torch.bool)
            run[(s0 + torch.arange(nvis)) % s] = True
            assert nvis >= 1 and 0 <= s0 < s
            assert torch.equal(run, valid), (pos, window)


@pytest.mark.parametrize("pairs,nvis,n_sm,want", [
    (256, 320, 132, 1),       # the LM path's decode step: no split
    (512, 32768, 132, 1),     # B=16 long context
    (32, 32768, 132, 16),     # B=1 long context: at most 4 blocks an SM
    (2, 1024, 132, 4),        # a short window caps it at 256 keys a split
    (2, 32768, 132, 64),      # capped by the kernel's 64
    (1, 100, 132, 1),         # too few keys to split
])
def test_decode_split_count(pairs, nvis, n_sm, want):
    from repro_torch.kernels.decode_attention import ops as td_ops
    got = td_ops.split_count(pairs, nvis, n_sm)
    assert got == want
    assert 1 <= got <= td_ops.SPLIT_MAX
    if got > 1:
        assert nvis // got >= td_ops.SPLIT_MIN_KEYS


@pytest.mark.parametrize("b,hk,d,cache,nvis,want", [
    (8, 32, 64, torch.bfloat16, 320, 1),      # the LM path's decode step
    (16, 32, 64, torch.bfloat16, 32768, 2),   # long: 256-byte runs a key
    (1, 32, 64, torch.bfloat16, 32768, 1),    # too few blocks for 2
    (8, 32, 64, torch.int8, 320, 2),          # 64-byte rows fill a line
    (16, 32, 64, torch.int8, 32768, 4),
    (1, 2, 256, torch.int8, 1024, 1),         # rows of a line or more
    (3, 3, 16, torch.int8, 300, 1),           # Hk odd
    (3, 2, 64, torch.float32, 32768, 1),
])
def test_decode_heads_per_block(b, hk, d, cache, nvis, want):
    from repro_torch.kernels.decode_attention import ops as td_ops
    got = td_ops.heads_per_block(b, hk, d, cache, nvis, 132)
    assert got == want and hk % got == 0


def test_import_leaves_no_jax_and_no_reference_modules():
    """Importing every module of the port pulls in neither jax nor any
    module of the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch, repro_torch.serve\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n in ('jax', 'repro', 'jaxlib')\n"
        "             or n.startswith(('jax.', 'repro.', 'jaxlib.')))\n"
        "print(len([n for n in sys.modules if n.startswith('repro_torch')]))\n"
        "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout.splitlines()
    assert int(out[0]) >= 20
    assert out[1] == "[]"
