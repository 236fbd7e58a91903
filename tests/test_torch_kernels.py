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

from repro.kernels.kernel_matrix import ops as jk_ops  # noqa: E402
from repro.kernels.kernel_matrix import ref as jk_ref  # noqa: E402
from repro.kernels.svm_predict import ops as js_ops  # noqa: E402
from repro.kernels.svm_predict import ref as js_ref  # noqa: E402
from repro_torch.kernels import runtime  # noqa: E402
from repro_torch.kernels.cd_solver import ops as tc_ops  # noqa: E402
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
                                        (4000, 70, 14), (14000, 1, 1)])
    def test_block_columns_fit_shared_memory(self, n, p, bc):
        assert tc_ops.block_cols(n, p) == bc
        assert 4 * (bc * n + bc) <= 227 * 1024
        with pytest.raises(ValueError):
            tc_ops.block_cols(60000, 4)


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
        k = torch.empty((2, 4, 4), device="meta")
        c = torch.empty((2, 1, 4, 3), device="meta")
        with pytest.raises(ValueError):
            tc_ops.cd_wave_epoch(k, c, c, c, c)


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
