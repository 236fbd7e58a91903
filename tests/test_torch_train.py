"""The port's training slice against the JAX package's, on the CPU.

Each test hands the same numpy inputs, made from a seed, to the JAX
function and its counterpart in ``repro_torch``.  On the CPU the port's
kernel wrappers run their plain PyTorch versions; the JAX side runs its
jnp oracles (its CD Pallas kernels no longer run on this jax, ROADMAP C1).

Tolerances and where they come from (measured at these shapes, seed 0):

* PRNG: ``split`` / ``uniform`` bitwise (fold masks are compared exactly);
  ``normal`` within 4 ulps (measured 2: jax's erfinv polynomial runs in
  XLA's f32 with its own log1p).
* D², grids, median heuristic: a few f32 ulps (another GEMM and pow).
* CD epochs: the port stores the clipped target (the Pallas body), the jnp
  oracle adds delta (``c_i + (target - c_i)`` can differ from the target
  in the last bit) and XLA sums in its own order: 1e-5 of the largest
  coefficient (measured 1.3e-6 on coefficients ~2).
* Solvers, CV, fits: both sides run FISTA to the KKT tolerance ``tol``
  (1e-3 of the box width) with f32 products in another order, so they stop
  at the same or a neighbouring check and their iterates differ by a
  share of ``tol``, not by rounding: coefficients within 5e-3 of the box
  (measured 3e-4 of the box), decisions within 5e-3 of the largest
  decision (measured 1.4e-4).  Zero-one validation losses move in steps
  of one validation sample's share; the surfaces may differ by at most one
  such step per point (measured: none or one step), and the selected
  (gamma, lambda) indices must be identical (measured: identical in every
  case here).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import cv as j_cv  # noqa: E402
from repro.core import grids as j_grids  # noqa: E402
from repro.core import kernel_fns as j_kf  # noqa: E402
from repro.core import select as j_select  # noqa: E402
from repro.core import svm as j_svm  # noqa: E402
from repro.core.solvers import base as j_base  # noqa: E402
from repro.core.solvers import expectile as j_exp  # noqa: E402
from repro.core.solvers import hinge as j_hinge  # noqa: E402
from repro.core.solvers import least_squares as j_ls  # noqa: E402
from repro.core.solvers import quantile as j_q  # noqa: E402
from repro.kernels.cd_solver import ops as j_cd_ops  # noqa: E402
from repro.kernels.cd_solver import ref as j_cd_ref  # noqa: E402
from repro.kernels.kernel_matrix import ref as j_km_ref  # noqa: E402
from repro.pipeline.cell_stream import build_cells_stream as j_build  # noqa: E402
from repro.serve.svm_engine import SVMEngine as JEngine  # noqa: E402
from repro.train.svm_trainer import LiquidSVM as JLiquid  # noqa: E402
from repro.train.svm_trainer import SVMTrainerConfig as JConfig  # noqa: E402
from repro_torch.core import cv as t_cv  # noqa: E402
from repro_torch.core import grids as t_grids  # noqa: E402
from repro_torch.core import kernel_fns as t_kf  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core import select as t_select  # noqa: E402
from repro_torch.core import svm as t_svm  # noqa: E402
from repro_torch.core.solvers import base as t_base  # noqa: E402
from repro_torch.core.solvers import expectile as t_exp  # noqa: E402
from repro_torch.core.solvers import hinge as t_hinge  # noqa: E402
from repro_torch.core.solvers import least_squares as t_ls  # noqa: E402
from repro_torch.core.solvers import quantile as t_q  # noqa: E402
from repro_torch.data.synthetic import (banana_mc, covtype_like,  # noqa: E402
                                        covtype_like_heldout,
                                        covtype_like_mixture)
from repro_torch.kernels.cd_solver import ops as t_cd_ops  # noqa: E402
from repro_torch.kernels.cd_solver import ref as t_cd_ref  # noqa: E402
from repro_torch.kernels.kernel_matrix import ops as t_km_ops  # noqa: E402
from repro_torch.pipeline.cell_stream import build_cells_stream as t_build  # noqa: E402
from repro_torch.serve import SVMEngine  # noqa: E402
from repro_torch.train.convert import select_result_from_reference  # noqa: E402
from repro_torch.train.svm_trainer import LiquidSVM  # noqa: E402
from repro_torch.train.svm_trainer import SVMTrainerConfig  # noqa: E402


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


EPS = float(np.finfo(np.float32).eps)
CPU = "cpu"


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _j(a):
    return jnp.asarray(np.asarray(a))


def _ulps(a, b) -> int:
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max())


def _gram(rng, n, d=3, scale=2.0):
    x = rng.normal(size=(n, d)).astype(np.float32)
    k = np.exp(-((x[:, None] - x[None]) ** 2).sum(-1) / scale)
    return x, k.astype(np.float32)


# ---------------------------------------------------------------- PRNG
class TestPrng:
    @pytest.mark.parametrize("seed", [0, 1, 7, 123456789])
    @pytest.mark.parametrize("num", [1, 2, 26, 33])
    def test_split_bitwise(self, seed, num):
        want = np.asarray(jax.random.split(jax.random.PRNGKey(seed), num))
        assert np.array_equal(prng.PRNGKey(seed),
                              np.asarray(jax.random.PRNGKey(seed)))
        assert np.array_equal(prng.split(prng.PRNGKey(seed), num), want)

    @pytest.mark.parametrize("seed", [0, 3, 42])
    @pytest.mark.parametrize("n", [1, 7, 300, 1824])
    def test_uniform_bitwise(self, seed, n):
        key = prng.split(prng.PRNGKey(seed), 3)[2]
        want = np.asarray(jax.random.uniform(_j(key), (n,)))
        got = prng.uniform(key, n)
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32))

    def test_uniform_batched_keys_bitwise(self):
        keys = prng.split(prng.PRNGKey(5), 4)
        got = prng.uniform(keys, 50)
        for i in range(4):
            want = np.asarray(jax.random.uniform(_j(keys[i]), (50,)))
            assert np.array_equal(got[i].view(np.uint32),
                                  want.view(np.uint32))

    @pytest.mark.parametrize("n", [5, 300, 1824])
    def test_normal_to_f32_rounding(self, n):
        want = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (n,)))
        got = prng.normal(prng.PRNGKey(0), n)
        assert _ulps(got, want) <= 4


# -------------------------------------------------- kernel matrix layer
class TestKernelMatrix:
    @pytest.mark.parametrize("n,d", [(1, 3), (37, 5), (130, 54)])
    def test_symmetric_matches_oracle_and_is_symmetric(self, n, d):
        x = np.random.default_rng(n).normal(size=(n, d)).astype(np.float32)
        want = np.asarray(j_km_ref.sq_dists_ref(_j(x), _j(x), symmetric=True))
        got = t_km_ops.sq_dists(_t(x), _t(x), symmetric=True)
        assert torch.equal(got, got.T)
        tol = 8 * EPS * max(float(want.max()), 1.0)
        assert np.abs(got.numpy() - want).max() <= tol

    def test_symmetric_batched_equals_per_slot(self):
        x = _t(np.random.default_rng(1).normal(size=(3, 20, 4)))
        x = x.to(torch.float32)
        got = t_km_ops.sq_dists(x, x, symmetric=True)
        for s in range(3):
            assert torch.equal(got[s], t_km_ops.sq_dists(x[s], x[s],
                                                         symmetric=True))
        with pytest.raises(ValueError):
            t_km_ops.sq_dists(x, x[:, :5], symmetric=True)

    @pytest.mark.parametrize("kind", ["gauss_rbf", "laplacian"])
    def test_cached_gram_and_gram_for_gammas(self, kind):
        rng = np.random.default_rng(2)
        x = rng.normal(size=(30, 4)).astype(np.float32)
        z = rng.normal(size=(11, 4)).astype(np.float32)
        gammas = np.asarray([0.5, 1.3, 4.0], np.float32)
        want = np.asarray(j_kf.gram_for_gammas(_j(x), _j(x), _j(gammas),
                                               name=kind, symmetric=True))
        got = t_kf.gram_for_gammas(_t(x), _t(x), _t(gammas), name=kind,
                                   symmetric=True)
        # the two D² differ by a few ulps of the largest |x|^2 + |z|^2;
        # exp(-d2/g^2) turns dD2 into at most e^-1 dD2 / g^2 (Laplacian:
        # less), here ~4e-6 at g = 0.5
        dd2 = 8 * EPS * 2 * float((x * x).sum(1).max())
        tol = (dd2 / float(gammas.min()) ** 2 if kind == "gauss_rbf"
               else dd2 ** 0.5 / float(gammas.min()))
        assert np.abs(got.numpy() - want).max() <= tol
        cross = np.asarray(j_kf.cross_gram_fn(_j(x), _j(z), kind)(1.3))
        tcross = t_kf.cross_gram_fn(_t(x), _t(z), kind)(1.3)
        assert np.abs(tcross.numpy() - cross).max() <= tol
        cg = t_kf.CachedGram.build(_t(x), name=kind, d2_dtype="bf16")
        assert cg.d2.dtype == torch.bfloat16 and cg.nbytes == 30 * 30 * 2
        exact = t_kf.CachedGram.build(_t(x), name=kind).gram(1.3)
        # one bf16 rounding of d2 before the exp: at most e^-1 2^-8
        assert float((cg.gram(1.3) - exact).abs().max()) <= 2.0 ** -8

    def test_custom_kernel_without_epilogue(self):
        def poly(a, b, g):
            return (1.0 + a @ b.T / g) ** 2
        t_kf.register_kernel("poly2_test", poly)
        try:
            assert not t_kf.factors_through_d2("poly2_test")
            x = _t(np.random.default_rng(3).normal(size=(6, 2)))
            x = x.to(torch.float32)
            out = t_kf.gram_for_gammas(x, x, torch.tensor([1.0, 2.0]),
                                       name="poly2_test", symmetric=True)
            assert torch.allclose(out[1], poly(x, x, 2.0))
            with pytest.raises(ValueError):
                t_kf.CachedGram.build(x, name="poly2_test")
        finally:
            t_kf.unregister_kernel("poly2_test")

    @pytest.mark.parametrize("n,masked", [(40, False), (600, True),
                                          (1100, True)])
    def test_median_heuristic(self, n, masked):
        """jnp.nanmedian averages the two middle values; the port does too
        (``torch.nanmedian`` would return the lower one)."""
        rng = np.random.default_rng(n)
        x = rng.normal(size=(n, 5)).astype(np.float32)
        m = (rng.random(n) < 0.8).astype(np.float32) if masked else None
        want = float(j_kf.median_heuristic(_j(x), None if m is None
                                           else _j(m)))
        got = float(t_kf.median_heuristic(_t(x), None if m is None
                                          else _t(m)))
        assert abs(got - want) <= 4 * EPS * want

    @pytest.mark.parametrize("n,d,med,gc,cs", [(500, 54, 3.7, 0, 2000),
                                               (1824, 54, 8.1234, 0, 2000),
                                               (300, 2, 1.0, 1, None),
                                               (80, 7, 0.31, 2, 40)])
    def test_grids(self, n, d, med, gc, cs):
        a = j_grids.liquid_grid(n, d, med, gc, cs)
        b = t_grids.liquid_grid(n, d, med, gc, cs)
        assert _ulps(b.gammas.numpy(), a.gammas) <= 8
        assert np.array_equal(b.lambdas.numpy(), np.asarray(a.lambdas))
        la, lb = j_grids.libsvm_grid(n), t_grids.libsvm_grid(n)
        assert np.array_equal(lb.lambdas.numpy(), np.asarray(la.lambdas))
        assert _ulps(lb.gammas.numpy(), la.gammas) <= 1
        sa, sb = (j_grids.adaptive_subgrid(a, 1),
                  t_grids.adaptive_subgrid(b, 1))
        assert sb.shape == sa.shape


# ------------------------------------------------------------ CD epochs
def _box_problem(rng, n, p, pad=0):
    x, k = _gram(rng, n)
    y = rng.choice([-1.0, 1.0], size=n).astype(np.float32)
    cost = np.geomspace(0.1, 3.0, p).astype(np.float32)
    lo = np.minimum(0, y[:, None] * cost[None]).astype(np.float32)
    hi = np.maximum(0, y[:, None] * cost[None]).astype(np.float32)
    if pad:
        lo[n - pad:] = 0.0
        hi[n - pad:] = 0.0
    return k, y, lo, hi


class TestCD:
    @pytest.mark.parametrize("n,p,epochs", [(64, 3, 1), (97, 5, 3)])
    def test_cd_epochs_matches_oracle(self, n, p, epochs):
        k, y, lo, hi = _box_problem(np.random.default_rng(n), n, p)
        c0 = np.zeros((n, p), np.float32)
        want, _ = j_cd_ref.solve_cd_ref(_j(k), _j(y)[:, None], _j(lo),
                                        _j(hi), _j(c0), epochs)
        got = t_cd_ops.cd_epochs(_t(k), _t(y), _t(lo), _t(hi), _t(c0),
                                 epochs)
        assert float(np.abs(got.numpy() - np.asarray(want)).max()) <= \
            1e-5 * float(np.abs(hi - lo).max())

    def test_cd_epochs_wave_matches_wave_oracle_and_pads_stay_zero(self):
        rng = np.random.default_rng(5)
        probs = [_box_problem(rng, 70, 4, pad=6) for _ in range(3)]
        k, y, lo, hi = (np.stack(a) for a in zip(*probs))
        yb = np.broadcast_to(y[:, :, None], lo.shape).astype(np.float32)
        c0 = np.zeros_like(lo)
        want, _ = j_cd_ref.solve_cd_wave_ref(_j(k), _j(yb), _j(lo), _j(hi),
                                             _j(c0), 2)
        got = t_cd_ops.cd_epochs_wave(_t(k), _t(y), _t(lo), _t(hi), _t(c0),
                                      2)
        assert float(np.abs(got.numpy() - np.asarray(want)).max()) <= 1e-5 * 3
        assert not got[:, 70 - 6:].any()

    def test_cd_polish_matches_reference_polish(self):
        """The reference polishes with its delayed-update blocked sweep off
        the TPU; the port with the exact sweep: the same fixed point and
        coordinate order, another summation order."""
        rng = np.random.default_rng(6)
        k, y, lo, hi = _box_problem(rng, 90, 5)
        yb = np.broadcast_to(y[:, None], lo.shape).astype(np.float32)
        c0 = np.clip(rng.normal(size=lo.shape), lo, hi).astype(np.float32)
        want = np.asarray(j_cd_ops.cd_polish(_j(k), _j(yb), _j(lo), _j(hi),
                                             _j(c0), 3))
        got = t_cd_ops.cd_polish(_t(k)[None], _t(yb)[None, None],
                                 _t(lo)[None, None], _t(hi)[None, None],
                                 _t(c0)[None, None], 3)[0, 0]
        assert float(np.abs(got.numpy() - want).max()) <= 1e-5 * 3

    def test_blocked_sweep_matches_reference_blocked(self):
        rng = np.random.default_rng(7)
        k, y, lo, hi = _box_problem(rng, 64, 4)
        c0 = np.zeros_like(lo)
        g0 = (k @ c0 - y[:, None]).astype(np.float32)
        want, _ = j_cd_ref.cd_epoch_blocked_ref(_j(k), _j(c0), _j(g0), _j(lo),
                                                _j(hi))
        got, _ = t_cd_ref.cd_epoch_blocked_ref(_t(k), _t(c0), _t(g0), _t(lo),
                                               _t(hi))
        assert float(np.abs(got.numpy() - np.asarray(want)).max()) <= 1e-5 * 3

    def test_exact_sweep_descends_and_b5_equals_wave(self):
        rng = np.random.default_rng(8)
        k, y, lo, hi = _box_problem(rng, 50, 3, pad=4)
        kt, c, g = _t(k), torch.zeros(50, 3), -_t(y)[:, None].expand(50, 3)
        obj = []
        for _ in range(3):
            c1, g1 = t_cd_ops.cd_epoch(kt, c, g.contiguous(), _t(lo), _t(hi))
            wc, wg = t_cd_ops.cd_wave_epoch(kt[None], c[None, None],
                                            g.contiguous()[None, None],
                                            _t(lo)[None, None],
                                            _t(hi)[None, None])
            assert torch.equal(c1, wc[0, 0]) and torch.equal(g1, wg[0, 0])
            c, g = c1, g1
            obj.append(float(t_base.dual_objective(kt, _t(y), c)[0]))
        assert obj[0] <= obj[1] + 1e-5 and obj[1] <= obj[2] + 1e-5
        assert not c[46:].any()


# ---------------------------------------------------------------- solvers
class TestSolvers:
    def test_power_iteration(self):
        _, k = _gram(np.random.default_rng(9), 80)
        want = float(j_base.power_iteration_l(_j(k)))
        got = float(t_base.power_iteration_l(_t(k)))
        assert abs(got - want) <= 1e-5 * want
        assert got >= float(np.linalg.eigvalsh(k.astype(np.float64)).max())

    @pytest.mark.parametrize("solver", ["hinge", "quantile"])
    def test_box_qp_same_kkt_point(self, solver):
        rng = np.random.default_rng(10)
        n = 80
        x, k = _gram(rng, n)
        lam = np.geomspace(1, 1e-4, 6).astype(np.float32)
        mask = (rng.random(n) < 0.8).astype(np.float32)
        if solver == "hinge":
            y = np.sign(x[:, 0] + 0.3 * rng.normal(size=n)).astype(np.float32)
            a = j_hinge.solve_hinge(_j(k), _j(y), _j(lam), mask.sum(),
                                    train_mask=_j(mask))
            b = t_hinge.solve_hinge(_t(k), _t(y), _t(lam), mask.sum(),
                                    train_mask=_t(mask))
            lo, hi = t_hinge.hinge_boxes(_t(y), _t(lam), mask.sum(),
                                         train_mask=_t(mask))
        else:
            y = np.sin(x[:, 0]).astype(np.float32)
            taus = np.full(6, 0.3, np.float32)
            a = j_q.solve_quantile(_j(k), _j(y), _j(taus), _j(lam),
                                   mask.sum(), train_mask=_j(mask))
            b = t_q.solve_quantile(_t(k), _t(y), _t(taus), _t(lam),
                                   mask.sum(), train_mask=_t(mask))
            lo, hi = t_q.quantile_boxes(_t(taus), _t(lam), mask.sum(),
                                        train_mask=_t(mask))
        width = float((hi - lo).max())
        print(f"{solver}: iters reference {int(a.iters)} port "
              f"{int(b.iters)}")
        assert float(b.kkt.max()) <= 1e-3 and float(np.asarray(a.kkt).max()) <= 1e-3
        assert abs(int(a.iters) - int(b.iters)) <= 20
        assert float(np.abs(b.c.numpy() - np.asarray(a.c)).max()) <= 5e-3 * width

    def test_ls_eigh_path(self):
        rng = np.random.default_rng(11)
        x, k = _gram(rng, 70)
        y = np.sin(x[:, 0]).astype(np.float32)
        lam = np.geomspace(1, 1e-2, 5).astype(np.float32)
        mask = (rng.random(70) < 0.8).astype(np.float32)
        want = np.asarray(j_ls.solve_krr_eigh(_j(k), _j(y), _j(lam),
                                              mask.sum(), _j(mask)))
        got = t_ls.solve_krr_eigh(_t(k), _t(y), _t(lam), mask.sum(), _t(mask))
        assert float(np.abs(got.numpy() - want).max()) <= 1e-3 * max(
            1.0, float(np.abs(want).max()))
        chol = t_ls.solve_krr_chol(_t(k), _t(y), lam[2], mask.sum(),
                                   _t(mask))
        assert float((chol - got[:, 2]).abs().max()) <= 1e-3 * max(
            1.0, float(got.abs().max()))

    def test_ls_fold_masked_eigh_at_one_thread(self):
        """ROADMAP C9: f32 eigh of the fold-masked Gram M K M, with half
        its rows exactly zero, failed to converge on MKL at one intra-op
        thread (450 points in d 4, gamma 5; this module runs at one
        thread).  The solver decomposes M K M + I - M instead: batched
        over folds as ``cv`` calls it, masked coordinates keep c within
        the f32 noise of 0 (1e-4 of the largest |c|: measured 2.4e-5 here,
        the reference's own eigh of M K M 0.5e-5 to 1.0e-5 on such
        problems), and the trained coordinates equal the f64 solve of the
        trained block alone within 1e-3 of its largest |c| (measured
        7.4e-5; the reference 6e-5 to 1.5e-4)."""
        rng = np.random.default_rng(21)
        x = rng.normal(size=(450, 4))
        k = np.exp(-((x[:, None] - x[None]) ** 2).sum(-1) / 25.0)
        masks = np.stack([rng.random(450) < 0.5 for _ in range(2)])
        y = np.sin(x[:, 0]) * masks
        lam_n = np.asarray([[1e-3, 1e-1]] * 2) * masks.sum(1)[:, None]
        c = t_ls.krr_eigh_path(
            _t(k.astype(np.float32))[None], _t(y[..., None].repeat(2, -1)
                                               .astype(np.float32)),
            _t(lam_n.astype(np.float32)), _t(masks.astype(np.float32)))
        assert torch.isfinite(c).all()
        for f in range(2):
            tr = masks[f]
            assert float(c[f][~tr].abs().max()) <= 1e-4 * float(
                c[f].abs().max())
            kt = k[np.ix_(tr, tr)]
            for j in range(2):
                want = np.linalg.solve(kt + lam_n[f, j] * np.eye(tr.sum()),
                                       y[f][tr])
                err = np.abs(c[f][tr, j].numpy() - want).max()
                assert err <= 1e-3 * np.abs(want).max(), (f, j, err)

    def test_expectile_irls(self):
        rng = np.random.default_rng(12)
        x, k = _gram(rng, 60)
        y = (np.sin(x[:, 0]) + 0.1 * rng.normal(size=60)).astype(np.float32)
        taus = np.asarray([0.2, 0.5, 0.8], np.float32)
        lam = np.full(3, 1e-2, np.float32)
        want = np.asarray(j_exp.solve_expectile(_j(k), _j(y), _j(taus),
                                                _j(lam), 60.0))
        got = t_exp.solve_expectile(_t(k), _t(y), _t(taus), _t(lam), 60.0)
        assert float(np.abs(got.numpy() - want).max()) <= 1e-3 * max(
            1.0, float(np.abs(want).max()))

    @pytest.mark.parametrize("solver", ["hinge", "quantile"])
    def test_outside_box_start_matches_cold(self, solver):
        rng = np.random.default_rng(13)
        x, k = _gram(rng, 60)
        y = np.sign(x[:, 0]).astype(np.float32)
        lam = np.geomspace(1, 1e-2, 4).astype(np.float32)
        if solver == "hinge":
            lo, hi = t_hinge.hinge_boxes(_t(y), _t(lam), 60.0)
        else:
            lo, hi = t_q.quantile_boxes(_t(np.full(4, 0.4, np.float32)),
                                        _t(lam), 60.0, n=60)
        cold = t_base.box_qp(_t(k), _t(y), lo, hi, tol=1e-4, max_iters=4000)
        warm = t_base.box_qp(_t(k), _t(y), lo, hi, c0=10 * torch.ones(60, 4),
                             tol=1e-4, max_iters=4000)
        width = float((hi - lo).max())
        assert float((warm.c - cold.c).abs().max()) <= 1e-2 * width

    def test_bf16_gram_products_stay_f32(self):
        _, k = _gram(np.random.default_rng(14), 40)
        kb = _t(k).to(torch.bfloat16)
        c = torch.randn(1, 40, 3)
        out = t_base.kdot(kb[None], c)
        assert out.dtype == torch.float32
        want = np.asarray(j_base._kdot(_j(k).astype(jnp.bfloat16),
                                       _j(c[0].numpy())))
        assert float(np.abs(out[0].numpy() - want).max()) <= 1e-5 * max(
            1.0, float(np.abs(want).max()))

    def test_per_problem_stopping(self):
        """A problem that converges early is frozen at its own iteration
        count, as under the reference's vmapped while_loop."""
        rng = np.random.default_rng(15)
        _, k = _gram(rng, 50)
        y = torch.tensor(rng.choice([-1.0, 1.0], size=50), dtype=torch.float32)
        easy = torch.full((50, 2), 1e-3)
        hard = torch.full((50, 2), 50.0)
        hi = torch.stack([easy, hard])[None]                 # (1, 2, 50, 2)
        lo = -hi
        yb = y[None, None, :, None].expand(1, 2, 50, 2)
        res = t_base.box_qp_batched(_t(k)[None], yb, lo, hi, max_iters=500)
        single = [t_base.box_qp(_t(k), y, lo[0, f], hi[0, f], max_iters=500)
                  for f in range(2)]
        assert int(res.iters[0, 0]) < int(res.iters[0, 1])
        for f in range(2):
            assert int(res.iters[0, f]) == int(single[f].iters)
            assert torch.allclose(res.c[0, f], single[f].c, atol=1e-6)


# --------------------------------------------------------------------- CV
class TestFoldMasks:
    @pytest.mark.parametrize("scheme", ["random", "stratified", "blocks"])
    @pytest.mark.parametrize("n_folds", [3, 5])
    def test_bitwise(self, scheme, n_folds):
        rng = np.random.default_rng(16)
        n = 101
        mask = (np.arange(n) < 87).astype(np.float32)
        y = rng.choice([-1.0, 1.0], size=n).astype(np.float32)
        keys = prng.split(prng.PRNGKey(3), 4)
        got = t_cv.make_fold_masks(keys, _t(np.tile(mask, (4, 1))), n_folds,
                                   scheme, _t(np.tile(y, (4, 1))))
        for s in range(4):
            want = np.asarray(j_cv.make_fold_masks(_j(keys[s]), _j(mask),
                                                   n_folds, scheme, _j(y)))
            assert np.array_equal(got[s].numpy(), want)
        # a partition of the valid samples
        assert np.array_equal(got.sum(1).numpy(), np.tile(mask, (4, 1)) > 0)

    def test_grid_columns_task_major(self):
        grid = t_grids.liquid_grid(100, 3)
        cfg = t_cv.CVConfig(solver="quantile", taus=(0.1, 0.9))
        lam_c, sub_c, task_c, n_lam, n_sub = t_cv.grid_columns(grid, cfg, 3)
        jl, js, jt, _, _ = j_cv.grid_columns(
            j_grids.liquid_grid(100, 3),
            j_cv.CVConfig(solver="quantile", taus=(0.1, 0.9)), 3)
        assert np.array_equal(lam_c.numpy(), np.asarray(jl))
        assert np.array_equal(sub_c.numpy(), np.asarray(js))
        assert np.array_equal(task_c.numpy(), np.asarray(jt))


def _cv_wave(solver: str, cd_polish: int, gamma_scale: float = 1.0,
             **extra):
    rng = np.random.default_rng(17)
    s, n, d = 2, 66, 3
    x = rng.normal(size=(s, n, d)).astype(np.float32)
    mask = (np.arange(n)[None] < np.array([[66], [51]])).astype(np.float32)
    if solver == "hinge":
        y = np.sign(x[..., 0] * x[..., 1]
                    + 0.3 * rng.normal(size=(s, n))).astype(np.float32)
        y_tasks = np.stack([y, -y], 1) * mask[:, None]
    else:
        y_tasks = ((np.sin(2 * x[..., :1]).transpose(0, 2, 1)
                    + 0.1 * rng.normal(size=(s, 1, n))).astype(np.float32)
                   * mask[:, None])
    tmask = np.ones_like(y_tasks) * mask[:, None]
    kw = dict(solver=solver, n_folds=3, keep_surface=True,
              cd_polish=cd_polish, taus=(0.3, 0.7), max_iters=300)
    kw.update(extra)
    jc, tc = j_cv.CVConfig(**kw), t_cv.CVConfig(**kw)
    gammas = np.stack([np.asarray(j_grids.liquid_grid(
        int(mask[i].sum()), d, float(j_kf.median_heuristic(
            _j(x[i]), _j(mask[i])))).gammas) for i in range(s)]) * gamma_scale
    keys = prng.split(prng.PRNGKey(0), s)
    lam_c, sub_c, task_c, nl, ns = j_cv.grid_columns(
        j_grids.liquid_grid(n, d, 1.0), jc, y_tasks.shape[1])
    ref = [j_cv.cv_cell(_j(x[i]), _j(y_tasks[i]), _j(tmask[i]), _j(mask[i]),
                        _j(gammas[i]), lam_c, sub_c, task_c, _j(keys[i]), jc,
                        n_lam=nl, n_sub=ns) for i in range(s)]
    tl, tsub, ttask, nl2, ns2 = t_cv.grid_columns(
        t_grids.liquid_grid(n, d, 1.0), tc, y_tasks.shape[1])
    out = t_cv.cv_cell(_t(x), _t(y_tasks), _t(tmask), _t(mask), _t(gammas),
                       tl, tsub, ttask, keys, tc, nl2, ns2)
    return ref, out, mask


@pytest.mark.parametrize("solver,cd_polish", [("hinge", 2), ("quantile", 0),
                                              ("ls", 0), ("expectile", 0)])
def test_cv_cell_same_selection(solver, cd_polish):
    ref, out, mask = _cv_wave(solver, cd_polish)
    for s, r in enumerate(ref):
        jg, jl = j_select.argmin_winners(np.asarray(r.val_grid)[None])
        tg, tl = t_select.argmin_winners(out.val_grid[s:s + 1].numpy())
        assert np.array_equal(jg, tg) and np.array_equal(jl, tl)
        want, got = np.asarray(r.val_grid), out.val_grid[s].numpy()
        if solver == "hinge":
            # zero-one losses: at most one validation sample's share apart
            share = 1.0 / (3 * np.floor(mask[s].sum() / 3))
            assert np.abs(got - want).max() <= share + 1e-6
            # the counts move by the same flipped samples
            assert np.abs(out.fa_grid[s].numpy()
                          - np.asarray(r.fa_grid)).max() <= 1
        elif solver == "ls":
            # tiny-lambda KRR amplifies f32 eigh noise on both sides:
            # hold the selected value, and the surface in the median
            assert abs(float(out.val_loss[s].min())
                       - float(np.asarray(r.val_loss).min())) <= 1e-3
            assert np.median(np.abs(got - want)) <= 1e-3
        else:
            assert np.abs(got - want).max() <= 1e-3 * max(1.0, want.max())
        assert np.array_equal(out.lam[s].numpy(), np.asarray(r.lam))
        assert _ulps(out.gamma[s].numpy(), r.gamma) <= 0


def _hinge_selection_agrees(ref, out, mask):
    for s, r in enumerate(ref):
        jg, jl = j_select.argmin_winners(np.asarray(r.val_grid)[None])
        tg, tl = t_select.argmin_winners(out.val_grid[s:s + 1].numpy())
        assert np.array_equal(jg, tg) and np.array_equal(jl, tl)
        share = 1.0 / (3 * np.floor(mask[s].sum() / 3))
        assert np.abs(out.val_grid[s].numpy()
                      - np.asarray(r.val_grid)).max() <= share + 1e-6
        assert np.array_equal(out.lam[s].numpy(), np.asarray(r.lam))
        assert _ulps(out.gamma[s].numpy(), r.gamma) <= 0


def test_cv_cell_bf16_gram_within_one_share():
    """gram_dtype="bf16": both sides write each gamma's K in bfloat16 (the
    port through B2's bf16 output) and form the solver's products in f32.

    The bf16-rounded K is indefinite at the wide gammas (smallest
    eigenvalue about -4e-3 on a 66-point Gram), so neither side's FISTA
    reaches tol within max_iters (3000 tried): both are cut mid-trajectory
    and their f32 rounding differences grow along it (~5e-4 of the box
    after 300 iterations, where f32 K gives 1e-6).  Held to what that
    allows, measured at this seed: the surfaces within two validation
    samples' share per point (measured 2), the selected loss within one
    (measured 1).  Selection flips are printed and listed in ROADMAP C."""
    ref, out, mask = _cv_wave("hinge", 2, gram_dtype="bf16")
    assert out.val_grid.dtype == torch.float32
    for s, r in enumerate(ref):
        share = 1.0 / (3 * np.floor(mask[s].sum() / 3))
        want, got = np.asarray(r.val_grid), out.val_grid[s].numpy()
        assert np.isfinite(got).all()
        assert np.abs(got - want).max() <= 2 * share + 1e-6
        gap = float(np.abs(out.val_loss[s].numpy()
                           - np.asarray(r.val_loss)).max())
        jg, jl = j_select.argmin_winners(want[None])
        tg, tl = t_select.argmin_winners(got[None])
        flips = int((jg != tg).sum() + (jl != tl).sum())
        print(f"slot {s}: {flips} flipped indices, selected-loss gap "
              f"{gap / share:.2f} samples")
        assert gap <= share + 1e-6


def test_cv_cell_custom_kernel_without_epilogue():
    """A kernel registered without a D² epilogue is evaluated in full per
    gamma on both sides (the port passes (S, 1, 1) gammas for the wave)."""
    def j_poly(a, b, g):
        return (1.0 + a @ b.T / g) ** 2 / (1.0 + 3.0 / g) ** 2

    def t_poly(a, b, g):
        return ((1.0 + a @ b.transpose(-1, -2) / g) ** 2
                / (1.0 + 3.0 / g) ** 2)
    j_kf.register_kernel("poly2_cv_test", j_poly)
    t_kf.register_kernel("poly2_cv_test", t_poly)
    try:
        ref, out, mask = _cv_wave("hinge", 0, kernel="poly2_cv_test")
    finally:
        j_kf.unregister_kernel("poly2_cv_test")
        t_kf.unregister_kernel("poly2_cv_test")
    _hinge_selection_agrees(ref, out, mask)


def test_train_select_single_working_set():
    x, y = banana_mc(n=300, n_classes=2, seed=3)
    y = np.where(y == 0, -1.0, 1.0).astype(np.float32)
    cfg_kw = dict(n_folds=3, max_iters=300)
    jm = j_svm.train_select(x, y, cfg=j_cv.CVConfig(**cfg_kw))
    tm = t_svm.train_select(x, y, cfg=t_cv.CVConfig(**cfg_kw), device=CPU)
    xt, yt = banana_mc(n=200, n_classes=2, seed=4)
    yt = np.where(yt == 0, -1.0, 1.0).astype(np.float32)
    assert np.array_equal(tm.lam.numpy(), np.asarray(jm.lam))
    assert _ulps(tm.gamma.numpy(), jm.gamma) <= 4
    dj = np.asarray(jm.decision_function(xt))
    dt = tm.decision_function(xt).numpy()
    assert np.abs(dt - dj).max() <= 5e-3 * np.abs(dj).max()
    assert abs(t_svm.test_error(tm, xt, yt)
               - float(j_svm.test_error(jm, xt, yt))) <= 2 / 200


# ------------------------------------------------------------- cell plans
@pytest.mark.parametrize("method", ["none", "random", "voronoi", "overlap",
                                    "recursive", "coarse_fine"])
def test_cell_plans_bitwise(method):
    x, _ = covtype_like(n=1500, d=8, n_classes=3, seed=1)
    a = j_build(x, cell_size=300, method=method, seed=0, coarse_size=700)
    b = t_build(x, cell_size=300, method=method, seed=0, coarse_size=700)
    for f in ("indices", "mask", "owner", "centers", "coarse_of"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f


def test_covtype_heldout_draws_the_same_mixture():
    """The held-out rows come from covtype_like's own mixture: its mode
    parameters are reproduced draw for draw."""
    rng = np.random.default_rng(4)
    per = 840 // 18
    modes = covtype_like_mixture(840, 5, 3, 4)
    for c in range(3):
        for m in range(6):
            mean = rng.normal(0, 1.6, 5)
            a = rng.normal(0, 1, (5, 5)) / np.sqrt(5)
            rng.normal(size=(per, 5))
            assert np.array_equal(modes[c * 6 + m][1], mean)
            assert np.array_equal(modes[c * 6 + m][2], 0.55 * a + 0.45 * np.eye(5))
    xh, yh = covtype_like_heldout(500, n=840, d=5, n_classes=3, seed=4,
                                  new_seed=2)
    assert xh.shape == (500, 5) and set(np.unique(yh)) <= {0, 1, 2}


# ------------------------------------------------------- end to end fits
_FITS = {
    "ova": dict(data="covtype", scenario="ova"),
    "ava": dict(data="covtype", scenario="ava"),
    "banana": dict(data="banana", scenario="ova"),
    "quantile": dict(data="regression", scenario="quantile"),
}


def _data(kind):
    if kind == "covtype":
        x, y = covtype_like(n=324, d=6, n_classes=3, seed=1)
        xt, yt = covtype_like_heldout(300, n=324, d=6, n_classes=3, seed=1,
                                      new_seed=2)
    elif kind == "banana":
        x, y = banana_mc(n=320, n_classes=4, seed=0)
        xt, yt = banana_mc(n=300, n_classes=4, seed=1)
    else:
        from repro_torch.data.synthetic import regression_1d
        x, y = regression_1d(n=300, seed=0)
        xt, yt = regression_1d(n=200, seed=1)
    return x, y, xt, yt


@pytest.fixture(scope="module", params=sorted(_FITS))
def fitted(request):
    spec = _FITS[request.param]
    x, y, xt, yt = _data(spec["data"])
    kw = dict(scenario=spec["scenario"], cell_method="recursive",
              cell_size=120, n_folds=3, max_iters=200, n_slots_per_wave=2,
              cd_polish=2 if request.param == "ova" else 0,
              taus=(0.1, 0.5, 0.9))
    ref = JLiquid(JConfig(**kw)).fit(x, y)
    port = LiquidSVM(SVMTrainerConfig(**kw), device=CPU).fit(x, y)
    return request.param, ref, port, xt, yt


def test_fit_same_plan_keys_and_selection(fitted):
    name, ref, port, _, _ = fitted
    jt, tt = ref.train_result, port.train_result
    for f in ("indices", "mask", "owner", "centers"):
        assert np.array_equal(getattr(jt.plan, f), getattr(tt.plan, f))
    assert np.array_equal(np.asarray(jt.fold_keys), tt.fold_keys)
    assert np.array_equal(jt.packed.order, tt.packed.order)
    assert np.abs(jt.gammas_cells - tt.gammas_cells).max() <= \
        8 * EPS * jt.gammas_cells.max()
    gj, lj = j_select.argmin_winners(jt.surf_loss)
    gt, lt = t_select.argmin_winners(tt.surf_loss)
    assert np.array_equal(gj, gt) and np.array_equal(lj, lt), name
    assert np.array_equal(jt.lam, tt.lam)


def test_fit_same_decisions_and_error(fitted):
    name, ref, port, xt, yt = fitted
    dj, dt = ref.decision_function(xt), port.decision_function(xt)
    assert dt.shape == dj.shape
    assert np.abs(dt - dj).max() <= 5e-3 * max(1.0, np.abs(dj).max()), name
    ej, et = ref.error(xt, yt), port.error(xt, yt)
    print(f"{name}: test error reference {ej:.4f} port {et:.4f}")
    assert abs(ej - et) <= (2.0 / len(yt) if name != "quantile" else 1e-3)


def _reference_arrays(ref):
    sel = ref.select_result
    arrays = {k: np.asarray(getattr(sel, k)) for k in
              ("x_cells", "mask_cells", "coefs", "gamma", "lam", "tau",
               "val_loss")}
    arrays.update(centers=sel.plan.centers, order=sel.packed.order,
                  scaler_mean=np.asarray(sel.scaler.mean),
                  scaler_std=np.asarray(sel.scaler.std),
                  classes=np.asarray(sel.tasks.classes),
                  pairs=np.asarray(sel.tasks.pairs))
    meta = {"config": dataclasses.asdict(sel.config),
            "cv_cfg": dataclasses.asdict(sel.cv_cfg), "rule": sel.rule}
    return arrays, meta


def _sum_abs_coefs(ref) -> float:
    """The largest sum of |coef| over a cell column: a decision is a sum of
    coef * K terms (K <= 1), so two f32 evaluations of one model in
    another order differ by a few ulps of this, not of the decision."""
    return float(np.abs(np.asarray(ref.select_result.coefs)).sum(1).max())


def test_converted_selection_same_decisions(fitted):
    """The reference's model in the port: the same decisions up to f32
    rounding of the predict (one model, another GEMM order; measured 4e-8
    of the largest sum of |coef|)."""
    name, ref, _, xt, _ = fitted
    conv = select_result_from_reference(*_reference_arrays(ref), device=CPU)
    dj = ref.decision_function(xt)
    dt = conv.decision_function(xt)
    assert np.abs(dt - dj).max() <= 8 * EPS * _sum_abs_coefs(ref), name
    if name != "quantile":
        assert np.array_equal(conv.predict(xt), ref.predict(xt))


def test_to_bank_serves_like_the_reference_engine(fitted):
    name, ref, _, xt, _ = fitted
    conv = select_result_from_reference(*_reference_arrays(ref), device=CPU)
    want = JEngine(ref.to_bank(), fused=False).predict(xt)
    got = SVMEngine(conv.to_bank(), device=CPU).predict(xt)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 8 * EPS * _sum_abs_coefs(ref)


def test_fit_tracer_times_each_wave_by_stage():
    """With the tracer on, every training wave is a ``train.wave`` span
    whose stages nest inside it (on the card they carry CUDA-event times;
    here the host's)."""
    from repro_torch import obs
    x, y = covtype_like(n=240, d=4, n_classes=2, seed=0)
    cfg = SVMTrainerConfig(scenario="ova", cell_method="recursive",
                           cell_size=100, n_folds=3, max_iters=40,
                           n_slots_per_wave=2, cd_polish=1)
    obs.tracer.clear()
    obs.tracer.enabled = True
    try:
        model = LiquidSVM(cfg, device=CPU).fit(x, y)
        rows = obs.tracer.breakdown_ms("train.wave")
    finally:
        obs.tracer.enabled = False
        obs.tracer.clear()
    n_waves = -(-model.train_result.packed.n_slots // 2)
    assert [r["attrs"]["wave"] for r in rows] == list(range(n_waves))
    stages = ("train.stage", "train.d2", "train.epilogue", "train.fista",
              "train.polish", "train.select")
    for r in rows:
        assert all(r[k] >= 0.0 for k in stages)
        assert sum(r[k] for k in stages) <= r["train.wave"] + 1e-6


def test_liquid_svm_needs_a_card_or_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        LiquidSVM(SVMTrainerConfig())
    with pytest.raises(RuntimeError):
        LiquidSVM(SVMTrainerConfig(), device="cuda")
    assert LiquidSVM(SVMTrainerConfig(), device=CPU).device.type == "cpu"


def test_unported_paths_raise():
    """The device mesh, the last training path that raised, is ported
    (``test_torch_mesh.py`` runs it on gloo ranks), as are per-wave
    ``ckpt_dir`` resume (``test_torch_resume.py``) and the npl / roc rules
    (``test_torch_session.py``).  What still raises is a mesh the call
    cannot use: a wave that does not divide over the ranks of the named
    axes (before any slot is staged), and a mesh of another device type
    than the operands."""
    from types import SimpleNamespace
    from repro_torch.distributed import cell_trainer as t_ct
    cfg = t_cv.CVConfig()
    four = SimpleNamespace(mesh_dim_names=("data",), shape=(4,),
                           device_type="cpu")
    with pytest.raises(ValueError, match="do not divide over 4"):
        t_ct.train_cells_waves(lambda lo, hi: None, 2, 2, None, None, None,
                               cfg, 1, 1, CPU, mesh=four,
                               axis_names=("data",))
    with pytest.raises(ValueError, match="cuda mesh"):
        t_ct.predict_cells(torch.zeros((4, 1, 2)), None, None, None,
                           mesh=SimpleNamespace(device_type="cuda"))
    assert t_select.get_rule("npl") is t_select.rule_npl


def test_checkpoint_of_named_tuples_matches_the_reference(tmp_path):
    """``(params, OptState)``: the port writes a named tuple's fields as
    ``.name`` (``tree_flatten_with_path``'s paths), rebuilds the named
    tuple on restore, and either package loads the other's checkpoint
    bitwise (bf16 and 0-d int32 leaves included)."""
    from repro.train import checkpoint as j_ckpt
    from repro.train import optimizer as j_opt
    from repro_torch.train import checkpoint as t_ckpt
    from repro_torch.train import optimizer as t_opt
    rng = np.random.default_rng(5)
    a = rng.normal(size=(3, 4)).astype(np.float32)
    n = rng.normal(size=(4,)).astype(np.float32)
    jp = {"a": jnp.asarray(a, jnp.bfloat16), "n": jnp.asarray(n)}
    tp = {"a": _t(a).bfloat16(), "n": _t(n)}
    jo = j_opt.init_opt_state(jp, j_opt.OptConfig())._replace(
        step=jnp.int32(7))
    to = t_opt.init_opt_state(tp, t_opt.OptConfig())._replace(
        step=torch.tensor(7, dtype=torch.int32))
    j_ckpt.save_checkpoint(str(tmp_path / "j"), 7, (jp, jo))
    t_ckpt.save_checkpoint(str(tmp_path / "t"), 7, (tp, to))
    jm = j_ckpt.peek_manifest(str(tmp_path / "j"))
    tm = t_ckpt.peek_manifest(str(tmp_path / "t"))
    assert tm["paths"] == jm["paths"]
    assert "[1]/.master/['a']" in tm["paths"] and "[1]/.step" in tm["paths"]
    assert (tm["dtypes"], tm["checksums"]) == (jm["dtypes"], jm["checksums"])
    for src in ("j", "t"):
        (rp, ro), step, _ = t_ckpt.restore_checkpoint(str(tmp_path / src),
                                                      (tp, to))
        assert isinstance(ro, t_opt.OptState) and step == 7
        assert int(ro.step) == 7 and torch.equal(rp["a"], tp["a"])
        assert torch.equal(torch.as_tensor(ro.master["a"]), to.master["a"])
        (rp, ro), _, _ = j_ckpt.restore_checkpoint(str(tmp_path / src),
                                                   (jp, jo))
        assert isinstance(ro, j_opt.OptState) and int(ro.step) == 7
        np.testing.assert_array_equal(np.asarray(ro.master["n"]), n)
