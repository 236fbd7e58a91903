"""The port's cell-construction pipeline against the JAX package's, on the CPU.

The same numpy inputs, made from a seed, go through ``repro.pipeline`` and
``repro_torch.pipeline``: the memmap source, ``assign_stream`` with each
backend, ``lloyd_stream`` and ``minibatch_kmeans``.  The reference's
"pallas" backend runs its kernel in interpret mode, as
``tests/test_pipeline.py`` runs it; the port's "torch" and "kernel"
backends run at ``device="cpu"``, i.e. ``_assign_block`` and B6's plain
version.

Tolerances: owner ids, cell counts and Lloyd centers compare exactly
(the Lloyd update is the same numpy on both sides, so the centers are
bitwise equal wherever the ids agree).  ``minibatch_kmeans`` sums each
batch's rows per center in another order than the reference's
``segment_sum`` (a one-hot product): at these sizes (733 x 5, 8 centers,
8 steps of 128) the two differ by 1 ulp of the largest |center| (1.2e-7
on 1.5); the tolerance is 16 ulps of it.
"""
from __future__ import annotations

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.pipeline import assign as j_assign  # noqa: E402
from repro.pipeline import dataset as j_dataset  # noqa: E402
from repro_torch.kernels.assign import ops as t_assign_ops  # noqa: E402
from repro_torch.kernels.assign import ref as t_assign_ref  # noqa: E402
from repro_torch.pipeline import MemmapSource  # noqa: E402
from repro_torch.pipeline import assign as t_assign  # noqa: E402
from repro_torch.pipeline import dataset as t_dataset  # noqa: E402

EPS = float(np.finfo(np.float32).eps)
BACKENDS = [("numpy", "numpy"), ("torch", "jax"), ("kernel", "pallas")]


def _data(n=733, d=5, seed=0):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


@pytest.fixture(scope="module")
def x():
    return _data()


@pytest.fixture(scope="module")
def npy_path(tmp_path_factory, x):
    p = tmp_path_factory.mktemp("torch_pipe") / "x.npy"
    np.save(p, x)
    return os.fspath(p)


class TestMemmapSource:
    @pytest.mark.parametrize("chunk", [1, 97, 733, 10_000])
    def test_chunks_equal_the_reference(self, npy_path, x, chunk):
        mine = list(MemmapSource(npy_path).iter_chunks(chunk))
        theirs = list(j_dataset.MemmapSource(npy_path).iter_chunks(chunk))
        assert [lo for lo, _ in mine] == [lo for lo, _ in theirs]
        for (_, a), (_, b) in zip(mine, theirs):
            assert a.dtype == np.float32
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(
            np.concatenate([c for _, c in mine]), x)

    def test_gather_and_shape(self, npy_path, x):
        src = MemmapSource(npy_path)
        ids = np.array([5, 0, 732, 5, 100])
        np.testing.assert_array_equal(
            src.gather(ids), j_dataset.MemmapSource(npy_path).gather(ids))
        np.testing.assert_array_equal(src.gather(ids), x[ids])
        assert src.shape == x.shape

    def test_casts_other_dtypes_to_f32(self, tmp_path, x):
        p = tmp_path / "x64.npy"
        np.save(p, x.astype(np.float64))
        src = MemmapSource(p)
        _, chunk = next(src.iter_chunks(10))
        assert chunk.dtype == np.float32
        np.testing.assert_array_equal(src.gather([3]), x[[3]])

    @pytest.mark.parametrize("cut", ["body", "header"])
    def test_truncated_file_raises_as_the_reference(self, tmp_path, x, cut):
        p = tmp_path / f"trunc_{cut}.npy"
        np.save(p, x)
        raw = p.read_bytes()
        p.write_bytes(raw[:len(raw) // 2] if cut == "body" else raw[:40])
        with pytest.raises(j_dataset.DataSourceError, match=p.name):
            j_dataset.MemmapSource(p)
        with pytest.raises(t_dataset.DataSourceError, match=p.name):
            MemmapSource(p)

    def test_missing_file_raises(self, tmp_path):
        with pytest.raises(t_dataset.DataSourceError, match="nope.npy"):
            MemmapSource(tmp_path / "nope.npy")


class TestAssignStream:
    @pytest.mark.parametrize("mine,theirs", BACKENDS)
    def test_ids_equal_the_reference(self, x, mine, theirs):
        centers = _data(13, 5, seed=9)
        want = j_assign.assign_stream(x, centers, chunk_size=200,
                                      backend=theirs)
        got = t_assign.assign_stream(x, centers, chunk_size=160,
                                     backend=mine, device="cpu")
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            got, j_assign.nearest_center(x, centers, chunk_size=128))
        np.testing.assert_array_equal(
            np.bincount(got, minlength=13), np.bincount(want, minlength=13))

    @pytest.mark.parametrize("mine,theirs", BACKENDS)
    def test_memmap_source_equals_array(self, x, npy_path, mine, theirs):
        centers = _data(7, 5, seed=4)
        got = t_assign.assign_stream(MemmapSource(npy_path), centers,
                                     chunk_size=100, backend=mine,
                                     device="cpu")
        want = j_assign.assign_stream(j_dataset.MemmapSource(npy_path),
                                      centers, chunk_size=100,
                                      backend=theirs)
        np.testing.assert_array_equal(got, want)

    @pytest.mark.parametrize("mine,theirs", BACKENDS)
    def test_duplicated_centers_go_to_the_lowest_index(self, x, mine,
                                                       theirs):
        base = _data(6, 5, seed=3)
        centers = np.concatenate([base, base[::-1], base])   # 3 copies each
        rows = np.concatenate([base, x[:50]])                # exact ties too
        got = t_assign.assign_stream(rows, centers, chunk_size=17,
                                     backend=mine, device="cpu")
        want = j_assign.assign_stream(rows, centers, chunk_size=17,
                                      backend=theirs)
        np.testing.assert_array_equal(got, want)
        assert (got < 6).all()            # the first copy always wins
        np.testing.assert_array_equal(got[:6], np.arange(6))

    def test_kernel_wrapper_plain_path_counts_nothing(self, x):
        centers = torch.as_tensor(_data(13, 5, seed=9))
        before = dict(t_assign_ops.launches)
        got = t_assign_ops.assign(torch.as_tensor(x), centers)
        assert t_assign_ops.launches == before      # the CPU runs no kernel
        assert got.dtype == torch.int32
        assert torch.equal(got, t_assign_ref.assign_ref(torch.as_tensor(x),
                                                         centers))
        np.testing.assert_array_equal(
            t_assign.assign_kernel(x, centers.numpy(), device="cpu"),
            got.numpy())

    def test_device_path_does_not_clamp(self):
        """Like the Pallas body, the device path's d² is not clamped at 0:
        here a row lies within 2e-3 of two centers, the GEMM form rounds
        their d² to 0 and -0.0078, and the device backends of both
        packages take the negative one (index 1) while the host path
        clamps both to 0 and takes the lower index."""
        row = np.array([[-31.39228057861328, 145.80206298828125,
                         196.0258331298828]], np.float32)
        centers = np.array([[-31.390478134155273, 145.80337524414062,
                             196.02618408203125],
                            [-31.393489837646484, 145.80206298828125,
                             196.0264892578125]], np.float32)
        for mine, theirs in BACKENDS:
            got = t_assign.assign_stream(row, centers, backend=mine,
                                         device="cpu")
            want = j_assign.assign_stream(row, centers, backend=theirs)
            np.testing.assert_array_equal(got, want)
            assert int(got[0]) == (0 if mine == "numpy" else 1)

    def test_unknown_backend_names_the_counterpart(self, x):
        centers = _data(3, 5, seed=1)
        for bad, good in (("jax", "torch"), ("pallas", "kernel")):
            with pytest.raises(ValueError, match=repr(good)):
                t_assign.assign_stream(x, centers, backend=bad)
            with pytest.raises(ValueError, match=repr(good)):
                t_assign.lloyd_stream(x, centers, 1, backend=bad)
        with pytest.raises(ValueError, match="unknown backend"):
            t_assign.assign_stream(x, centers, backend="cuda")

    def test_no_card_raises(self, x, monkeypatch):
        """"torch", "kernel" and minibatch k-means run on the card unless
        the caller asks for the CPU: with no card they raise, never fall
        back; "numpy" needs no card."""
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        centers = _data(3, 5, seed=1)
        for backend in ("torch", "kernel"):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                t_assign.assign_stream(x, centers, backend=backend)
            with pytest.raises(RuntimeError, match="no CUDA device"):
                t_assign.lloyd_stream(x, centers, 1, backend=backend)
            with pytest.raises(RuntimeError):
                t_assign.assign_stream(x, centers, backend=backend,
                                       device="cuda")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_assign.minibatch_kmeans(x, 4, iters=1)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_assign.assign_kernel(x, centers)
        assert t_assign.assign_stream(x, centers).shape == (733,)

    def test_non_cpu_tensor_never_takes_the_plain_path(self):
        x = torch.empty((4, 3), device="meta")
        with pytest.raises(ValueError):
            t_assign_ops.assign(x, x)


class TestLloydStream:
    @pytest.mark.parametrize("mine,theirs", BACKENDS)
    def test_equals_the_reference(self, x, mine, theirs):
        init = _data(9, 5, seed=7)
        want = j_assign.lloyd_stream(x, init, iters=3, chunk_size=77,
                                     backend=theirs)
        got = t_assign.lloyd_stream(x, init, iters=3, chunk_size=120,
                                    backend=mine, device="cpu")
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)

    @pytest.mark.parametrize("backend", ["numpy", "torch", "kernel"])
    def test_chunk_invariant(self, x, backend):
        init = _data(9, 5, seed=7)
        runs = [t_assign.lloyd_stream(x, init, iters=3, chunk_size=cs,
                                      backend=backend, device="cpu")
                for cs in (77, 256, 733)]
        for r in runs[1:]:
            np.testing.assert_array_equal(runs[0], r)

    def test_empty_cell_keeps_its_center(self, x):
        init = np.concatenate([_data(4, 5, seed=2),
                               np.full((1, 5), 1e3, np.float32)])
        for backend in ("numpy", "kernel"):
            got = t_assign.lloyd_stream(x, init, iters=2, backend=backend,
                                        device="cpu")
            np.testing.assert_array_equal(got[4], init[4])

    def test_memmap_source_equals_array(self, x, npy_path):
        init = _data(9, 5, seed=7)
        a = t_assign.lloyd_stream(x, init, 2, backend="kernel",
                                  device="cpu")
        b = t_assign.lloyd_stream(MemmapSource(npy_path), init, 2,
                                  chunk_size=50, backend="kernel",
                                  device="cpu")
        np.testing.assert_array_equal(a, b)


class TestMinibatchKMeans:
    @pytest.mark.parametrize("seed", [5, 6])
    def test_matches_the_reference(self, x, seed):
        want = j_assign.minibatch_kmeans(x, 8, iters=8, batch_size=128,
                                         seed=seed)
        got = t_assign.minibatch_kmeans(x, 8, iters=8, batch_size=128,
                                        seed=seed, device="cpu")
        assert got.shape == want.shape == (8, 5)
        tol = 16 * EPS * float(np.abs(want).max())
        assert np.abs(got - want).max() <= tol

    def test_deterministic_and_source_independent(self, x, npy_path):
        a = t_assign.minibatch_kmeans(x, 8, iters=8, batch_size=128, seed=5,
                                      device="cpu")
        b = t_assign.minibatch_kmeans(MemmapSource(npy_path), 8, iters=8,
                                      batch_size=128, seed=5, device="cpu")
        c = t_assign.minibatch_kmeans(x, 8, iters=8, batch_size=128, seed=5,
                                      device="cpu")
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
        d = t_assign.minibatch_kmeans(x, 8, iters=8, batch_size=128, seed=6,
                                      device="cpu")
        assert not (a == d).all()

    def test_inertia_falls_below_the_initial_sample(self, x):
        a = t_assign.minibatch_kmeans(x, 8, iters=8, batch_size=128, seed=5,
                                      device="cpu")
        init = x[np.random.default_rng(5).choice(len(x), 8, replace=False)]

        def inertia(cen):
            return float(t_assign._d2_chunk(x, cen).min(1).mean())
        assert inertia(a) < inertia(init)

    def test_step_equals_the_reference_step(self, x):
        """One ``_mbk_step`` from the same state: the same ids, centers
        within the summation-order tolerance, counts exactly."""
        import jax.numpy as jnp
        rng = np.random.default_rng(3)
        centers = x[rng.choice(len(x), 6, replace=False)]
        counts = rng.integers(0, 5, 6).astype(np.float32)
        batch = x[np.sort(rng.choice(len(x), 200, replace=False))]
        jc, jn = j_assign._mbk_step(jnp.asarray(centers), jnp.asarray(counts),
                                    jnp.asarray(batch))
        tc, tn = t_assign._mbk_step(torch.as_tensor(centers),
                                    torch.as_tensor(counts),
                                    torch.as_tensor(batch))
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
        tol = 16 * EPS * float(np.abs(np.asarray(jc)).max())
        assert np.abs(tc.numpy() - np.asarray(jc)).max() <= tol
