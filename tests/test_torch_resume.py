"""Kill-anywhere resume of the port's wave-scheduled fit, on the CPU.

The counterparts of ``test_faults.py::TestWaveResume``: a fit killed at
any wave or checkpoint-write boundary and run again with the same
``ckpt_dir`` restores the finished waves and solves the rest, and the
resumed models equal an uninterrupted fit's bitwise (every wave's solve
is deterministic, and a restored wave hands over the very arrays a solved
one does).  A wave whose shard fails its checksum is solved again; waves
left by another run (fingerprint, wave size or slot count) are ignored.
The re-solve of a resumed session (``select("npl")``, ``test``) reads the
back-filled slots of the restored waves and must equal an uninterrupted
session's bitwise too.  One case holds the port's resumed fit against the
JAX package's resumed fit on the same data (tolerances as in
``test_torch_train.py``: same plan and winners, decisions within 5e-3).
"""
from __future__ import annotations

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import select as j_select  # noqa: E402
from repro.testing import faults as j_faults  # noqa: E402
from repro.train.svm_trainer import LiquidSVM as JLiquid  # noqa: E402
from repro.train.svm_trainer import SVMTrainerConfig as JConfig  # noqa: E402
from repro_torch import cli, obs  # noqa: E402
from repro_torch.api import SVM  # noqa: E402
from repro_torch.api.session import TrainResult  # noqa: E402
from repro_torch.core import cv as t_cv  # noqa: E402
from repro_torch.core import select as t_select  # noqa: E402
from repro_torch.data.synthetic import covtype_like  # noqa: E402
from repro_torch.distributed import cell_trainer  # noqa: E402
from repro_torch.testing import faults  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train.svm_trainer import LiquidSVM, SVMTrainerConfig  # noqa: E402


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


CPU = "cpu"
# the reference's TestWaveResume fit, on a coarser grid (every 2nd gamma
# and lambda) to keep the file quick: 4 cells in 2 waves of 2 slots
KW = dict(n_folds=2, max_iters=150, cell_method="voronoi", cell_size=120,
          n_slots_per_wave=2, adaptivity_control=1)
N_WAVES = 2
COUNTERS = ("train.waves_solved", "train.waves_restored",
            "train.corrupt_waves")
TRAIN_ARRAYS = ("x_cells", "mask_cells", "y_cells", "tmask_cells",
                "gammas_cells", "coefs", "gamma", "lam", "tau", "val_loss",
                "surf_loss", "surf_fa", "surf_det", "iters")


def _data(seed: int = 0):
    x, y = covtype_like(n=600, d=4, seed=seed, label_noise=0.02, n_modes=3)
    y = np.where(y == 0, -1, 1)
    return x[:450], y[:450], x[450:]


def _fit(ckpt_dir=None, y_flip: bool = False, **over):
    x, y, _ = _data()
    cfg = SVMTrainerConfig(**{**KW, **over})
    return LiquidSVM(cfg, device=CPU).fit(x, -y if y_flip else y,
                                          ckpt_dir=ckpt_dir)


def _counts():
    return np.asarray([obs.metrics.counter(c).value for c in COUNTERS])


def _assert_same_fit(got, want):
    _, _, xte = _data()
    for name in TRAIN_ARRAYS:
        a, b = getattr(got.train_result, name), getattr(want.train_result,
                                                        name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    np.testing.assert_array_equal(got.decision_function(xte),
                                  want.decision_function(xte))


@pytest.fixture(scope="module")
def uninterrupted():
    return _fit()


@pytest.mark.parametrize("site,at_hit,restored", [
    ("trainer.wave.start", 1, 0),           # killed before any progress
    ("trainer.wave.start", 2, 1),           # wave 0 done and saved
    ("trainer.wave.solved", 1, 0),          # solved, not yet checkpointed
    ("checkpoint.save.post_shard", 1, 0),   # mid checkpoint write
    ("checkpoint.save.pre_rename", 2, 1),   # the 2nd wave's save mid-write
])
def test_kill_anywhere_resume_is_bitwise_identical(tmp_path, uninterrupted,
                                                   site, at_hit, restored):
    ck = os.fspath(tmp_path / "waves")
    with pytest.raises(faults.InjectedFault):
        with faults.armed(site, at_hit=at_hit):
            _fit(ck)
    before = _counts()
    resumed = _fit(ck)
    assert list(_counts() - before) == [N_WAVES - restored, restored, 0]
    assert ckpt.list_steps(ck) == list(range(N_WAVES))
    _assert_same_fit(resumed, uninterrupted)


def test_corrupt_wave_checkpoint_is_resolved(tmp_path, uninterrupted):
    """Bit rot in one wave's shard: that wave is solved again (and its
    checkpoint rewritten), the other restores, the model is unchanged."""
    ck = os.fspath(tmp_path / "waves")
    _fit(ck)
    assert ckpt.list_steps(ck) == list(range(N_WAVES))
    shard = os.path.join(ck, "step_00000000", "shard_0.npz")
    with np.load(shard) as z:
        arrays = {k: z[k].copy() for k in z.files}
    arrays["leaf_0"][0] ^= 0xFF             # the zip stays valid
    np.savez(shard, **arrays)
    assert not ckpt.verify_step(ck, 0)
    before = _counts()
    resumed = _fit(ck)
    assert list(_counts() - before) == [1, N_WAVES - 1, 1]
    assert ckpt.verify_step(ck, 0)
    _assert_same_fit(resumed, uninterrupted)


def test_stale_fingerprint_is_resolved(tmp_path, uninterrupted):
    """Waves left by a fit on other labels are ignored, then overwritten."""
    ck = os.fspath(tmp_path / "waves")
    _fit(ck, y_flip=True)
    before = _counts()
    resumed = _fit(ck)
    assert list(_counts() - before) == [N_WAVES, 0, 0]
    _assert_same_fit(resumed, uninterrupted)
    before = _counts()
    _fit(ck)                                # now every wave is this fit's
    assert list(_counts() - before) == [0, N_WAVES, 0]


def _tiny_stage(n_slots: int, k: int = 12, d: int = 3, n_gamma: int = 3):
    """A stage function over seeded slots: (x, y, tmask, mask, gammas,
    keys) for slots [lo, hi), empty padding past ``n_slots``."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(n_slots, k, d)).astype(np.float32)
    y = np.sign(rng.normal(size=(n_slots, 1, k))).astype(np.float32)
    gam = np.tile(np.float32([2.0, 1.0, 0.5]), (n_slots, 1))
    keys = np.arange(2 * n_slots, dtype=np.uint32).reshape(n_slots, 2)

    def stage(lo, hi):
        w, top = hi - lo, min(hi, n_slots)
        out = [np.zeros((w, k, d), np.float32),
               np.zeros((w, 1, k), np.float32),
               np.zeros((w, 1, k), np.float32),
               np.zeros((w, k), np.float32),
               np.ones((w, n_gamma), np.float32),
               np.zeros((w, 2), np.uint32)]
        out[0][:top - lo] = x[lo:top]
        out[1][:top - lo] = y[lo:top]
        out[2][:top - lo] = 1.0
        out[3][:top - lo] = 1.0
        out[4][:top - lo] = gam[lo:top]
        out[5][:top - lo] = keys[lo:top]
        return tuple(out)
    return stage


def _waves(ck, n_slots, wave, fingerprint):
    cfg = t_cv.CVConfig(n_folds=2, max_iters=60, keep_surface=True)
    lam_c, sub_c, task_c = (torch.tensor([1e-1, 1e-3]), torch.ones(2),
                            torch.zeros(2, dtype=torch.int64))
    return cell_trainer.train_cells_waves(
        _tiny_stage(n_slots), n_slots, wave, lam_c, sub_c, task_c, cfg, 2, 1,
        torch.device(CPU), ckpt_dir=ck, fingerprint=fingerprint)


@pytest.mark.parametrize("change", ["fingerprint", "wave_size", "n_slots"])
def test_mismatched_waves_are_ignored(tmp_path, change):
    """Each wave is matched on its own manifest: a different fingerprint,
    wave size or slot count restores nothing and solves every wave."""
    ck = os.fspath(tmp_path / "waves")
    n_slots, wave, fp = 4, 2, "a"
    want = _waves(None, n_slots, wave, fp)
    got = _waves(ck, n_slots, wave, fp)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    other = {"fingerprint": (4, 2, "b"), "wave_size": (4, 1, "a"),
             "n_slots": (3, 2, "a")}[change]
    before = _counts()
    _waves(ck, *other)
    n_other = -(-other[0] // other[1])
    assert list(_counts() - before) == [n_other, 0, 0]
    before = _counts()
    again = _waves(ck, *other)               # its own waves now restore
    assert list(_counts() - before) == [0, n_other, 0]
    for a, b in zip(again, _waves(None, *other)):
        np.testing.assert_array_equal(a, b)


def test_torn_manifest_is_skipped(tmp_path):
    ck = os.fspath(tmp_path / "waves")
    want = _waves(ck, 4, 2, "a")
    with open(os.path.join(ck, "step_00000001", "manifest.json"), "w") as f:
        f.write('{"torn')
    before = _counts()
    got = _waves(ck, 4, 2, "a")
    assert list(_counts() - before) == [1, 1, 0]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_resumed_session_selects_and_tests_bitwise(tmp_path):
    """npl re-solves moved winners from the back-filled slots of restored
    waves: the resumed session's selection, stats and test equal an
    uninterrupted session's."""
    x, y, _ = _data()
    xte_all, yte_all = covtype_like(n=600, d=4, seed=0, label_noise=0.02,
                                    n_modes=3)
    xte, yte = xte_all[450:], np.where(yte_all[450:] == 0, -1, 1)
    kw = dict(KW, scenario="npsvm", weights=(0.5, 1.0, 2.0))

    def session(ck=None):
        sess = SVM(x, y, config=SVMTrainerConfig(**kw), device=CPU)
        sess.train(ckpt_dir=ck)
        return sess

    ref = session()
    ck = os.fspath(tmp_path / "waves")
    with pytest.raises(faults.InjectedFault):
        with faults.armed("trainer.wave.start", at_hit=2):
            session(ck)
    resumed = session(ck)
    for name in TRAIN_ARRAYS:
        np.testing.assert_array_equal(getattr(resumed.train_result, name),
                                      getattr(ref.train_result, name))
    sr, ss = ref.select("npl", alpha=0.05), resumed.select("npl", alpha=0.05)
    assert ss.stats == sr.stats and sr.stats["columns_resolved"] > 0
    np.testing.assert_array_equal(ss.coefs, sr.coefs)
    np.testing.assert_array_equal(ss.decision_function(xte),
                                  sr.decision_function(xte))
    tr_, ts_ = ref.test(xte, yte), resumed.test(xte, yte)
    assert ts_.error == tr_.error and ts_.details == tr_.details


def test_cli_train_resumable_killed_and_rerun(tmp_path, capsys):
    x, y, _ = _data()
    np.save(tmp_path / "x.npy", x)
    np.save(tmp_path / "y.npy", y)

    def train(model_dir):
        argv = ["train", "--data", str(tmp_path / "x.npy"), "--labels",
                str(tmp_path / "y.npy"), "--model-dir", model_dir,
                "--resumable", "--device", CPU, "-S", "FOLDS=2",
                "-S", "MAX_ITERATIONS=150", "-S", "ADAPTIVITY_CONTROL=1",
                "-S", "VORONOI=voronoi", "-S", "CELL_SIZE=120",
                "-S", "WAVE_SLOTS=2"]
        assert cli.main(argv) == 0
        return json.loads(capsys.readouterr().out)

    ref_dir, md = str(tmp_path / "ref"), str(tmp_path / "model")
    train(ref_dir)
    with pytest.raises(faults.InjectedFault):
        with faults.armed("checkpoint.save.pre_rename", at_hit=2):
            train(md)
    capsys.readouterr()
    before = _counts()
    out = train(md)
    assert out["stage"] == "train"
    assert list(_counts() - before) == [1, 1, 0]
    assert ckpt.list_steps(os.path.join(md, "waves")) == [0, 1]
    got = TrainResult.load(os.path.join(md, "train"), device=CPU)
    want = TrainResult.load(os.path.join(ref_dir, "train"), device=CPU)
    for name in TRAIN_ARRAYS:
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name))


def test_resumed_fit_matches_reference_resumed_fit(tmp_path):
    """Both packages killed at the second wave's start and resumed: the
    same plan and argmin winners, decisions within 5e-3."""
    x, y, xte = _data()
    ck_j, ck_t = os.fspath(tmp_path / "j"), os.fspath(tmp_path / "t")
    with pytest.raises(j_faults.InjectedFault):
        with j_faults.armed("trainer.wave.start", at_hit=2):
            JLiquid(JConfig(**KW)).fit(x, y, ckpt_dir=ck_j)
    ref = JLiquid(JConfig(**KW)).fit(x, y, ckpt_dir=ck_j)
    with pytest.raises(faults.InjectedFault):
        with faults.armed("trainer.wave.start", at_hit=2):
            _fit(ck_t)
    port = _fit(ck_t)
    jt, tt = ref.train_result, port.train_result
    for f in ("indices", "mask", "owner", "centers"):
        assert np.array_equal(getattr(jt.plan, f), getattr(tt.plan, f))
    gj, lj = j_select.argmin_winners(jt.surf_loss)
    gt, lt = t_select.argmin_winners(tt.surf_loss)
    assert np.array_equal(gj, gt) and np.array_equal(lj, lt)
    dj, dt = ref.decision_function(xte), port.decision_function(xte)
    assert np.abs(dt - dj).max() <= 5e-3 * max(1.0, np.abs(dj).max())
