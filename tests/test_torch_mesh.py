"""The port's several-device layer on CPU process groups: the mesh helpers,
the cell solve and the test-phase predict split over a ``DeviceMesh``, the
staged fit under a mesh (with kill-anywhere resume), and the int8
error-feedback all-reduce.  Ranks are local processes on gloo
(``repro_torch.launch.local.run_local``, one intra-op thread each).

Held against:
  * the port's unsharded solve of the same slots, bitwise: a slot's solve
    does not depend on the slots beside it (a converged problem is frozen),
    so each rank's block and the gathered wave equal the one-process
    solve;
  * the JAX package's unsharded solve (``mesh=None``) of the same slots:
    plans and selected grid indices equal, floats within C4's tolerances
    (``test_torch_train.py``);
  * ``test_distributed_svm.py``'s invariants for a fit under a mesh
    against the reference's unsharded fit, on its data and settings;
  * the JAX package's ``ef_psum`` under ``shard_map`` on 8 forced host
    devices (a subprocess, as ``test_train_substrate.py`` runs it).

The JAX package is imported inside the tests only: the rank processes
import this module and need torch alone.
"""
from __future__ import annotations

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
dist = pytest.importorskip("torch.distributed")
if not dist.is_available():
    pytest.skip("torch.distributed is not available", allow_module_level=True)

from repro_torch.launch.local import run_local  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"


# ---------------------------------------------------------- staged cells
def _cell_inputs(n: int = 640, d: int = 5, cell_size: int = 100,
                 n_dev: int = 4):
    """Numpy inputs of one wave of every slot, staged as the session
    stages them, packed for ``n_dev`` devices."""
    from repro_torch.core import grids, kernel_fns, prng
    from repro_torch.data.synthetic import covtype_like
    from repro_torch.distributed.planner import pack_cells
    from repro_torch.pipeline.cell_stream import build_cells_stream
    from repro_torch.tasks.builder import make_tasks
    x, y = covtype_like(n=n, d=d, seed=0, label_noise=0.02, n_modes=3)
    y = np.where(y == 0, -1, 1)
    plan = build_cells_stream(x, cell_size=cell_size, method="voronoi",
                              seed=0)
    packed = pack_cells(plan, n_dev)
    tasks = make_tasks(y, "binary")
    s, k, t = packed.n_slots, plan.k_max, tasks.n_tasks
    xc = np.zeros((s, k, d), np.float32)
    mc = np.zeros((s, k), np.float32)
    yc = np.zeros((s, t, k), np.float32)
    tm = np.zeros((s, t, k), np.float32)
    gam = np.ones((s, 10), np.float32)
    for slot, cid in enumerate(packed.order):
        if cid < 0:
            continue
        ids, m = plan.indices[cid], plan.mask[cid]
        xc[slot], mc[slot] = x[ids], m
        yc[slot] = tasks.labels[:, ids] * m[None]
        tm[slot] = tasks.task_mask[:, ids] * m[None]
        med = float(kernel_fns.median_heuristic(torch.from_numpy(xc[slot]),
                                                torch.from_numpy(m)))
        gam[slot] = grids.liquid_grid(int(m.sum()), d, med).gammas.numpy()
    keys = prng.split(prng.PRNGKey(0), s)
    return dict(x=xc, mask=mc, y=yc, tmask=tm, gammas=gam, keys=keys,
                n=int(k), d=d, n_tasks=t, plan=plan, packed=packed)


_CV = dict(solver="hinge", n_folds=3, keep_surface=True, max_iters=150)


def _port_args(inp):
    from repro_torch.core import cv, grids
    cfg = cv.CVConfig(**_CV)
    lam_c, sub_c, task_c, nl, ns = cv.grid_columns(
        grids.liquid_grid(inp["n"], inp["d"], 1.0), cfg, inp["n_tasks"])
    arrays = [torch.from_numpy(inp[k]) for k in ("x", "y", "tmask", "mask",
                                                 "gammas")]
    return arrays, inp["keys"], (lam_c, sub_c, task_c, cfg, nl, ns)


def _mesh22():
    from repro_torch.launch import mesh as mesh_mod
    return mesh_mod.make_mesh((2, 2), ("data", "model"), "cpu")


def _cells_job(inp, fit_data, resume_dir):
    """Every rank: the mesh helpers, train_cells / predict_cells under a
    (2, 2) mesh, each rank's own block solved alone, a staged fit under
    the mesh, and its kill-anywhere resume."""
    from repro_torch.distributed import cell_trainer as ct
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.testing import faults
    from repro_torch.train.svm_trainer import LiquidSVM, SVMTrainerConfig
    out = {}
    mesh = _mesh22()
    pod = mesh_mod.make_mesh((1, 2, 2), ("pod", "data", "model"), "cpu")
    out["helpers"] = {
        "batch_axes": (mesh_mod.batch_axes(mesh), mesh_mod.batch_axes(pod)),
        "n_batch_shards": (mesh_mod.n_batch_shards(mesh),
                           mesh_mod.n_batch_shards(pod)),
        "mesh_size": mesh_mod.mesh_size(mesh, ("data", "model")),
        "block": mesh_mod.block_index(mesh, ("data", "model"))}
    axes = ("data", "model")
    arrays, keys, rest = _port_args(inp)
    full = ct.train_cells(*arrays, keys, *rest, mesh=mesh, axis_names=axes)
    out["train"] = [r.numpy() for r in full]
    b = ct._block(arrays[0].shape[0], mesh, axes)
    out["block_slice"] = (b.start, b.stop)
    out["block_alone"] = [r.numpy() for r in ct.train_cells(
        *[a[b] for a in arrays], keys[b], *rest)]
    # the test phase: each slot's own training rows as queries
    xt = arrays[0][:, :24].contiguous()
    gam = torch.from_numpy(full[1].numpy())
    out["predict"] = ct.predict_cells(xt, arrays[0], full[0], gam,
                                      mesh=mesh, axis_names=axes).numpy()
    try:
        ct.train_cells_waves(None, 8, 3, *rest, torch.device(CPU),
                             mesh=mesh, axis_names=axes)
        out["bad_wave"] = None
    except ValueError as e:
        out["bad_wave"] = str(e)

    # the staged fit under the mesh (test_distributed_svm's settings)
    x, y, xte = fit_data
    cfg = SVMTrainerConfig(n_folds=3, max_iters=300, cell_method="voronoi",
                           cell_size=200, seed=0)
    m = LiquidSVM(cfg, device=CPU, mesh=mesh, mesh_axes=axes).fit(x, y)
    out["fit"] = {"gamma": m.gamma, "val_loss": m.val_loss,
                  "slot_of_cell": m.packed.slot_of_cell,
                  "n_cells": m.plan.n_cells,
                  "decisions": m.decision_function(xte)}

    # kill-anywhere resume under the mesh: waves of 4 slots (one a rank)
    rcfg = SVMTrainerConfig(n_folds=3, max_iters=150, cell_method="voronoi",
                            cell_size=100, seed=0, n_slots_per_wave=4)
    xr, yr = inp["fit_xy"]
    whole = LiquidSVM(rcfg, device=CPU, mesh=mesh, mesh_axes=axes).fit(
        xr, yr, ckpt_dir=os.path.join(resume_dir, "whole"))
    runs = {}
    for site, hit in (("trainer.wave.solved", 2), ("trainer.wave.start", 3)):
        d = os.path.join(resume_dir, site)
        try:
            with faults.armed(site, at_hit=hit):
                LiquidSVM(rcfg, device=CPU, mesh=mesh,
                          mesh_axes=axes).fit(xr, yr, ckpt_dir=d)
            killed = False
        except faults.InjectedFault:
            killed = True
        mesh_mod.barrier(mesh)
        again = LiquidSVM(rcfg, device=CPU, mesh=mesh, mesh_axes=axes).fit(
            xr, yr, ckpt_dir=d)
        runs[site] = (killed, again.coefs, again.val_loss, again.gamma)
    out["resume"] = {"whole": (whole.coefs, whole.val_loss, whole.gamma),
                     "runs": runs, "n_slots": whole.packed.n_slots}
    return out


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    from repro.data.synthetic import train_test_split
    from repro_torch.data.synthetic import covtype_like
    inp = _cell_inputs()
    x, y = covtype_like(n=1600, d=5, seed=0, label_noise=0.02, n_modes=3)
    y = np.where(y == 0, -1, 1)
    xtr, ytr, xte, yte = train_test_split(x, y, 0.25, 0)
    xr, yr = covtype_like(n=900, d=5, seed=1, label_noise=0.02, n_modes=3)
    inp["fit_xy"] = (xr, np.where(yr == 0, -1, 1))
    job_inp = {k: v for k, v in inp.items() if k not in ("plan", "packed")}
    outs = run_local(_cells_job, 4, job_inp, (xtr, ytr, xte),
                     str(tmp_path_factory.mktemp("resume")), timeout=420)
    return inp, outs, (xtr, ytr, xte, yte)


def _same(a, b) -> bool:
    return all(np.array_equal(np.asarray(u), np.asarray(v))
               for u, v in zip(a, b))


@pytest.mark.timeout(600)
def test_mesh_helpers_match_reference(cells):
    """``batch_axes`` and ``n_batch_shards`` as the reference computes them
    (``test_serve_and_launch.py::TestMeshHelpers``) on the same names and
    shapes; ``mesh_size`` and the row-major block index."""
    from types import SimpleNamespace
    from repro.launch import mesh as j_mesh
    _, outs, _ = cells
    ref = [SimpleNamespace(axis_names=("data", "model"),
                           shape={"data": 2, "model": 2}),
           SimpleNamespace(axis_names=("pod", "data", "model"),
                           shape={"pod": 1, "data": 2, "model": 2})]
    for r, o in enumerate(outs):
        h = o["helpers"]
        assert h["batch_axes"] == tuple(j_mesh.batch_axes(m) for m in ref)
        assert h["n_batch_shards"] == tuple(j_mesh.n_batch_shards(m)
                                            for m in ref)
        assert h["mesh_size"] == 4 and h["block"] == r


@pytest.mark.timeout(600)
def test_train_cells_bitwise_unsharded(cells):
    """Every rank returns the whole wave, bitwise equal to the port's
    one-process solve of the same ``pack_cells(plan, 4)`` slots; each
    rank's block equals that block solved alone."""
    from repro_torch.distributed import cell_trainer as ct
    inp, outs, _ = cells
    arrays, keys, rest = _port_args(inp)
    want = [r.numpy() for r in ct.train_cells(*arrays, keys, *rest)]
    for r, o in enumerate(outs):
        assert _same(o["train"], want), r
        lo, hi = o["block_slice"]
        assert (lo, hi) == (r * len(keys) // 4, (r + 1) * len(keys) // 4)
        assert _same(o["block_alone"], [w[lo:hi] for w in want]), r


@pytest.mark.timeout(600)
def test_train_cells_matches_reference(cells):
    """Against the JAX package's ``train_cells(mesh=None)`` on the same
    slots: the selected grid indices and lambdas equal; zero-one surfaces
    at most one validation sample's share apart; coefficients within 5e-3
    of the box (C4)."""
    import jax.numpy as jnp
    from repro.core import cv as j_cv
    from repro.core import grids as j_grids
    from repro.core import select as j_select
    from repro.distributed import cell_trainer as j_ct
    inp, outs, _ = cells
    jc = j_cv.CVConfig(**_CV)
    lam_c, sub_c, task_c, nl, ns = j_cv.grid_columns(
        j_grids.liquid_grid(inp["n"], inp["d"], 1.0), jc, inp["n_tasks"])
    ref = [np.asarray(a) for a in j_ct.train_cells(
        *[jnp.asarray(inp[k]) for k in ("x", "y", "tmask", "mask",
                                        "gammas", "keys")],
        lam_c, sub_c, task_c, jc, nl, ns)]
    got = outs[0]["train"]
    coefs, gamma, lam, _, val, surf = (got[0], got[1], got[2], got[3],
                                       got[4], got[5])
    jg, jl = j_select.argmin_winners(ref[5])
    tg, tl = j_select.argmin_winners(surf)
    assert np.array_equal(jg, tg) and np.array_equal(jl, tl)
    assert np.array_equal(lam, ref[2])
    assert np.array_equal(gamma, ref[1])
    share = 1.0 / (3 * np.floor(inp["mask"].sum(1).clip(min=3) / 3))
    assert (np.abs(surf - ref[5]).max(axis=(1, 2, 3, 4))
            <= share + 1e-6).all()
    err = float(np.abs(coefs - ref[0]).max())
    box = float(np.abs(ref[0]).max())
    print(f"train_cells vs reference: max |coef| diff {err:.3g} of the "
          f"largest |coef| {box:.3g}; val diff "
          f"{float(np.abs(val - ref[4]).max()):.3g}")
    assert err <= 5e-3 * box


@pytest.mark.timeout(600)
def test_predict_cells_bitwise_unsharded(cells):
    from repro_torch.distributed import cell_trainer as ct
    inp, outs, _ = cells
    x = torch.from_numpy(inp["x"])
    full = outs[0]["train"]
    want = ct.predict_cells(x[:, :24].contiguous(), x,
                            torch.from_numpy(full[0]),
                            torch.from_numpy(full[1])).numpy()
    for o in outs:
        assert np.array_equal(o["predict"], want)


@pytest.mark.timeout(600)
def test_wave_size_must_divide_over_ranks(cells):
    """A wave of 3 slots over 4 ranks raises on every rank."""
    _, outs, _ = cells
    for o in outs:
        assert o["bad_wave"] and "divide over 4" in o["bad_wave"]


@pytest.mark.timeout(600)
def test_fit_under_mesh_matches_reference_fit(cells):
    """``LiquidSVM(cfg, mesh=, mesh_axes=)`` on 4 ranks against the JAX
    package's unsharded fit, with ``test_distributed_svm.py``'s own
    invariants: test error < 0.2 and within 0.05; per cell, the gammas of
    at least 65 % of cells equal and every validation loss within 0.02."""
    from repro.train.svm_trainer import LiquidSVM as JLiquid
    from repro.train.svm_trainer import SVMTrainerConfig as JConfig
    from repro_torch.tasks.builder import combine_decisions
    _, outs, (xtr, ytr, xte, yte) = cells
    cfg = JConfig(n_folds=3, max_iters=300, cell_method="voronoi",
                  cell_size=200, seed=0)
    ref = JLiquid(cfg).fit(xtr, ytr)
    err_local = ref.error(xte, yte)
    f = outs[0]["fit"]
    for o in outs[1:]:
        assert _same([o["fit"][k] for k in ("gamma", "val_loss",
                                            "decisions")],
                     [f[k] for k in ("gamma", "val_loss", "decisions")])
    pred = combine_decisions(f["decisions"], "binary")
    err_mesh = float(np.mean(pred != np.sign(yte)))
    n_cells = f["n_cells"]
    assert n_cells == ref.plan.n_cells
    sl, sm = ref.packed.slot_of_cell, f["slot_of_cell"]
    g_same = np.mean([np.isclose(ref.gamma[sl[c]], f["gamma"][sm[c]],
                                 rtol=1e-5).all() for c in range(n_cells)])
    dv = np.array([np.abs(np.asarray(ref.val_loss[sl[c]])
                          - f["val_loss"][sm[c]]).max()
                   for c in range(n_cells)])
    print(f"fit under a (2, 2) mesh: error {err_mesh:.4f} (reference "
          f"unsharded {err_local:.4f}); gammas equal in {g_same:.3f} of "
          f"{n_cells} cells; per-cell val-loss diffs {np.round(dv, 4)}")
    assert err_mesh < 0.2, err_mesh
    assert abs(err_local - err_mesh) < 0.05, (err_local, err_mesh)
    assert g_same >= 0.65, g_same
    assert (dv < 0.02).all(), dv


@pytest.mark.timeout(600)
def test_wave_resume_under_mesh_bitwise(cells):
    """Waves of 4 slots on 4 ranks with ``ckpt_dir``, killed at a wave
    solved but not saved and at a wave's start (armed on every rank), then
    re-run: the models equal the uninterrupted run bitwise on every
    rank."""
    _, outs, _ = cells
    for o in outs:
        res = o["resume"]
        assert res["n_slots"] >= 12      # three waves or more
        for site, (killed, *arrays) in res["runs"].items():
            assert killed, site
            assert _same(arrays, res["whole"]), site
    for o in outs[1:]:
        assert _same(o["resume"]["whole"], outs[0]["resume"]["whole"])


# ------------------------------------------------------------ ef_psum
def _ef_job(g_all, tree_all):
    from repro_torch.distributed.compression import ef_psum, ef_psum_tree
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models.layers import tree_items
    mesh = mesh_mod.make_mesh((8,), ("pod",), "cpu")
    r = dist.get_rank()
    g = torch.from_numpy(g_all[r])
    out, err = ef_psum(g, torch.zeros_like(g), "pod", mesh)
    grads = {k: torch.from_numpy(v[r]) for k, v in tree_all.items()}
    errs = {k: torch.zeros_like(v) for k, v in grads.items()}
    t_out, t_err = ef_psum_tree(grads, errs, "pod", mesh)
    return {"out": out.numpy(), "err": err.numpy(),
            "tree_out": {k[0]: v.numpy() for k, v in tree_items(t_out)},
            "tree_err": {k[0]: v.numpy() for k, v in tree_items(t_err)}}


_EF_SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import PartitionSpec as P
    from repro.distributed.compression import ef_psum
    from repro.distributed.cell_trainer import _shard_map as sm
    mesh = jax.make_mesh((8,), ("pod",))
    g = jnp.asarray(np.load(sys.argv[1]))
    def body(gl, el):
        out, new_err = ef_psum(gl[0], el[0], "pod")
        return out[None], new_err[None]
    f = jax.jit(sm(body, mesh=mesh, in_specs=(P("pod"), P("pod")),
                   out_specs=(P("pod"), P("pod"))))
    out, err = f(g, jnp.zeros_like(g))
    np.save(sys.argv[2], np.asarray(out))
    np.save(sys.argv[3], np.asarray(err))
    print("OK")
""")


@pytest.fixture(scope="module")
def ef(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ef")
    rng = np.random.default_rng(0)
    g = rng.normal(0, 1, (8, 128)).astype(np.float32)
    np.save(tmp / "g.npy", g)
    env = dict(os.environ, PYTHONPATH="src")
    env.pop("XLA_FLAGS", None)
    ref = subprocess.run(
        [sys.executable, "-c", _EF_SCRIPT, str(tmp / "g.npy"),
         str(tmp / "out.npy"), str(tmp / "err.npy")], env=env, cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    assert ref.returncode == 0, ref.stdout + ref.stderr
    from repro_torch.configs import get_arch
    from repro_torch.models import model as t_model
    from repro_torch.models.layers import tree_items
    cfg = get_arch("stablelm-1.6b").smoke
    tree = {}
    for path, leaf in tree_items(t_model.init_params(
            cfg, torch.Generator().manual_seed(0))):
        shape = tuple(leaf.shape)
        tree[".".join(path)] = rng.normal(0, 1e-2, (8,) + shape).astype(
            np.float32)
    outs = run_local(_ef_job, 8, g, tree, timeout=240)
    return g, np.load(tmp / "out.npy"), np.load(tmp / "err.npy"), tree, outs


@pytest.mark.timeout(600)
def test_ef_psum_matches_reference_shard_map(ef):
    """8 gloo ranks against the JAX package's ``ef_psum`` under
    ``shard_map`` on 8 forced host devices: every rank's output equals the
    reference's bitwise and every rank returns the same mean (the f32
    mean within 2e-2).  The residuals differ by one rounding: XLA fuses
    ``corrected - q * scale`` into one multiply-subtract, the port rounds
    the product first (measured 1.19e-7, one ulp; held within 2^-23 of
    the largest |g|)."""
    g, j_out, j_err, _, outs = ef
    d_out = max(float(np.abs(o["out"] - j_out[r]).max())
                for r, o in enumerate(outs))
    d_err = max(float(np.abs(o["err"] - j_err[r]).max())
                for r, o in enumerate(outs))
    print(f"ef_psum vs reference: output diff {d_out}, residual diff "
          f"{d_err}")
    for r, o in enumerate(outs):
        assert np.array_equal(o["out"], j_out[r]), r
        assert np.array_equal(o["out"], outs[0]["out"])
    assert d_err <= 2.0 ** -23 * float(np.abs(g).max())
    assert np.allclose(outs[0]["out"], g.mean(0), atol=2e-2)


@pytest.mark.timeout(600)
def test_ef_psum_tree_over_a_parameter_tree(ef):
    """``ef_psum_tree`` over the stablelm smoke parameter tree (8 ranks):
    each leaf equals ``ef_psum`` of that leaf computed here from all
    ranks' gradients (one scale a leaf), the same on every rank, and the
    residual carries what the int8 payload dropped."""
    _, _, _, tree, outs = ef
    f32 = np.float32
    for name, per_rank in tree.items():
        scale = max(f32(np.abs(per_rank).max()) / f32(127.0), f32(1e-30))
        q = np.clip(np.round(per_rank / scale), -127, 127)
        want = q.sum(0).astype(f32) * scale / f32(8)
        for r, o in enumerate(outs):
            assert np.array_equal(o["tree_out"][name], want), (name, r)
            resid = per_rank[r] - q[r].astype(f32) * scale
            assert np.array_equal(o["tree_err"][name], resid), (name, r)
