"""The port's sharded LM training on CPU process groups: the templates'
partition specs, one train step on a ``("data", "model")`` mesh of gloo
ranks for each case of ``STEPS`` (qwen3-moe with its experts over 'model'
and activations sharded, on (4, 2) and on (2, 4) where two ranks share a
kv head; stablelm-1.6b with FSDP and recomputed periods, its vocabulary
of 503 unsplit and of 512 split over 'model'; gemma3-4b's tied
embeddings with a vocabulary of 1024 split, and its 4 heads over 8 ranks,
which do not divide (4 head groups of 2 ranks, each rank half of its
group's rows); llama4-maverick with 6 heads and 2 kv heads over 4 ranks
(2 groups of 3 heads, each rank's wq block 1.5 heads, as llama4's 40
heads give 2.5 a rank over 16); jamba's mamba, attention, dense and MoE
layers, the
mamba mixer by channel with x_proj's product summed over 'model'; rwkv6
by head, with its channel mix), and the elastic re-shard of a checkpoint
from a (4, 2) mesh to a (2, 4) one.  The twins of
``test_distributed_lm.py`` and ``test_elastic.py``.  Each step records
the regions it ran (``layers.REGION_TRACE``): every block of a layer as
one region from its input to its output (the norm on whole rows inside
it, head-parallel attention by head group, the dense MLP on its ff
block, the
expert-parallel MoE, mamba by channel, rwkv6 by head, the residual on
the local block), the final norm, and the vocab-parallel embedding and
cross-entropy, all on local shards; or ``run_on_rows`` where there is no
split to use.  It also records every op of a layer's forward that has a
DTensor operand (an op DTensor would plan): there is none.

The JAX package's sharded step cannot run on this box (ROADMAP C3: jax
0.9.0 refuses the embedding gather of a table sharded on d over 'model'
with tokens sharded over 'data'), so a sharded step is held against the
JAX package's *unsharded* step on the same weights and batch, within the
reference's own tolerances (loss 2e-4, parameters 5e-3), and against the
port's own unsharded step.  The elastic run is held as ``test_elastic.py``
holds it (loss and parameters within 1e-4), and its checkpoint restores
into the JAX package's unsharded tree.

The JAX package is imported inside the tests only: the rank processes
import this module and need torch alone.
"""
from __future__ import annotations

import dataclasses
import math
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
dist = pytest.importorskip("torch.distributed")
if not dist.is_available():
    pytest.skip("torch.distributed is not available", allow_module_level=True)

from repro_torch.configs import ARCH_IDS, get_arch  # noqa: E402
from repro_torch.launch.local import run_local  # noqa: E402
from repro_torch.models import layers as t_layers  # noqa: E402
from repro_torch.models import model as t_model  # noqa: E402

CPU = "cpu"
LR = dict(lr=1e-3, warmup_steps=0, schedule="constant")


def _cfg(arch: str, **kw):
    return dataclasses.replace(get_arch(arch).smoke, dtype=torch.float32,
                               **kw)


# the sharded steps: label -> (arch, config changes of the run, mesh)
STEPS = {
    "qwen3-moe-235b-a22b": ("qwen3-moe-235b-a22b", dict(), (4, 2)),
    # 2 kv heads over 4 'model' ranks: each pair shares one
    "qwen3-moe-shared-kv": ("qwen3-moe-235b-a22b", dict(), (2, 4)),
    "stablelm-1.6b": ("stablelm-1.6b", dict(fsdp_params=True, remat=True),
                      (4, 2)),
    "stablelm-1.6b-vocab512": ("stablelm-1.6b", dict(
        fsdp_params=True, remat=True, vocab=512), (4, 2)),
    "gemma3-4b-vocab1024": ("gemma3-4b", dict(vocab=1024), (4, 2)),
    # 4 heads over 8 'model' ranks (gemma3-4b's 8 over 16): 4 groups of 2
    # ranks, a head each, each rank half of its 8 rows
    "gemma3-4b-uneven-heads": ("gemma3-4b", dict(), (1, 8)),
    # 6 heads, 2 kv heads over 4 'model' ranks: 2 groups of 3 heads (each
    # rank's wq block 1.5 heads, as llama4's 40 over 16 give 2.5), a kv
    # head each, each rank half of its 4 rows
    "llama4-straddle-heads": ("llama4-maverick-400b-a17b",
                              dict(n_heads=6, n_kv_heads=2), (2, 4)),
    # mamba by channel (x_proj summed over 'model'), attention, dense, MoE
    "jamba-v0.1-52b": ("jamba-v0.1-52b", dict(), (4, 2)),
    "rwkv6-1.6b": ("rwkv6-1.6b", dict(), (4, 2)),
}
SHARD = dict(batch_axes=("data",), shard_activations=True)
BATCH = 8            # the rows of each step's batch


@pytest.mark.parametrize("fsdp", [False, True], ids=["tp", "fsdp"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_spec_tree_matches_reference(arch, fsdp):
    """Every leaf's partition spec equals the reference's
    (``PartitionSpec`` as a tuple), full config and smoke."""
    import jax
    from jax.sharding import PartitionSpec
    from repro.configs import get_arch as j_get_arch
    from repro.models import layers as j_layers
    from repro.models import model as j_model
    for which in ("config", "smoke"):
        jc = dataclasses.replace(getattr(j_get_arch(arch), which),
                                 fsdp_params=fsdp)
        tc = dataclasses.replace(getattr(get_arch(arch), which),
                                 fsdp_params=fsdp)
        flat, _ = jax.tree_util.tree_flatten_with_path(
            j_layers.spec_tree(j_model.build_template(jc)),
            is_leaf=lambda x: isinstance(x, PartitionSpec))
        want = {tuple(k.key for k in path): tuple(spec)
                for path, spec in flat}
        got = dict(t_layers.tree_items(
            t_layers.spec_tree(t_model.build_template(tc))))
        assert got == want, (arch, which)


@pytest.mark.parametrize("m", [2, 8, 16])
@pytest.mark.parametrize("arch", [a for a in ARCH_IDS if any(
    k.startswith("attn") for k, _ in get_arch(a).config.period_pattern)])
def test_head_groups_cover_every_head_once(arch, m):
    """``attention.head_groups`` of each attention config's heads over m
    'model' ranks, checked head by head: the groups' query heads cover
    every head once, each group's the wq column blocks of its ranks
    exactly; the kv heads a group reads (head h reads h // (H / Hk)) are
    those it names; and each rank's run of ``kv_ranks`` neighbours holds
    their wk columns.  Every config of the repo has head groups at these
    sizes (none is left to the rows path by its heads)."""
    from repro_torch.models.attention import head_groups
    c = get_arch(arch).config
    h, hk, d = c.n_heads, c.n_kv_heads, c.head_dim
    grp = head_groups(h, hk, d, m)
    assert grp is not None
    assert grp.groups * grp.ranks == m and grp.groups * grp.heads == h
    owned = []
    for q in range(m):
        j = q // grp.ranks
        heads = range(j * grp.heads, (j + 1) * grp.heads)
        owned.extend(heads if q % grp.ranks == 0 else ())
        qcols = h * d // m
        assert (j * grp.ranks * qcols, (j + 1) * grp.ranks * qcols) == (
            heads[0] * d, (heads[-1] + 1) * d)
        kv = sorted({x // (h // hk) for x in heads})
        assert kv == list(range(grp.kv_first(j), grp.kv_first(j) + grp.kv))
        kcols, s = hk * d // m, grp.kv_ranks
        assert q // s * s * kcols <= kv[0] * d
        assert (kv[-1] + 1) * d <= (q // s + 1) * s * kcols
    assert sorted(owned) == list(range(h))


# ------------------------------------------------------------ rank jobs
def _step_on_mesh(cfg, params_np, batch_np, shape=(4, 2)):
    """One train step on a mesh of ``shape``: params split per the
    template's placements, the batch over 'data'.  -> (loss, grad norm,
    params, every param placed, the regions that ran)."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models.layers import (placements, sharding_tree,
                                           tree_items, tree_map)
    from repro_torch.train.lm_trainer import make_train_step
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    mesh = mesh_mod.make_mesh(shape, ("data", "model"), CPU)
    params = tree_map(lambda a, pl: distribute_tensor(
        torch.from_numpy(a), mesh, pl, src_data_rank=None), params_np,
        sharding_tree(t_model.build_template(cfg), mesh))
    bpl = placements((cfg.batch_axes,), mesh)
    batch = {k: distribute_tensor(torch.from_numpy(v), mesh, bpl,
                                  src_data_rank=None)
             for k, v in batch_np.items()}
    ocfg = OptConfig(**LR)
    step = make_train_step(cfg, ocfg)
    planned, inner = [], t_model._layer

    def layer(*args, **kw):            # the layer's forward, its ops seen
        with t_layers.dtensor_ops(planned):
            return inner(*args, **kw)

    t_layers.REGION_TRACE = []
    t_model._layer = layer
    try:
        p, o, m = step(params, init_opt_state(params, ocfg), batch)
        regions = {(name, tuple(sorted(info.items())))
                   for name, info in t_layers.REGION_TRACE}
    finally:
        t_layers.REGION_TRACE = None
        t_model._layer = inner
    placed = all(leaf.placements == want for (_, leaf), (_, want) in zip(
        tree_items(p), tree_items(sharding_tree(
            t_model.build_template(cfg), mesh))))
    return (float(m["loss"].full_tensor()), float(m["grad_norm"].full_tensor()),
            {"/".join(k): v.full_tensor().numpy() for k, v in tree_items(p)},
            placed, regions, sorted(set(planned)))



def _elastic(cfg, root):
    """test_elastic.py's run through ``Trainer(mesh=...)``: 3 steps on
    (4, 2) with a checkpoint, then 2 steps on (2, 4) and 2 on (4, 2), each
    restored from it; two micro-batches a step (each rank's rows laid out
    so its pieces are the global micro-batches' shares)."""
    from repro_torch.data.tokens import TokenPipeline, TokenPipelineConfig
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models.layers import tree_items
    from repro_torch.train.lm_trainer import Trainer, TrainLoopConfig
    from repro_torch.train.optimizer import OptConfig
    pipe = TokenPipeline(TokenPipelineConfig(vocab=cfg.vocab, seq_len=16,
                                             global_batch=8, seed=0))
    ocfg = OptConfig(**LR)

    def run(shape, ckpt_dir, total):
        mesh = mesh_mod.make_mesh(shape, ("data", "model"), CPU)
        loop = TrainLoopConfig(total_steps=total, grad_accum=2,
                               ckpt_every=3, ckpt_dir=ckpt_dir, log_every=1)
        out = Trainer(cfg, ocfg, loop, pipe, mesh=mesh, device=CPU).run()
        return ([h["loss"] for h in out["history"]],
                {"/".join(k): v.full_tensor().numpy()
                 for k, v in tree_items(out["params"])})

    first = run((4, 2), os.path.join(root, "p1"), 3)
    if dist.get_rank() == 0:
        for name in ("elastic", "same"):
            shutil.copytree(os.path.join(root, "p1"),
                            os.path.join(root, name))
    dist.barrier()
    elastic = run((2, 4), os.path.join(root, "elastic"), 5)
    same = run((4, 2), os.path.join(root, "same"), 5)
    return {"first": first, "elastic": elastic, "same": same}


def _lm_job(inputs, root):
    out = {}
    for label, (params_np, batch_np) in inputs.items():
        arch, kw, shape = STEPS[label]
        cfg = _cfg(arch, **kw, **SHARD)
        out[label] = _step_on_mesh(cfg, params_np, batch_np, shape)
    out["elastic"] = _elastic(_cfg("stablelm-1.6b", batch_axes=("data",)),
                              root)
    return out


# ------------------------------------------------------------ the runs
def _tree_np(tree):
    return {"/".join(k): np.asarray(v) for k, v in t_layers.tree_items(tree)}


@pytest.fixture(scope="module")
def lm(tmp_path_factory):
    """The JAX package's init of each arch (so both packages step the same
    weights), its unsharded step, the port's unsharded step, and the
    8-rank job."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_arch as j_get_arch
    from repro.models import layers as j_layers
    from repro.models import model as j_model
    from repro.train import lm_trainer as j_trainer
    from repro.train import optimizer as j_opt
    from repro_torch.data.tokens import TokenPipeline, TokenPipelineConfig
    from repro_torch.models.convert import params_from_reference
    from repro_torch.train.lm_trainer import make_train_step
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    torch.set_num_threads(1)
    inputs, ref, local, done = {}, {}, {}, {}
    for label, (arch, kw, _) in STEPS.items():
        key = (arch, tuple(sorted(kw.items())))
        if key in done:            # the same step on another mesh
            ref[label], local[label], inputs[label] = done[key]
            continue
        jc = dataclasses.replace(j_get_arch(arch).smoke, dtype=jnp.float32,
                                 **kw)
        tc = _cfg(arch, **kw)
        jp = jax.device_get(j_layers.init_params(j_model.build_template(jc),
                                                 jax.random.PRNGKey(0)))
        batch = {k: v.numpy() for k, v in TokenPipeline(TokenPipelineConfig(
            vocab=tc.vocab, seq_len=32, global_batch=BATCH, seed=0)).batch(0)
            .items()}
        jocfg = j_opt.OptConfig(**LR)
        p1, _, m1 = jax.jit(j_trainer.make_train_step(jc, jocfg))(
            jp, j_opt.init_opt_state(jp, jocfg),
            {k: jnp.asarray(v) for k, v in batch.items()})
        ref[label] = (float(m1["loss"]), float(m1["grad_norm"]),
                      _tree_np(params_from_reference(jax.device_get(p1))))
        tp = params_from_reference(jp)
        ocfg = OptConfig(**LR)
        p2, _, m2 = make_train_step(tc, ocfg)(tp, init_opt_state(tp, ocfg),
                                               {k: torch.from_numpy(v)
                                                for k, v in batch.items()})
        local[label] = (float(m2["loss"]), float(m2["grad_norm"]),
                        _tree_np(p2))
        inputs[label] = (t_layers.tree_map(lambda t: t.numpy().copy(), tp),
                         batch)
        done[key] = ref[label], local[label], inputs[label]
    root = str(tmp_path_factory.mktemp("lm_mesh"))
    outs = run_local(_lm_job, 8, inputs, root, timeout=480)
    return ref, local, outs, root


def _worst(a: dict, b: dict) -> float:
    assert a.keys() == b.keys()
    return max(float(np.abs(a[k] - b[k]).max()) for k in a)


@pytest.mark.timeout(900)
@pytest.mark.parametrize("arch", sorted(STEPS))
def test_sharded_step_matches_reference_unsharded(lm, arch):
    """``test_distributed_lm.py``'s bounds against the JAX package's
    unsharded step: loss within 2e-4, every parameter within 5e-3."""
    ref, _, outs, _ = lm
    loss, gnorm, params, _, _, _ = outs[0][arch]
    d_loss = abs(loss - ref[arch][0])
    worst = _worst(params, ref[arch][2])
    print(f"{arch} on {STEPS[arch][2]} vs the reference's unsharded step: loss "
          f"{loss:.7f} vs {ref[arch][0]:.7f} (diff {d_loss:.3g}), grad norm "
          f"diff {abs(gnorm - ref[arch][1]):.3g}, worst param delta "
          f"{worst:.3g}")
    assert d_loss < 2e-4, d_loss
    assert worst < 5e-3, worst


@pytest.mark.timeout(900)
@pytest.mark.parametrize("arch", sorted(STEPS))
def test_sharded_step_matches_port_unsharded(lm, arch):
    """The same step unsharded in the port: the same bounds, the global
    gradient norm (every rank's shards summed) within 1e-5 relative, every
    rank holding the same values, and every new parameter on its
    template's placements."""
    _, local, outs, _ = lm
    loss, gnorm, params, placed, _, _ = outs[0][arch]
    d_loss = abs(loss - local[arch][0])
    worst = _worst(params, local[arch][2])
    print(f"{arch} on {STEPS[arch][2]} vs the port's unsharded step: loss diff "
          f"{d_loss:.3g}, grad norm {gnorm:.7f} vs {local[arch][1]:.7f}, "
          f"worst param delta {worst:.3g}")
    assert d_loss < 2e-4 and worst < 5e-3
    assert abs(gnorm - local[arch][1]) <= 1e-5 * local[arch][1]
    for o in outs:
        assert o[arch][3]
        assert o[arch][0] == loss and _worst(o[arch][2], params) == 0.0


def expected_regions(label: str) -> set:
    """The regions the step of ``label`` must run, with the local sizes
    each sees: H / model query heads (and the kv heads they read), or
    where 'model' does not divide the heads H / g heads of a group of
    model / g ranks (g = gcd(H, model)) on 1 / (model / g) of the rank's
    rows; ff / model MLP columns, E / model experts, d_inner / model
    mamba channels, rwkv6's heads / model, V / model vocabulary rows and
    logit columns, the final norm; the rows path (``run_on_rows``, by
    region) where the vocabulary does not split over 'model'."""
    arch, kw, (data, m) = STEPS[label]
    cfg = _cfg(arch, **kw)
    out = {("norm", ())}
    for mixer, mlp in cfg.period_pattern:
        if mixer == "mamba":
            out.add(("mamba", (("channels", cfg.d_inner // m),)))
        elif mixer == "rwkv":
            out.add(("rwkv", (("heads", cfg.rwkv_heads // m),)))
        else:
            g = math.gcd(cfg.n_heads, m)
            heads = cfg.n_heads // g
            kv = max(heads * cfg.n_kv_heads // cfg.n_heads, 1)
            rows = (("rows", BATCH // data // (m // g)),) if g < m else ()
            out.add(("attention", (("heads", heads), ("kv_heads", kv))
                     + rows))
        if mlp == "moe":
            out.add(("moe", (("experts", cfg.n_experts // m),)))
        elif mlp == "rwkv_cm":
            out.add(("channel_mix", (("ff", cfg.d_ff // m),)))
        else:
            out.add(("dense", (("ff", cfg.d_ff // m),)))
    if cfg.vocab % 64 == 0:
        out |= {("embed", (("vocab_rows", cfg.vocab // m),)),
                ("ce", (("vocab_cols", cfg.vocab // m),))}
    else:
        out |= {("run_on_rows", (("region", "embed"),)),
                ("run_on_rows", (("region", "ce"),))}
    return out


@pytest.mark.timeout(900)
@pytest.mark.parametrize("label", sorted(STEPS))
def test_regions_run_on_local_shards(lm, label):
    """Every rank ran exactly the regions ``expected_regions`` names:
    attention on its H / model heads, the dense MLP on its ff / model
    columns, the MoE on its E / model experts, mamba on its channels,
    rwkv6 on its heads, the embedding and the cross-entropy on its V /
    model block, each on local shards (no ``run_on_rows`` for them);
    heads that 'model' does not divide (gemma3-4b's 4 over 8, 6 over 4)
    by head group on a block of the rank's rows; the rows path only where
    the vocabulary (503, 1031) does not split."""
    _, _, outs, _ = lm
    want = expected_regions(label)
    for o in outs:
        assert o[label][4] == want, (label, o[label][4], want)


@pytest.mark.timeout(900)
@pytest.mark.parametrize("label", sorted(STEPS))
def test_layers_take_no_dtensor_plan(lm, label):
    """A sharded layer's norms and MLP run inside regions on local shards
    (the dense MLP, the MoE or the channel mix in ``REGION_TRACE``, the
    norms inside them and the mixers' regions), and no op of any layer's
    forward, recomputed periods included, has a DTensor operand: DTensor's
    sharding rules plan nothing of a layer, so the step is the same
    program on every torch version."""
    _, _, outs, _ = lm
    arch, kw, _ = STEPS[label]
    cfg = _cfg(arch, **kw)
    mlps = {"dense": "dense", "moe": "moe", "rwkv_cm": "channel_mix"}
    for o in outs:
        names = {name for name, _ in o[label][4]}
        assert {mlps[f] for _, f in cfg.period_pattern} <= names
        assert o[label][5] == [], (label, o[label][5])


@pytest.mark.timeout(900)
def test_elastic_reshard_resume(lm):
    """``test_elastic.py``: 3 steps on (4, 2) and a checkpoint; 2 steps
    restored on (2, 4) against 2 restored on (4, 2): losses and
    parameters within 1e-4."""
    _, _, outs, _ = lm
    e = outs[0]["elastic"]
    (le, pe), (ls, ps) = e["elastic"], e["same"]
    worst = _worst(pe, ps)
    print(f"elastic (2, 4) loss {le[-1]:.7f}, same mesh (4, 2) "
          f"{ls[-1]:.7f}, worst param delta {worst:.3g}")
    assert len(le) == len(ls) == 2
    assert abs(le[-1] - ls[-1]) < 1e-4
    assert worst < 1e-4


@pytest.mark.timeout(900)
def test_trainer_on_mesh_matches_unsharded_trainer(lm, tmp_path):
    """``Trainer(mesh=...)`` from the seed against the unsharded
    ``Trainer`` (same seed, same batches, two micro-batches a step): the
    parameters are drawn in full and then split, so both start equal;
    after 3 steps, and after the elastic continuation to 5, losses within
    2e-4 and parameters within 5e-3."""
    from repro_torch.data.tokens import TokenPipeline, TokenPipelineConfig
    from repro_torch.train.lm_trainer import Trainer, TrainLoopConfig
    from repro_torch.train.optimizer import OptConfig
    _, _, outs, _ = lm
    cfg = _cfg("stablelm-1.6b")
    pipe = TokenPipeline(TokenPipelineConfig(vocab=cfg.vocab, seq_len=16,
                                             global_batch=8, seed=0))
    out = Trainer(cfg, OptConfig(**LR), TrainLoopConfig(
        total_steps=5, grad_accum=2, ckpt_every=100, log_every=1), pipe,
        device=CPU).run()
    e = outs[0]["elastic"]
    losses = [h["loss"] for h in out["history"]]
    d3 = max(abs(a - b) for a, b in zip(e["first"][0], losses[:3]))
    d5 = max(abs(a - b) for a, b in zip(e["elastic"][0], losses[3:]))
    worst = _worst(e["elastic"][1], _tree_np(out["params"]))
    print(f"Trainer(mesh) vs unsharded: loss diffs {d3:.3g} (steps 0-2), "
          f"{d5:.3g} (3-4 on (2, 4)), worst param delta {worst:.3g}")
    assert d3 < 2e-4 and d5 < 2e-4 and worst < 5e-3


@pytest.mark.timeout(900)
def test_sharded_checkpoint_is_the_unsharded_file(lm, tmp_path):
    """The (4, 2) run's step-3 checkpoint: its manifest (paths, shapes,
    dtypes, checksums) equals that of an unsharded save of the same
    values, and it restores into the JAX package's unsharded
    ``(params, OptState)`` tree with the port's parameters bitwise."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_arch as j_get_arch
    from repro.models import layers as j_layers
    from repro.models import model as j_model
    from repro.train import checkpoint as j_ckpt
    from repro.train import optimizer as j_opt
    from repro_torch.train import checkpoint as t_ckpt
    _, _, outs, root = lm
    d = os.path.join(root, "p1")
    man = t_ckpt.peek_manifest(d, 3)
    cfg = _cfg("stablelm-1.6b")
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    params = t_model.init_params(cfg, torch.Generator().manual_seed(0))
    target = (params, init_opt_state(params, OptConfig(**LR)))
    stored, step, _ = t_ckpt.restore_checkpoint(d, target)
    assert step == 3
    t_ckpt.save_checkpoint(str(tmp_path), 3, stored)
    plain = t_ckpt.peek_manifest(str(tmp_path), 3)
    for key in ("paths", "shapes", "dtypes", "checksums"):
        assert man[key] == plain[key], key
    jc = dataclasses.replace(j_get_arch("stablelm-1.6b").smoke,
                             dtype=jnp.float32)
    jp = j_layers.init_params(j_model.build_template(jc),
                              jax.random.PRNGKey(1))
    (rp, _), jstep, _ = j_ckpt.restore_checkpoint(
        d, (jp, j_opt.init_opt_state(jp, j_opt.OptConfig(**LR))))
    assert int(jstep) == 3
    from repro_torch.models.convert import params_from_reference
    got = _tree_np(params_from_reference(jax.device_get(rp)))
    assert _worst(got, outs[0]["elastic"]["first"][1]) == 0.0
