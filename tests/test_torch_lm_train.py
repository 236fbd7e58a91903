"""The port's LM training on one device against the JAX package's, on the
CPU, at the smoke configs: the loss and its gradients for every ported
architecture, the blocked attention executor and the chunked
cross-entropy, AdamW and its policies, the token pipeline, the trainer's
checkpoint and resume, and the int8 error-feedback pair.  The twins of
``test_arch_smoke.py``'s forward and train-grad cases and of
``test_train_substrate.py``'s single-device cases.

Tolerances (f32, seed 0): the loss within 1e-5 relative (measured <=
1.4e-7) and every gradient leaf within 1e-4 of its largest |value|
(measured <= 3.5e-6): the same functions, reduced in another order.  The
blocked executor and its gradients: 1e-5 of the largest |value|
(measured <= 5.1e-7); the chunked cross-entropy 1e-5 relative (measured
0).  AdamW on the same gradients: 1e-6 relative (measured <= 3.1e-7: the
same f32 operations, the gradient norm reduced in another order).  A
resumed run equals the uninterrupted one bitwise (CPU kernels are
deterministic).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as j_get_arch  # noqa: E402
from repro.data import tokens as j_tokens  # noqa: E402
from repro.models import attention as j_attn  # noqa: E402
from repro.models import layers as j_layers  # noqa: E402
from repro.models import model as j_model  # noqa: E402
from repro.train import optimizer as j_opt  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_arch  # noqa: E402
from repro_torch.data.tokens import (TokenPipeline,  # noqa: E402
                                     TokenPipelineConfig)
from repro_torch.distributed.compression import (  # noqa: E402
    dequantize_int8, ef_compress, init_error_state, quantize_int8)
from repro_torch.models import attention as t_attn  # noqa: E402
from repro_torch.models import model as t_model  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.models.layers import tree_items  # noqa: E402
from repro_torch.train.lm_trainer import (Trainer, TrainLoopConfig,  # noqa: E402
                                          make_train_step, value_and_grad)
from repro_torch.train.optimizer import (OptConfig, adamw_step,  # noqa: E402
                                         init_opt_state, schedule_lr)

CPU = "cpu"


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """Small shapes: one intra-op thread is as fast as eight alone and
    much faster when test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def _close(got, want, rel: float) -> None:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"max abs err {err} > {rel} x {scale}"


def _batch(cfg, seed: int = 0, b: int = 2, t: int = 32):
    rng = np.random.default_rng(seed)
    if cfg.input_kind == "tokens":
        x = rng.integers(0, cfg.vocab, (b, t)).astype(np.int32)
    else:
        x = rng.normal(size=(b, t, cfg.d_frontend)).astype(np.float32)
    return x, rng.integers(0, cfg.vocab, (b, t)).astype(np.int32)


# ------------------------------------------------ the loss, every arch
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_loss_near_ln_vocab(arch):
    """The smoke config in its own dtype, seeded: a finite loss near
    ln(vocab) (uniform predictions at init)."""
    cfg = get_arch(arch).smoke
    params = t_model.init_params(cfg, torch.Generator().manual_seed(1))
    x, labels = _batch(cfg)
    loss = t_model.loss_fn(cfg, params, {"inputs": _t(x),
                                         "labels": _t(labels)})
    assert loss.shape == () and torch.isfinite(loss)
    assert abs(float(loss) - np.log(cfg.vocab)) < 2.0


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_loss_and_grads_match_reference(arch):
    """``value_and_grad`` of the port's ``loss_fn`` against
    ``jax.value_and_grad`` of the reference's, in f32 on the same weights
    and batch; every attention projection gets a nonzero gradient; a
    plain SGD step lowers the loss (``test_train_grad_step``)."""
    jc = dataclasses.replace(j_get_arch(arch).smoke, dtype=jnp.float32)
    tc = dataclasses.replace(get_arch(arch).smoke, dtype=torch.float32)
    jp = jax.device_get(j_layers.init_params(j_model.build_template(jc),
                                             jax.random.PRNGKey(2)))
    tp = params_from_reference(jp)
    x, labels = _batch(jc)
    jb = {"inputs": jnp.asarray(x), "labels": jnp.asarray(labels)}
    lj, gj = jax.jit(jax.value_and_grad(
        lambda p: j_model.loss_fn(jc, p, jb)))(jp)
    tb = {"inputs": _t(x), "labels": _t(labels)}
    lt, gt = value_and_grad(tc, tp, tb)
    assert abs(float(lt) - float(lj)) <= 1e-5 * abs(float(lj))
    want = dict(tree_items(params_from_reference(jax.device_get(gj))))
    got = dict(tree_items(gt))
    assert got.keys() == want.keys()
    for path, g in got.items():
        assert g.dtype == want[path].dtype and torch.isfinite(g).all()
        _close(g.numpy(), want[path].numpy(), 1e-4)
        if path[-2] == "mixer" and path[-1] in ("wq", "wk", "wv", "wo",
                                                "wr"):
            assert float(g.abs().max()) > 0.0, path
    stepped = {}
    for path, leaf in tree_items(tp):
        node = stepped
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf - 0.5 * got[path]
    assert float(t_model.loss_fn(tc, stepped, tb)) < float(lt)


def test_remat_gives_the_same_loss_and_grads():
    """``remat`` recomputes each period in backward: the same values."""
    cfg = dataclasses.replace(get_arch("stablelm-1.6b").smoke,
                              dtype=torch.float32, n_layers=3)
    params = t_model.init_params(cfg, torch.Generator().manual_seed(3))
    x, labels = _batch(cfg, seed=3)
    tb = {"inputs": _t(x), "labels": _t(labels)}
    l0, g0 = value_and_grad(cfg, params, tb)
    l1, g1 = value_and_grad(dataclasses.replace(cfg, remat=True), params, tb)
    assert torch.equal(l0, l1)
    for (p, a), (_, b) in zip(tree_items(g0), tree_items(g1)):
        assert torch.equal(a, b), p


@pytest.mark.parametrize("mask_kind,window,t,s,chunk", [
    ("causal", 0, 19, 19, 8), ("window", 5, 23, 23, 6),
    ("bidir", 0, 11, 17, 16), ("causal", 0, 7, 20, 64)])
def test_blocked_attention_and_its_grads_match(mask_kind, window, t, s,
                                               chunk):
    rng = np.random.default_rng(t + s)
    q = rng.normal(size=(2, t, 4, 8)).astype(np.float32)
    k = rng.normal(size=(2, s, 2, 8)).astype(np.float32)
    v = rng.normal(size=(2, s, 2, 8)).astype(np.float32)
    ct = rng.normal(size=(2, t, 4, 8)).astype(np.float32)

    def jf(q, k, v):
        out = j_attn._blocked_attention(q, k, v, mask_kind, window,
                                        8 ** -0.5, chunk)
        return jnp.sum(out * jnp.asarray(ct)), out
    (_, want), gj = jax.value_and_grad(jf, argnums=(0, 1, 2),
                                       has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    qt, kt, vt = (_t(a).requires_grad_(True) for a in (q, k, v))
    got = t_attn.blocked_attention(qt, kt, vt, mask_kind, window,
                                   8 ** -0.5, chunk)
    torch.sum(got * _t(ct)).backward()
    _close(got.detach().numpy(), want, 1e-5)
    for a, b in zip((qt, kt, vt), gj):
        _close(a.grad.numpy(), b, 1e-5)


def test_chunked_ce_matches_with_mask_and_ragged_chunks():
    jc = dataclasses.replace(j_get_arch("stablelm-1.6b").smoke,
                             dtype=jnp.float32, ce_chunk=7)
    tc = dataclasses.replace(get_arch("stablelm-1.6b").smoke,
                             dtype=torch.float32, ce_chunk=7)
    rng = np.random.default_rng(4)
    h = rng.normal(size=(2, 19, jc.d_model)).astype(np.float32)
    w = (0.1 * rng.normal(size=(jc.d_model, jc.vocab))).astype(np.float32)
    labels = rng.integers(0, jc.vocab, (2, 19)).astype(np.int32)
    mask = (rng.random((2, 19)) < 0.7).astype(np.float32)
    for m in (None, mask):
        want = j_model.chunked_ce(jc, {"lm_head": {"w": jnp.asarray(w)}},
                                  jnp.asarray(h), jnp.asarray(labels),
                                  None if m is None else jnp.asarray(m))
        got = t_model.chunked_ce(tc, {"lm_head": {"w": _t(w)}}, _t(h),
                                 _t(labels), None if m is None else _t(m))
        assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))


def test_kernel_launch_check_refuses_operands_that_require_grad():
    """No kernel has a backward: ``runtime.check_launch``, which every
    wrapper (B9 and B10 among them) runs before a launch on the card,
    refuses an operand that requires grad while grad is enabled, and lets
    it through under ``no_grad`` (on the card: ``test_torch_cuda.py``)."""
    from repro_torch.kernels import runtime
    x = torch.zeros((2, 3), requires_grad=True)
    with pytest.raises(ValueError, match="requires grad"):
        runtime.check_launch("flash_attention", (x.detach(), x), x.device)
    with torch.no_grad():
        runtime.check_launch("flash_attention", (x,), x.device)
    runtime.check_launch("flash_attention", (x.detach(),), x.device)


# ------------------------------------------------------------- optimizer
def _quad():
    return {"w": torch.tensor([3.0, -2.0]),
            "b": torch.tensor([[1.0, 1.0], [1.0, 1.0]])}


def test_adamw_reduces_quadratic():
    params = _quad()
    cfg = OptConfig(lr=0.1, weight_decay=0.0, warmup_steps=0,
                    total_steps=100, schedule="constant")
    opt = init_opt_state(params, cfg)

    def loss(p):
        return torch.sum(p["w"] ** 2) + torch.sum((p["b"] - 0.5) ** 2)
    l0 = float(loss(params))
    for _ in range(50):
        g = {"w": 2 * params["w"], "b": 2 * (params["b"] - 0.5)}
        params, opt, _ = adamw_step(g, opt, cfg)
    assert float(loss(params)) < 0.1 * l0


@pytest.mark.parametrize("policy", ["fp32", "bf16_mom", "pure_bf16"])
def test_policies_dtypes(policy):
    params = {"w": torch.zeros((4, 4), dtype=torch.bfloat16)}
    cfg = OptConfig(policy=policy)
    opt = init_opt_state(params, cfg)
    want_master = torch.bfloat16 if policy == "pure_bf16" else torch.float32
    want_mom = torch.float32 if policy == "fp32" else torch.bfloat16
    assert opt.master["w"].dtype == want_master
    assert opt.m["w"].dtype == want_mom
    p2, _, _ = adamw_step({"w": torch.ones((4, 4), dtype=torch.bfloat16)},
                          opt, cfg)
    assert p2["w"].dtype == torch.bfloat16


def test_grad_clip():
    params = {"w": torch.zeros(2)}
    cfg = OptConfig(grad_clip=1.0, lr=1.0, warmup_steps=0,
                    schedule="constant", weight_decay=0.0)
    _, _, metrics = adamw_step({"w": torch.tensor([300.0, 400.0])},
                               init_opt_state(params, cfg), cfg)
    assert float(metrics["grad_norm"]) == pytest.approx(500.0, rel=1e-5)
    assert float(metrics["clip_scale"]) == pytest.approx(1 / 500.0, rel=1e-5)


def test_warmup_cosine_schedule():
    cfg = OptConfig(lr=1.0, warmup_steps=10, total_steps=100,
                    min_lr_frac=0.1)
    assert float(schedule_lr(cfg, 5)) == pytest.approx(0.5)
    assert float(schedule_lr(cfg, 10)) == pytest.approx(1.0)
    assert float(schedule_lr(cfg, 100)) == pytest.approx(0.1)
    for sched in ("cosine", "linear", "constant"):
        c = OptConfig(lr=3e-4, warmup_steps=7, total_steps=40,
                      schedule=sched)
        jc = j_opt.OptConfig(lr=3e-4, warmup_steps=7, total_steps=40,
                             schedule=sched)
        for s in (0, 3, 7, 20, 40, 55):
            assert abs(float(schedule_lr(c, s))
                       - float(j_opt.schedule_lr(jc, jnp.int32(s)))) <= \
                1e-6 * 3e-4


@pytest.mark.parametrize("policy", ["fp32", "bf16_mom"])
def test_adamw_step_matches_reference(policy):
    """Three steps on the same numpy gradients: parameters, moments and
    metrics (norm-like 1-D leaves take no weight decay)."""
    rng = np.random.default_rng(7)
    shapes = {"a": (5, 3), "n": (3,), "z": {"k": (2, 4, 3)}}

    def draw(sh):
        if isinstance(sh, dict):
            return {k: draw(v) for k, v in sh.items()}
        return rng.normal(size=sh).astype(np.float32)
    p = draw(shapes)
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=10, policy=policy,
               grad_clip=0.5)
    jcfg, tcfg = j_opt.OptConfig(**cfg), OptConfig(**cfg)
    jp = jax.tree.map(jnp.asarray, p)
    tp = params_from_reference(p)
    jo, to = j_opt.init_opt_state(jp, jcfg), init_opt_state(tp, tcfg)
    for _ in range(3):
        g = draw(shapes)
        jp, jo, jm = j_opt.adamw_step(jax.tree.map(jnp.asarray, g), jo, jcfg)
        tp, to, tm = adamw_step(params_from_reference(g), to, tcfg)
        assert int(to.step) == int(jo.step)
        for name in ("lr", "grad_norm", "clip_scale"):
            assert abs(float(tm[name]) - float(jm[name])) <= 1e-6 * abs(
                float(jm[name]))
        for mine, ref in ((tp, jp), (to.master, jo.master), (to.m, jo.m),
                          (to.v, jo.v)):
            want = dict(tree_items(params_from_reference(
                jax.device_get(ref))))
            for path, leaf in tree_items(mine):
                assert leaf.dtype == want[path].dtype
                _close(leaf.float().numpy(), want[path].float().numpy(),
                       1e-6)


# ---------------------------------------------------------- token pipeline
def test_hmm_tables_equal_the_reference_bitwise():
    cfg = dict(vocab=97, seq_len=8, global_batch=2, seed=5,
               input_kind="embed", d_frontend=16)
    mine = TokenPipeline(TokenPipelineConfig(**cfg))
    ref = j_tokens.TokenPipeline(j_tokens.TokenPipelineConfig(**cfg))
    for name in ("_trans", "_emits", "_proj"):
        np.testing.assert_array_equal(getattr(mine, name).numpy(),
                                      np.asarray(getattr(ref, name)))


def test_deterministic_replay():
    cfg = TokenPipelineConfig(vocab=211, seq_len=16, global_batch=4, seed=3)
    b1 = TokenPipeline(cfg).batch(17)
    b2 = TokenPipeline(cfg).batch(17)
    for k in b1:
        assert torch.equal(b1[k], b2[k])
    assert not torch.equal(b1["inputs"], TokenPipeline(cfg).batch(18)["inputs"])
    other = TokenPipelineConfig(vocab=211, seq_len=16, global_batch=4, seed=4)
    assert not torch.equal(b1["inputs"], TokenPipeline(other).batch(17)["inputs"])


def test_labels_are_shifted_inputs():
    b = TokenPipeline(TokenPipelineConfig(vocab=97, seq_len=12,
                                          global_batch=2)).batch(0)
    assert b["inputs"].dtype == b["labels"].dtype == torch.int32
    assert torch.equal(b["labels"][:, :-1], b["inputs"][:, 1:])
    assert float(b["mask"][0, -1]) == 0.0 and float(b["mask"][0, 0]) == 1.0
    assert int(b["inputs"].min()) >= 0 and int(b["inputs"].max()) < 97


def test_embed_kind():
    pipe = TokenPipeline(TokenPipelineConfig(vocab=97, seq_len=8,
                                             global_batch=2,
                                             input_kind="embed",
                                             d_frontend=32))
    b = pipe.batch(0)
    assert b["inputs"].shape == (2, 8, 32) and b["inputs"].dtype == torch.float32
    assert torch.equal(b["inputs"][:, 1:], pipe._proj[b["labels"][:, :-1].long()])


# --------------------------------------------------------------- trainer
def _trainer(tmp_path, total, every, lr=1e-3):
    cfg = get_arch("stablelm-1.6b").smoke
    pipe = TokenPipeline(TokenPipelineConfig(vocab=cfg.vocab, seq_len=16,
                                             global_batch=4, seed=0))
    return Trainer(cfg, OptConfig(lr=lr, warmup_steps=2, total_steps=total),
                   TrainLoopConfig(total_steps=total, ckpt_every=every,
                                   ckpt_dir=str(tmp_path), log_every=1),
                   pipe, device=CPU)


def test_loss_decreases(tmp_path):
    out = _trainer(tmp_path, total=12, every=100, lr=3e-3).run()
    losses = [h["loss"] for h in out["history"]]
    assert len(losses) == 12 and np.isfinite(losses).all()
    assert np.mean(losses[-3:]) < np.mean(losses[:3])


def test_crash_resume_matches_uninterrupted(tmp_path):
    """Killed before step 6, restarted from the step-4 checkpoint: the
    final parameters and optimizer state equal one uninterrupted run's
    bitwise."""
    ref = _trainer(tmp_path / "ref", total=8, every=8).run()
    with pytest.raises(RuntimeError, match="injected failure"):
        _trainer(tmp_path / "crash", total=8, every=4).run(fail_at=6)
    restarted = _trainer(tmp_path / "crash", total=8, every=4)
    _, _, start = restarted.restore_or_init()
    assert start == 4
    out = restarted.run()
    assert [h["step"] for h in out["history"]] == [4, 5, 6, 7]
    for a, b in ((out["params"], ref["params"]),
                 (out["opt"].master, ref["opt"].master),
                 (out["opt"].v, ref["opt"].v)):
        for (p, x), (_, y) in zip(tree_items(a), tree_items(b)):
            assert torch.equal(x, y), p
    assert int(out["opt"].step) == int(ref["opt"].step) == 8


def test_grad_accum_equivalence():
    """accum=2 over batch 8 == accum=1 on the same 8 rows."""
    cfg = dataclasses.replace(get_arch("stablelm-1.6b").smoke,
                              dtype=torch.float32)
    params = t_model.init_params(cfg, torch.Generator().manual_seed(0))
    batch = TokenPipeline(TokenPipelineConfig(vocab=cfg.vocab, seq_len=16,
                                              global_batch=8,
                                              seed=1)).batch(0)
    ocfg = OptConfig(lr=1e-3, warmup_steps=0, schedule="constant")
    p1, _, m1 = make_train_step(cfg, ocfg, 1)(
        params, init_opt_state(params, ocfg), batch)
    p2, _, m2 = make_train_step(cfg, ocfg, 2)(
        params, init_opt_state(params, ocfg), batch)
    assert abs(float(m1["loss"]) - float(m2["loss"])) < 1e-5
    for (p, a), (_, b) in zip(tree_items(p1), tree_items(p2)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-5,
                                   err_msg=str(p))


def test_trainer_mesh_raises_and_names_the_missing_work():
    """``Trainer(mesh=...)`` is ported (``test_torch_lm_mesh.py``); what
    raises is what it cannot use, naming what is missing: placements
    without their mesh, and a mesh of another device type than the
    run's."""
    from types import SimpleNamespace
    cfg = get_arch("stablelm-1.6b").smoke
    pipe = TokenPipeline(TokenPipelineConfig(vocab=cfg.vocab, seq_len=8,
                                             global_batch=2))
    for kw, match in (({"param_shardings": {}}, "pass the mesh"),
                      ({"mesh": SimpleNamespace(device_type="cuda")},
                       "cuda mesh for a run on cpu")):
        with pytest.raises(ValueError, match=match):
            Trainer(cfg, OptConfig(), TrainLoopConfig(), pipe, device=CPU,
                    **kw)


# ----------------------------------------------------------- compression
def test_quantize_roundtrip_error_bounded_and_matches():
    from repro.distributed import compression as j_comp
    g = np.random.default_rng(0).normal(0, 0.1, (256,)).astype(np.float32)
    q, s = quantize_int8(_t(g))
    jq, js = j_comp.quantize_int8(jnp.asarray(g))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(s) == float(js)
    err = np.abs(dequantize_int8(q, s).numpy() - g)
    assert err.max() <= float(s) / 2 + 1e-9


def test_error_feedback_reduces_bias():
    """The mean EF-compressed gradient over many steps converges to the
    true gradient (the EF contract)."""
    g = _t(np.random.default_rng(1).normal(0, 1, (64,)).astype(np.float32))
    err = init_error_state({"g": g})["g"]
    acc = torch.zeros(64, dtype=torch.float64)
    for _ in range(200):
        q, s, err = ef_compress(g, err)
        assert q.dtype == torch.int8
        acc += dequantize_int8(q, s).double()
    np.testing.assert_allclose((acc / 200).numpy(), g.numpy(), atol=1e-3)
