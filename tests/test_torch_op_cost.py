"""The port's op-level cost counter (``repro_torch.launch.op_cost``)
against the JAX package's jaxpr cost analyzer (``repro.launch.
jaxpr_cost``): the twins of ``tests/test_jaxpr_cost.py``, plus the
smoke prefill's matmul FLOPs against the reference's dot FLOPs on the
same config, and the per-device figure of a split matmul on two ranks.

The byte model is the reference's, so the plain matmul and the loops
agree exactly.  Loops are Python loops in the port: their trip counts
are exact, where the reference multiplies scan bodies by their length.
The MoE's chunk loop is counted as the reference counts its scan (one
trip traced, times the trips): on smoke qwen3-moe with 5 and 4 chunks,
unsharded and on a (2, 2) mesh of a fake process group, that count
equals the trip-by-trip trace exactly.
"""
from __future__ import annotations

import functools

import pytest

torch = pytest.importorskip("torch")
dist = pytest.importorskip("torch.distributed")

from repro_torch.launch.local import run_local  # noqa: E402
from repro_torch.launch.op_cost import cost_of, run_counted  # noqa: E402

META = "meta"


def _m(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device=META)


def _grad(loss):
    """The gradient of ``loss`` at x (autograd under the fake tensors)."""
    def g(x):
        x = x.detach().requires_grad_(True)
        with torch.enable_grad():
            return torch.autograd.grad(loss(x), x)[0]
    return g


class TestDotCost:
    def test_plain_matmul_equals_reference(self):
        import jax
        import jax.numpy as jnp
        from repro.launch.jaxpr_cost import cost_of as j_cost_of
        c = cost_of(lambda x, y: x @ y, _m(64, 128), _m(128, 32))
        want = j_cost_of(lambda x, y: x @ y,
                         jax.ShapeDtypeStruct((64, 128), jnp.float32),
                         jax.ShapeDtypeStruct((128, 32), jnp.float32))
        assert c.flops == want.flops == 2 * 64 * 128 * 32
        assert c.bytes == want.bytes == (64 * 128 + 128 * 32 + 64 * 32) * 4 \
            + (64 * 128 + 128 * 32) * 4  # arguments charged once as sources

    def test_batched_einsum(self):
        c = cost_of(lambda x, y: torch.einsum("bij,bjk->bik", x, y),
                    _m(4, 16, 32, dtype=torch.bfloat16),
                    _m(4, 32, 8, dtype=torch.bfloat16))
        assert c.flops == 2 * 4 * 16 * 32 * 8

    def test_int8_operand_counts_at_source_bytes(self):
        """A dequantized int8 operand is read as int8: the convert and
        scale-multiply chain is followed back to the stored tensor."""
        def f(q8, scale, x):
            return (q8.float() * scale) @ x
        c = cost_of(f, _m(64, 64, dtype=torch.int8), _m(64, 1), _m(64, 16))
        args = 64 * 64 + 64 * 4 + 64 * 16 * 4
        assert c.bytes == args + 64 * 64 * 1 + 64 * 16 * 4 + 64 * 16 * 4

    def test_loop_multiplies_by_trips(self):
        """The reference's scan of 10: a Python loop here."""
        def f(c):
            for _ in range(10):
                c = c @ c
            return c
        c = cost_of(f, _m(128, 128))
        assert c.flops >= 10 * 2 * 128 ** 3
        assert c.flops < 10.5 * 2 * 128 ** 3

    def test_loop_equals_reference_scan(self):
        import jax
        import jax.numpy as jnp
        from repro.launch.jaxpr_cost import cost_of as j_cost_of

        def jf(x0):
            def body(c, _):
                return c @ c, None
            return jax.lax.scan(body, x0, None, length=10)[0]

        def tf(c):
            for _ in range(10):
                c = c @ c
            return c
        want = j_cost_of(jf, jax.ShapeDtypeStruct((128, 128), jnp.float32))
        got = cost_of(tf, _m(128, 128))
        assert got.flops == want.flops == 10 * 2 * 128 ** 3

    def test_nested_loops_multiply(self):
        import jax
        import jax.numpy as jnp
        from repro.launch.jaxpr_cost import cost_of as j_cost_of

        def jf(x0):
            def outer(c, _):
                def inner(ci, _):
                    return ci @ ci, None
                return jax.lax.scan(inner, c, None, length=3)[0], None
            return jax.lax.scan(outer, x0, None, length=5)[0]

        def tf(c):
            for _ in range(5):
                for _ in range(3):
                    c = c @ c
            return c
        got = cost_of(tf, _m(64, 64))
        assert got.flops == 15 * 2 * 64 ** 3
        assert got.flops == j_cost_of(
            jf, jax.ShapeDtypeStruct((64, 64), jnp.float32)).flops

    def test_while_uses_caller_trips(self):
        def f(s):
            while bool(torch.sum(s) < 1e9):
                s = s @ s
            return s
        c = cost_of(f, _m(32, 32), while_trips=100.0)
        assert c.flops >= 100 * 2 * 32 ** 3
        assert c.flops < 101 * 2 * 32 ** 3 + 101 * 32 * 32 * 2
        assert c.guessed_whiles >= 1

    def test_value_read_is_no_loop(self):
        """A read that only scales a result (a learning rate) is answered
        with a fixed value and counts as no loop."""
        def f(x, lr):
            return x * float(lr * 2.0)
        c = cost_of(f, _m(8, 8), _m())
        assert c.guessed_whiles == 0
        assert c.flops == 8 * 8 + 1

    def test_grad_counts_backward(self):
        def loss(x):
            return torch.sum((x @ x) ** 2)
        fwd = cost_of(loss, _m(64, 64)).flops
        both = cost_of(_grad(loss), _m(64, 64)).flops
        assert both > 2.5 * fwd  # fwd + ~2 matmuls in backward

    def test_remat_recompute_counted(self):
        from torch.utils.checkpoint import checkpoint

        def f(y):
            return torch.sum(torch.tanh(y @ y) ** 2)
        plain = cost_of(_grad(f), _m(64, 64))
        remat = cost_of(_grad(lambda x: checkpoint(f, x, use_reentrant=False)),
                        _m(64, 64))
        assert remat.flops > plain.flops  # recompute visible


def _smoke_params(cfg):
    from repro_torch.models import layers as t_layers
    from repro_torch.models import model as t_model
    return t_layers.shape_tree(t_model.build_template(cfg))


class TestModelAccounting:
    def test_model_train_flops_vs_analytic(self):
        """Smoke config: the train step's FLOPs within [0.8, 6] x 6 N D
        (attention, remat and norms account for the slack), as the
        reference's test requires of its own."""
        from repro_torch.configs import get_arch
        from repro_torch.models.layers import param_count
        from repro_torch.models import model as t_model
        from repro_torch.train.lm_trainer import value_and_grad
        cfg = get_arch("stablelm-1.6b").smoke
        b, t = 4, 64
        batch = {"inputs": _m(b, t, dtype=torch.int32),
                 "labels": _m(b, t, dtype=torch.int32)}
        c = cost_of(lambda p, bt: value_and_grad(cfg, p, bt),
                    _smoke_params(cfg), batch)
        analytic = 6 * param_count(t_model.build_template(cfg)) * b * t
        assert 0.8 * analytic < c.flops < 6 * analytic

    @pytest.mark.parametrize("arch", ["stablelm-1.6b", "gemma3-4b"])
    def test_prefill_matmul_flops_equal_reference(self, arch):
        """The smoke prefill's matmul FLOPs equal the reference's dot FLOPs
        on the same config (both attention paths materialise the full
        T x T score matrix on the CPU: the same products)."""
        import jax
        import jax.numpy as jnp
        from repro.configs import get_arch as j_get_arch
        from repro.launch.jaxpr_cost import _dot_cost, _inner_jaxprs
        from repro.models import layers as j_layers
        from repro.models import model as j_model
        from repro_torch.configs import get_arch
        from repro_torch.models import model as t_model

        def dot_flops(jaxpr) -> float:
            tot = 0.0
            for eqn in jaxpr.eqns:
                if eqn.primitive.name == "dot_general":
                    tot += _dot_cost(eqn, {}).flops
                for sub, mult in _inner_jaxprs(eqn):
                    tot += dot_flops(sub) * (1.0 if mult is None else mult)
            return tot

        b, t = 2, 32
        jc = j_get_arch(arch).smoke
        jp = j_layers.shape_tree(j_model.build_template(jc))
        closed = jax.make_jaxpr(functools.partial(j_model.prefill, jc))(
            jp, jax.ShapeDtypeStruct((b, t), jnp.int32))
        want = dot_flops(closed.jaxpr)
        cfg = get_arch(arch).smoke
        _, cm = run_counted(functools.partial(t_model.prefill, cfg),
                            _smoke_params(cfg), _m(b, t, dtype=torch.int32))
        assert cm.matmul_flops == want


# ------------------------------------------------------------ two ranks
def _split_matmul(m: int, k: int, n: int):
    """On each rank: the cost of a (m, k) @ (k, n) matmul with the rows
    split over the ranks (``Shard(0)``) and the right operand whole."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.launch import mesh as mesh_mod
    mesh = mesh_mod.make_mesh((dist.get_world_size(),), ("data",), "cpu")
    a = distribute_tensor(torch.ones(m, k), mesh, [Shard(0)])
    b = distribute_tensor(torch.ones(k, n), mesh, [Replicate()])
    c = cost_of(lambda x, y: x @ y, a, b)
    return c.flops, c.bytes


def test_split_matmul_counts_per_device():
    """Pins the level the counter sees under DTensor: each rank's local
    op.  A row-split matmul on two ranks costs each rank half the global
    FLOPs (the reference's per-device figure, global / n_devices), and its
    bytes are the local blocks': the arguments once as sources, then both
    operands and the output."""
    m, k, n = 64, 128, 32
    got = run_local(_split_matmul, 2, m, k, n)
    glob = cost_of(lambda x, y: x @ y, _m(m, k), _m(k, n))
    local_bytes = 4 * (2 * (m // 2 * k + k * n) + m // 2 * n)
    for flops, nbytes in got:
        assert flops == glob.flops / 2 == 2 * (m // 2) * k * n
        assert nbytes == local_bytes


MOE_SCAN = r"""
import dataclasses, json, sys
import torch
from repro_torch.configs import get_arch
from repro_torch.configs.common import ShapeSpec
from repro_torch.launch import dryrun, shapes
from repro_torch.launch.mesh import make_mesh
from repro_torch.train.lm_trainer import make_train_step
from repro_torch.train.optimizer import OptConfig
from repro_torch.models import layers
from repro_torch.models.layers import shape_tree, tree_from_items, tree_items
from repro_torch.models import model as M

def terms(cm):
    return {"flops": cm.cost.flops, "bytes": cm.cost.bytes,
            "matmul_flops": cm.matmul_flops,
            "collective_bytes": cm.collective_bytes,
            "collective_counts": cm.collective_counts}

smoke = get_arch(sys.argv[1]).smoke
out = {}
# unsharded: the loss and its gradients over 2 x 160 tokens, 5 chunks of 64
cfg = dataclasses.replace(smoke, dtype=torch.float32)
params = shape_tree(M.build_template(cfg))
batch = {"inputs": torch.empty((2, 160), dtype=torch.int32, device="meta"),
         "labels": torch.empty((2, 160), dtype=torch.int32, device="meta")}

def grads(params, batch):
    paths = [p for p, _ in tree_items(params)]
    leaves = [l.detach().requires_grad_(True) for _, l in tree_items(params)]
    with torch.enable_grad():
        loss = M.loss_fn(cfg, tree_from_items(zip(paths, leaves)), batch)
        return torch.autograd.grad(loss, leaves)

def the_loop(fn):
    # fn with the chunk loop run trip by trip under the meter, as the
    # model runs it (checkpointed trips), in place of the meter's scan
    def run(*a):
        with layers.scan_override(None):
            return fn(*a)
    return run

from repro_torch.launch.op_cost import run_counted
out["unsharded"] = {"scan": terms(run_counted(grads, params, batch)[1]),
                    "loop": terms(run_counted(the_loop(grads), params,
                                              batch)[1])}
# sharded: a train step on a (2, 2) mesh of a fake group, 8 x 64 tokens,
# each 'data' rank's 256 tokens 4 chunks of 64 (experts over 'model')
dryrun.join_fake_group(4)
mesh = make_mesh((2, 2), ("data", "model"), "cpu")
cfg = dataclasses.replace(smoke, batch_axes=("data",),
                          shard_activations=True, remat=True)
ocfg = OptConfig()
spec = ShapeSpec("train_tiny", "train", 64, 8)
args = (shapes.param_structs(cfg, mesh), shapes.opt_structs(cfg, ocfg, mesh),
        shapes.batch_structs(cfg, spec, mesh))
step = make_train_step(cfg, ocfg)
out["sharded"] = {"scan": terms(dryrun._run(step, args, mesh)[2]),
                  "loop": terms(dryrun._run(the_loop(step), args, mesh)[2])}
print(json.dumps(out))
"""


@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b",
                                  "llama4-maverick-400b-a17b"])
def test_moe_chunk_loop_counted_as_a_scan(arch):
    """The MoE's chunk loop under the meter (``op_cost.loop_trips``):
    trip 0 traced and counted for every chunk, forward, recompute and
    backward, and the weights' gradients summed over the chunks, equals
    the loop the model runs (``layers.scan_trips``: checkpointed trips),
    traced trip by trip under the same meter, in FLOPs, bytes, matmul
    FLOPs and collective bytes and counts, exactly: unsharded (5 chunks)
    and as the sharded train step on a fake (2, 2) mesh (4 chunks a
    rank) under a layer checkpoint: qwen3-moe's stops its recompute
    before the loop's last trip; llama4-maverick has a shared expert
    after the loop.  In a subprocess: the fake process group must not
    meet the test process's."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"), OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", MOE_SCAN, arch], env=env,
                         cwd=root,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    for case in ("unsharded", "sharded"):
        scaled, full = out[case]["scan"], out[case]["loop"]
        print(case, scaled)
        assert scaled == full, (case, scaled, full)
        assert scaled["flops"] > 0
    assert out["sharded"]["scan"]["collective_bytes"]
