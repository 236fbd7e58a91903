"""The port's launch tooling against the JAX package's: the cell matrix,
the per-(arch, shape, mesh) config adaptation, the input structs of every
cell, and the train / serve launchers on the CPU (the twins of
``tests/test_serve_and_launch.py``'s ``TestCellMatrix`` and
``TestMeshHelpers``).

The reference's HLO collective parser has no twin: the port counts
collectives from the ops a rank issues (``launch.op_cost``).
"""
from __future__ import annotations

import json
import math
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")
dist = pytest.importorskip("torch.distributed")

from repro_torch.configs import all_cells, get_arch  # noqa: E402
from repro_torch.launch.local import run_local  # noqa: E402

# the reference's production mesh, as adapt_config reads it: names and sizes
T_MESH = SimpleNamespace(mesh_dim_names=("data", "model"), shape=(16, 16))
J_MESH = SimpleNamespace(axis_names=("data", "model"),
                         shape={"data": 16, "model": 16})


class TestCellMatrix:
    def test_cell_count_matches_design(self):
        """40 nominal cells - 6 long_500k skips - 2 hubert decode skips = 32."""
        cells = all_cells()
        assert len(cells) == 32
        long_runners = [a for a, s in cells if s == "long_500k"]
        assert sorted(long_runners) == ["gemma3-4b", "jamba-v0.1-52b",
                                        "rwkv6-1.6b"]
        hubert = [s for a, s in cells if a == "hubert-xlarge"]
        assert sorted(hubert) == ["prefill_32k", "train_4k"]

    def test_cells_equal_reference(self):
        from repro.configs import all_cells as j_all_cells
        assert sorted(all_cells()) == sorted(j_all_cells())

    def test_shape_kinds(self):
        spec = get_arch("hubert-xlarge")
        assert spec.shape("prefill_32k").kind == "encode"
        spec = get_arch("gemma3-4b")
        assert spec.shape("long_500k").kind == "decode"
        assert spec.shape("train_4k").kind == "train"

    def test_unknown_shape_raises(self):
        with pytest.raises(KeyError, match="available"):
            get_arch("stablelm-12b").shape("long_500k")


class TestMeshHelpers:
    def test_batch_axes(self):
        from repro_torch.launch.mesh import batch_axes, n_batch_shards
        assert batch_axes(T_MESH) == ("data",)
        assert n_batch_shards(T_MESH) == 16

    def test_adapt_config_decode_long(self):
        from repro_torch.launch.shapes import adapt_config
        arch = get_arch("rwkv6-1.6b")
        cfg = adapt_config(arch, arch.shape("long_500k"), T_MESH)
        assert cfg.batch_axes == ()             # batch 1 cannot shard 16 ways
        assert cfg.seq_axes == ("data", "model")
        assert not cfg.remat

    def test_adapt_config_decode_batched(self):
        from repro_torch.launch.shapes import adapt_config
        arch = get_arch("stablelm-12b")
        cfg = adapt_config(arch, arch.shape("decode_32k"), T_MESH)
        assert cfg.batch_axes == ("data",)      # 128 % 16 == 0
        assert cfg.seq_axes == ("model",)       # the sequence over model

    def test_adapt_config_train(self):
        from repro_torch.launch.shapes import adapt_config
        arch = get_arch("command-r-plus-104b")
        cfg = adapt_config(arch, arch.shape("train_4k"), T_MESH)
        assert cfg.batch_axes == ("data",)
        assert cfg.shard_activations and cfg.remat

    @pytest.mark.parametrize("arch,shape", sorted(all_cells()))
    def test_adapt_config_equals_reference(self, arch, shape):
        from repro.configs import get_arch as j_get_arch
        from repro.launch.shapes import adapt_config as j_adapt
        from repro_torch.launch.shapes import adapt_config
        got = adapt_config(get_arch(arch), get_arch(arch).shape(shape), T_MESH)
        ja = j_get_arch(arch)
        want = j_adapt(ja, ja.shape(shape), J_MESH)
        for f in ("batch_axes", "seq_axes", "shard_activations", "remat"):
            assert getattr(got, f) == getattr(want, f), f

    def test_grad_accum_and_opt_policy_equal_reference(self):
        from repro.launch import shapes as j_shapes
        from repro_torch.launch import shapes as t_shapes
        for arch, shape in all_cells():
            s = get_arch(arch).shape(shape)
            assert t_shapes.grad_accum(arch, s) == j_shapes.grad_accum(arch, s)
            assert (t_shapes.opt_config(arch).policy
                    == j_shapes.opt_config(arch).policy)


# --------------------------------------------------------- input structs
def _norm_spec(spec):
    """A partition spec as tuples of axis names, trailing Nones dropped."""
    out = []
    for e in spec:
        if e is None or e == ():
            out.append(None)
        elif isinstance(e, str):
            out.append((e,))
        else:
            out.append(tuple(e))
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def _flat_port(x, prefix=""):
    from repro_torch.launch.shapes import Struct
    from repro_torch.train.optimizer import OptState
    if isinstance(x, Struct):
        return {prefix: (tuple(x.shape), str(x.dtype).replace("torch.", ""),
                         _norm_spec(x.spec))}
    out = {}
    if isinstance(x, OptState):
        items = [("." + f, getattr(x, f)) for f in x._fields]
    elif isinstance(x, dict):
        items = [(str(k), v) for k, v in x.items()]
    elif isinstance(x, tuple):
        items = [(str(i), v) for i, v in enumerate(x)]
    else:                                   # the decode position: an int
        return {prefix: x}
    for k, v in items:
        out.update(_flat_port(v, f"{prefix}/{k}" if prefix else k))
    return out


def _port_specs():
    """Every cell's input structs on a (1, 1) mesh of one gloo rank."""
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch.shapes import input_specs
    mesh = mesh_mod.make_mesh((1, 1), ("data", "model"), "cpu")
    out = {}
    for arch, shape in all_cells():
        spec = input_specs(arch, shape, mesh)
        out[(arch, shape)] = (spec["kind"], _flat_port(spec["args"]))
    return out


@pytest.fixture(scope="module")
def port_specs():
    return run_local(_port_specs, 1)[0]


@pytest.mark.parametrize("arch,shape", sorted(all_cells()))
def test_input_specs_equal_reference(port_specs, arch, shape):
    """Shapes, dtypes and partition specs of every argument equal the
    reference's ShapeDtypeStructs and PartitionSpecs; a decode cell's
    position (a traced int32 scalar there) is the last ring slot here."""
    import jax
    from repro.launch.shapes import input_specs as j_input_specs
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    spec = j_input_specs(arch, shape, mesh)
    flat, _ = jax.tree_util.tree_flatten_with_path(spec["args"])

    def key(k):
        if hasattr(k, "key"):
            return str(k.key)
        if hasattr(k, "idx"):
            return str(k.idx)
        return "." + k.name

    want = {"/".join(key(k) for k in path):
            (tuple(sd.shape), str(sd.dtype),
             _norm_spec(sd.sharding.spec if sd.sharding is not None else ()))
            for path, sd in flat}
    kind, got = port_specs[(arch, shape)]
    assert kind == spec["kind"]
    if kind == "decode":
        assert got.pop("3") == get_arch(arch).shape(shape).seq_len - 1
        sd = want.pop("3")
        assert sd[:2] == ((), "int32")
    assert got == want


# ------------------------------------------------------------- launchers
def _last_json(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


def test_train_launcher_cpu(capsys):
    """Finite losses under the reference launcher's keys."""
    from repro_torch.launch import train
    assert train.main(["--arch", "stablelm-1.6b", "--steps", "3", "--batch",
                       "2", "--seq", "32", "--device", "cpu"]) == 0
    got = _last_json(capsys.readouterr().out)
    assert set(got) == {"arch", "loss_first", "loss_last", "steps", "wall_s"}
    assert got["arch"] == "stablelm-1.6b" and got["steps"] == 3
    assert math.isfinite(got["loss_first"]) and math.isfinite(got["loss_last"])


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "gemma3-4b"])
def test_serve_launcher_cpu_matches_reference(capsys, arch):
    from repro.launch import serve as j_serve
    from repro_torch.launch import serve
    argv = ["--arch", arch, "--batch", "2", "--prompt-len", "8", "--new", "4"]
    assert j_serve.main(argv) == 0
    want = _last_json(capsys.readouterr().out)
    assert serve.main(argv + ["--device", "cpu"]) == 0
    got = _last_json(capsys.readouterr().out)
    assert set(got) == set(want)
    assert got["out_shape"] == want["out_shape"] == [2, 12]


def test_serve_launcher_encoder_only_returns_0(capsys):
    from repro_torch.launch import serve
    assert serve.main(["--arch", "hubert-xlarge", "--device", "cpu"]) == 0
    assert "encoder-only" in capsys.readouterr().out


def test_serve_launcher_needs_a_card_by_default():
    from repro_torch.launch import serve
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", "stablelm-1.6b"])



def test_train_test_split_equals_reference():
    """The split the port's smoke gate (``scripts/tier1_torch.sh``) uses:
    the same rows as the JAX package's."""
    import numpy as np
    from repro.data.synthetic import train_test_split as j_split
    from repro_torch.data.synthetic import train_test_split
    x = np.arange(40, dtype=np.float32).reshape(20, 2)
    y = np.arange(20)
    for got, want in zip(train_test_split(x, y, 0.25, 3),
                         j_split(x, y, 0.25, 3)):
        assert np.array_equal(got, want)
