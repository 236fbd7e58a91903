"""The split over the keys of B9's CUDA-core (f32) kernel, on the CPU: the
wrapper's planner (``kernels.flash_attention.ops.split_count``), the runs
of kv tiles each split takes (``ref.tile_runs``, as the kernel cuts them),
and the split with its in-order merge in plain PyTorch
(``ref.flash_attention_split_ref``).

The planner gives at least one split and at most ``SPLIT_MAX``, takes no
batch size (so a row's bits do not depend on what shares its launch),
leaves a row whose blocks cover half the card unsplit, and fills the card
at gemma3-4b's head-group rank.  The runs cover each visible kv tile of a
block exactly once and none starts in a hidden tile.  The split version
agrees with ``flash_attention_ref`` (held against the JAX function by the
LM tests) within ``_attn_tol``'s 2e-5 of the largest |value| at every mask
kind, and a row that sees no column gives 0.
"""
from __future__ import annotations

import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import ops, ref  # noqa: E402

N_SM = 132     # the H100's SMs

# (T, S, H, D, mask kind, window)
SHAPES = [
    (2048, 2048, 1, 256, "window", 1024),   # gemma3-4b's head-group rank
    (4096, 4096, 1, 128, "causal", 0),
    (2048, 2048, 2, 80, "bidir", 0),
    (1000, 1500, 2, 160, "causal", 0),      # T not a multiple of 64
    (1024, 1024, 16, 80, "bidir", 0),       # hubert-xlarge encode
    (512, 512, 16, 64, "causal", 0),        # a head-parallel rank
    (2048, 2048, 32, 128, "causal", 0),     # jamba's prefill
    (24, 24, 8, 8, "causal", 0),            # command-r smoke
    (130, 70, 2, 64, "causal", 0),          # T > S: rows that see nothing
    (300, 300, 1, 256, "window", 100),
    (33, 65, 2, 16, "bidir", 0),
]


def _visible_tiles(t, s, bk, kind, window):
    """Each block's visible kv tiles, from the plain mask."""
    m = ref.attention_mask(t, s, kind, window).numpy()
    out = []
    for q0 in range(0, t, ref.BLOCK_Q):
        cols = np.nonzero(m[q0:q0 + ref.BLOCK_Q].any(0))[0]
        out.append(sorted({int(c) // bk for c in cols}))
    return out


@pytest.mark.parametrize("t,s,h,d,kind,window", SHAPES)
def test_split_count_is_at_least_one_and_capped(t, s, h, d, kind, window):
    n = ops.split_count(t, s, h, d, kind, window, N_SM)
    assert 1 <= n <= ops.SPLIT_MAX


def test_split_count_takes_no_batch_size():
    """A row's split comes from its own quantities and the SM count only:
    the planner has no batch argument, so a B = 3 launch splits each row
    as a B = 1 launch does."""
    params = list(inspect.signature(ops.split_count).parameters)
    assert params == ["t", "s", "h", "d", "mask_kind", "window", "n_sm"]


@pytest.mark.parametrize("t,s,h,d,kind,window", SHAPES)
@pytest.mark.parametrize("nsplit", [1, 2, 3, 5, 32, None])
def test_runs_cover_each_visible_tile_once(t, s, h, d, kind, window, nsplit):
    """Every visible kv tile of a block lies in exactly one run, no run
    holds a hidden tile or starts in one, and a block has at most nsplit
    runs (the planner's count where nsplit is None)."""
    if nsplit is None:
        nsplit = ops.split_count(t, s, h, d, kind, window, N_SM)
    bk = ops.CC_BLOCK_K[d]
    runs = ref.tile_runs(t, s, bk, kind, window, nsplit)
    for block, vis in zip(runs, _visible_tiles(t, s, bk, kind, window)):
        assert 1 <= len(block) <= nsplit
        tiles = [j for first, end in block for j in range(first, end)]
        assert tiles == vis
        if vis:
            assert all(first in vis and end > first for first, end in block)
        else:
            assert block == [(0, 0)]


def test_gemma_head_group_rank_fills_the_card():
    """gemma3-4b's head-group rank (1 x 2048, one head, D 256, window
    1024) has 32 blocks unsplit; split, at least one block an SM."""
    t, s, h, d, kind, window = SHAPES[0]
    n = ops.split_count(t, s, h, d, kind, window, N_SM)
    runs = ref.tile_runs(t, s, ops.CC_BLOCK_K[d], kind, window, n)
    assert -(-t // ref.BLOCK_Q) * h == 32
    assert n > 1 and h * sum(len(r) for r in runs) >= N_SM


@pytest.mark.parametrize("t,s,h,d,kind,window", [
    (1024, 1024, 16, 80, "bidir", 0), (512, 512, 16, 64, "causal", 0),
    (2048, 2048, 32, 128, "causal", 0), (24, 24, 8, 8, "causal", 0)])
def test_rows_whose_blocks_cover_half_the_card_are_not_split(
        t, s, h, d, kind, window):
    assert ops.split_count(t, s, h, d, kind, window, N_SM) == 1


def _qkv(b, t, s, h, hk, d, seed):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(shape, np.float32))
                 for shape in ((b, t, h, d), (b, s, hk, d), (b, s, hk, d)))


def _tol(want):
    return 2e-5 * max(1.0, float(want.abs().max()))


@pytest.mark.parametrize("kind,window,b,t,s,h,hk,d", [
    ("causal", 0, 2, 200, 200, 4, 2, 64),
    ("causal", 0, 1, 150, 260, 2, 1, 128),    # T != S, T not a tile multiple
    ("window", 70, 1, 300, 300, 2, 1, 256),
    ("window", 16, 2, 150, 150, 4, 4, 8),
    ("bidir", 0, 2, 130, 130, 2, 2, 80),
    ("bidir", 0, 1, 65, 200, 4, 2, 160),
    ("bidir", 0, 1, 33, 65, 2, 2, 16),
])
@pytest.mark.parametrize("nsplit", [1, 2, 3, 8])
def test_split_ref_matches_flash_attention_ref(kind, window, b, t, s, h, hk,
                                               d, nsplit):
    q, k, v = _qkv(b, t, s, h, hk, d, t * 7 + d + nsplit)
    want = ref.flash_attention_ref(q, k, v, kind, window)
    got = ref.flash_attention_split_ref(q, k, v, kind, window, nsplit,
                                        ops.CC_BLOCK_K[d])
    assert got.shape == want.shape and got.dtype == want.dtype
    assert float((got - want).abs().max()) <= _tol(want)


def test_split_ref_at_the_planners_split_of_a_split_shape():
    """The planner's own count at a shape it splits (1 x 1024, two heads,
    D 16: 32 blocks)."""
    t, s, h, d = 1024, 1024, 2, 16
    n = ops.split_count(t, s, h, d, "causal", 0, N_SM)
    assert n > 1
    q, k, v = _qkv(1, t, s, h, h, d, 3)
    want = ref.flash_attention_ref(q, k, v, "causal", 0)
    got = ref.flash_attention_split_ref(q, k, v, "causal", 0, n,
                                        ops.CC_BLOCK_K[d])
    assert float((got - want).abs().max()) <= _tol(want)


@pytest.mark.parametrize("nsplit", [1, 2])
def test_split_ref_row_that_sees_nothing_is_zero(nsplit):
    """T > S causal: the first T - S rows see no column and give 0 (C5);
    the others match the plain attention."""
    t, s = 130, 70
    q, k, v = _qkv(1, t, s, 2, 2, 64, 11)
    got = ref.flash_attention_split_ref(q, k, v, "causal", 0, nsplit, 64)
    want = ref.flash_attention_ref(q, k, v, "causal", 0)
    assert torch.equal(got[:, :t - s], torch.zeros_like(got[:, :t - s]))
    assert float((got[:, t - s:] - want[:, t - s:]).abs().max()) <= _tol(want)


def test_cpu_wrapper_takes_the_plain_version():
    q, k, v = _qkv(1, 70, 70, 2, 2, 64, 5)
    before = ops.launches["flash_attention"]
    got = ops.flash_attention(q, k, v, "causal")
    assert ops.launches["flash_attention"] == before
    assert torch.equal(got, ref.flash_attention_ref(q, k, v, "causal"))
