"""Flash-decoding over a cache split over the sequence, on the CPU: B10's
partials mode in its plain version (``kernels.decode_attention.ref.
decode_attention_partials_ref``), the visible run of one block of the
ring (``ops.block_visible_range``), and the merge of the blocks'
partials (``models.attention.merge_partials``).

The partials of every block of a ring, merged, equal the whole-ring
plain decode (``decode_attention_ref``) within 1e-6 of its largest
|value| (f32 sums in another order), with bf16-valued and int8 caches, a
window that wraps the ring, and blocks that hold no visible key (their
log-sum-exp -inf, their weight 0, never a NaN).  The CPU wrapper takes
the plain version and launches nothing.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.decode_attention import ops, ref  # noqa: E402
from repro_torch.models.attention import merge_partials  # noqa: E402

# (B, Hk, G, D, ring, position, window, blocks)
CASES = [
    (2, 4, 1, 64, 32, 31, 0, 2),       # full ring, two halves
    (2, 2, 4, 16, 32, 5, 0, 2),        # short prompt: the second half empty
    (1, 2, 2, 16, 12, 12, 8, 2),       # window 8 wraps: block 0's both ends
    (1, 2, 2, 16, 12, 13, 8, 4),       # wrapped, four blocks
    (3, 1, 5, 8, 40, 100, 0, 4),       # past the ring's end: every key
    (2, 2, 16, 8, 24, 30, 10, 3),      # a group of 16, window, three blocks
]


def _case(b, hk, g, d, s, quant, seed):
    gen = torch.Generator().manual_seed(seed)
    q = torch.randn(b, hk, g, d, generator=gen)
    k = torch.randn(b, s, hk, d, generator=gen)
    v = torch.randn(b, s, hk, d, generator=gen)
    if not quant:
        return q, k.bfloat16().float(), v.bfloat16().float(), None, None
    ks = k.abs().amax(-1, keepdim=True).div(127.0).clamp(min=1e-10)
    vs = v.abs().amax(-1, keepdim=True).div(127.0).clamp(min=1e-10)
    return (q, torch.round(k / ks).clamp(-127, 127).to(torch.int8),
            torch.round(v / vs).clamp(-127, 127).to(torch.int8), ks, vs)


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("case", CASES, ids=[str(c) for c in CASES])
def test_partials_merged_equal_whole_ring(case, quant):
    b, hk, g, d, s, pos, window, nb = case
    q, k, v, ks, vs = _case(b, hk, g, d, s, quant, seed=s + pos + nb)
    scale = d ** -0.5
    n = s // nb
    outs, lses, empty = [], [], 0
    for lo in range(0, s, n):
        blk = [None if t is None else t[:, lo:lo + n]
               for t in (k, v, ks, vs)]
        before = dict(ops.launches)
        o, lse = ops.decode_attention_partials(
            q, blk[0], blk[1], pos, scale, blk[2], blk[3], window=window,
            block=(lo, s))
        assert ops.launches == before
        assert o.dtype == lse.dtype == torch.float32
        assert o.shape == q.shape and lse.shape == q.shape[:3]
        if bool(torch.isneginf(lse).all()):
            empty += 1
            assert torch.equal(o, torch.zeros_like(o))
        outs.append(o)
        lses.append(lse)
    if pos < s // 2 and nb == 2:
        assert empty == 1
    # the merge as the ranks run it, here over the stacked blocks
    m = torch.stack(lses).amax(0)
    w = [torch.exp(l_ - m)[..., None] for l_ in lses]
    got = sum(o * w_ for o, w_ in zip(outs, w)) / sum(w)
    assert bool(torch.isfinite(got).all())
    want = ref.decode_attention_ref(q, k, v, pos, scale, ks, vs, window)
    err = float((got - want).abs().max())
    assert err <= 1e-6 * float(want.abs().max()), err


def test_merge_partials_without_groups_is_one_block():
    """With no group to merge over (the sequence not split), the merge
    returns the block's own output, and a block with no key never makes
    a NaN beside one that has keys."""
    gen = torch.Generator().manual_seed(0)
    o = torch.randn(2, 3, 4, 8, generator=gen)
    lse = torch.randn(2, 3, 4, generator=gen)
    assert torch.allclose(merge_partials(o, lse, []), o, rtol=0, atol=1e-6)
    lse2 = torch.full_like(lse, float("-inf"))
    m = torch.maximum(lse, lse2)
    w = torch.exp(lse2 - m)
    assert bool((w == 0).all()) and not bool(torch.isnan(w).any())


@pytest.mark.parametrize("s", [8, 9, 16])
def test_block_visible_range_is_one_run(s):
    """The visible keys of the ring that lie in a block, every position,
    window and split: one run of the block's own positions modulo its
    length, as a brute force over the keys finds them."""
    for pos in range(3 * s):
        for window in (0, 1, 3, 5, s, s + 2):
            g0, nv = ops.visible_range(s, pos, window)
            vis = {(g0 + j) % s for j in range(nv)}
            for m in (1, 2, 3, 4):
                if s % m:
                    continue
                n = s // m
                for lo in range(0, s, n):
                    s0, nvis = ops.block_visible_range(s, pos, window, lo, n)
                    got = {(s0 + j) % n for j in range(nvis)}
                    assert len(got) == nvis
                    assert got == {i for i in range(n) if lo + i in vis}


def test_partials_wrapper_checks_its_block():
    q = torch.zeros(1, 2, 1, 16)
    c = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError):
        ops.decode_attention_partials(q, c, c, 3, 0.25, block=(4, 8))
    with pytest.raises(ValueError):
        ops.decode_attention_partials(torch.empty((1, 2, 1, 16),
                                                  device="meta"),
                                      c, c, 3, 0.25, block=(0, 8))
    # zero logits over the 4 visible keys 0..3: a log-sum-exp of log 4
    np.testing.assert_allclose(
        ops.decode_attention_partials(q, c, c, 3, 0.25, block=(0, 16))[1]
        .numpy(), np.full((1, 2, 1), np.log(4.0)), rtol=1e-6)
