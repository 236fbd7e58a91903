"""gemma3-4b — dense GQA, 5:1 local:global interleave [hf:google/gemma-3-4b-pt].

34L d_model=2560 8H (GQA kv=4) d_ff=10240 vocab=262144; head_dim 256,
sliding window 1024 on local layers, tied embeddings, qk-norm, GeGLU.
Sub-quadratic enough for `long_500k`: 28/34 layers are 1024-windowed; the
6 global layers are O(n) per decoded token.

34 = 5 full periods of (5 local + 1 global) + a 4-local tail.
"""
from repro_torch.configs.common import shapes_for
from repro_torch.models.model import ModelConfig

_PERIOD = (("attn_local", "dense"),) * 5 + (("attn", "dense"),)

CONFIG = ModelConfig(
    name="gemma3-4b",
    n_layers=34, d_model=2560, n_heads=8, n_kv_heads=4, head_dim=256,
    d_ff=10240, vocab=262144,
    period_pattern=_PERIOD,
    window=1024, rope_theta=1_000_000.0, qk_norm=True, tie_embeddings=True,
    norm="rmsnorm", act="gelu",
)

SMOKE = ModelConfig(
    name="gemma3-smoke",
    n_layers=8, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=1031,
    period_pattern=(("attn_local", "dense"),) * 2 + (("attn", "dense"),),
    window=8, qk_norm=True, tie_embeddings=True, ce_chunk=16, attn_chunk=16,
    norm="rmsnorm", act="gelu", remat=False,
)

SHAPES = shapes_for(("train_4k", "prefill_32k", "decode_32k", "long_500k"))
