"""stablelm-1.6b — dense, kv=32 => full MHA [hf:stabilityai/stablelm-2-1_6b].

24L d_model=2048 32H (GQA kv=32) d_ff=5632 vocab=100352; head_dim 64,
partial rotary 25%.  Pure full attention => `long_500k` SKIPPED.
"""
from repro_torch.configs.common import shapes_for
from repro_torch.models.model import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-1.6b",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=5632, vocab=100352,
    period_pattern=(("attn", "dense"),),
    rotary_frac=0.25,
    norm="layernorm", act="silu",
)

SMOKE = ModelConfig(
    name="stablelm-1.6b-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab=503,
    period_pattern=(("attn", "dense"),),
    rotary_frac=0.25, ce_chunk=16, attn_chunk=16,
    norm="layernorm", act="silu", remat=False,
)

SHAPES = shapes_for(("train_4k", "prefill_32k", "decode_32k"))
