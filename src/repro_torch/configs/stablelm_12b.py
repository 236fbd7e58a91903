"""stablelm-12b — dense GQA [hf:stabilityai/stablelm-2-12b].

40L d_model=5120 32H (GQA kv=8) d_ff=13824 vocab=100352; head_dim 160,
partial rotary (25%).  Pure full attention => `long_500k` SKIPPED.
About 12.1 B parameters: 24 GB in bf16, so one 80 GB card holds it.
"""
from repro_torch.configs.common import shapes_for
from repro_torch.models.model import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-12b",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, head_dim=160,
    d_ff=13824, vocab=100352,
    period_pattern=(("attn", "dense"),),
    rotary_frac=0.25, rope_theta=10000.0,
    norm="layernorm", act="silu",
)

SMOKE = ModelConfig(
    name="stablelm-12b-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=503,
    period_pattern=(("attn", "dense"),),
    rotary_frac=0.25, ce_chunk=16, attn_chunk=16,
    norm="layernorm", act="silu", remat=False,
)

SHAPES = shapes_for(("train_4k", "prefill_32k", "decode_32k"))
