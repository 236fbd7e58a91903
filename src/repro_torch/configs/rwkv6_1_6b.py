"""rwkv6-1.6b — Finch, data-dependent decay [arXiv:2404.05892].

24L d_model=2048 (attention-free) d_ff=7168 vocab=65536; 32 heads of 64.
Attention-free => O(1) decode state => `long_500k` RUNS.
"""
from repro_torch.configs.common import shapes_for
from repro_torch.models.model import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=7168, vocab=65536,
    period_pattern=(("rwkv", "rwkv_cm"),),
    rwkv_head_dim=64, rwkv_chunk=128,
    norm="layernorm", act="relu2",
)

SMOKE = ModelConfig(
    name="rwkv6-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab=503,
    period_pattern=(("rwkv", "rwkv_cm"),),
    rwkv_head_dim=16, rwkv_chunk=8, ce_chunk=16,
    norm="layernorm", act="relu2", remat=False,
)

SHAPES = shapes_for(("train_4k", "prefill_32k", "decode_32k", "long_500k"))
