"""llama4-maverick-400b-a17b — MoE 128e top-1, early fusion
[hf:meta-llama/Llama-4-Maverick-17B-128E].

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048; head_dim 128.
Interleaved dense/MoE (period 2); MoE layers: 128 routed experts top-1
plus one always-on shared expert (the Maverick design).  Early-fusion
vision frontend is STUBBED (text tokens only).
Pure full attention => `long_500k` SKIPPED.  FSDP (400B).
One card holds its widths at one period (2 layers: 18.55 B parameters,
37.1 GB in bf16); chip_smoke.py runs that cut.  GQA group 5.
"""
from repro_torch.configs.common import shapes_for
from repro_torch.models.model import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
    d_ff=8192, vocab=202048,
    period_pattern=(("attn", "dense"), ("attn", "moe")),
    n_experts=128, top_k=1, moe_d_ff=8192, n_shared_experts=1,
    moe_capacity_factor=2.0,           # top-1 routing skews harder
    rope_theta=500000.0,
    norm="rmsnorm", act="silu",
    fsdp_params=True,
)

SMOKE = ModelConfig(
    name="llama4-smoke",
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=503,
    period_pattern=(("attn", "dense"), ("attn", "moe")),
    n_experts=8, top_k=1, moe_d_ff=64, n_shared_experts=1, moe_chunk=64,
    ce_chunk=16, attn_chunk=16,
    norm="rmsnorm", act="silu", remat=False,
)

SHAPES = shapes_for(("train_4k", "prefill_32k", "decode_32k"))
