"""qwen3-moe-235b-a22b — MoE 128 experts top-8 [hf:Qwen/Qwen3-235B-A22B].

94L d_model=4096 64H (GQA kv=4) vocab=151936; head_dim 128, qk-norm.
Fine-grained experts: moe_d_ff=1536 per expert, every layer MoE, no shared
expert.  Experts sharded over 'model' (EP=16 -> 8 experts/device); FSDP.
Pure full attention => `long_500k` SKIPPED.
One card holds its widths at 2 layers (6.2 B parameters, 12.4 GB in
bf16); chip_smoke.py runs that cut.  GQA group 16: B10 runs it as two
slices of 8.
"""
from repro_torch.configs.common import shapes_for
from repro_torch.models.model import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4, head_dim=128,
    d_ff=1536, vocab=151936,
    period_pattern=(("attn", "moe"),),
    qk_norm=True,
    n_experts=128, top_k=8, moe_d_ff=1536, n_shared_experts=0,
    norm="rmsnorm", act="silu",
    fsdp_params=True,
)

SMOKE = ModelConfig(
    name="qwen3-moe-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=32, vocab=503,
    period_pattern=(("attn", "moe"),),
    qk_norm=True, n_experts=8, top_k=2, moe_d_ff=32, moe_chunk=64,
    ce_chunk=16, attn_chunk=16,
    norm="rmsnorm", act="silu", remat=False,
)

SHAPES = shapes_for(("train_4k", "prefill_32k", "decode_32k"))
