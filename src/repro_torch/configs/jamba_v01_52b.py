"""jamba-v0.1-52b — hybrid Mamba + attention 1:7, MoE 16e top-2
[arXiv:2403.19887].

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536; head_dim 128.
Period-8 Jamba block: 1 attention + 7 Mamba layers; MoE replaces the MLP
on every 2nd layer (odd positions).  Mamba: d_state=16, d_conv=4,
expand=2.  Mostly-SSM => `long_500k` RUNS (only 4/32 layers keep a KV
cache).  FSDP (52B).
One card holds its widths at one period (8 layers: 13.3 B parameters,
26.6 GB in bf16); chip_smoke.py runs that cut.
"""
from repro_torch.configs.common import shapes_for
from repro_torch.models.model import ModelConfig

_PERIOD = tuple(
    ("attn" if i == 0 else "mamba", "moe" if i % 2 == 1 else "dense")
    for i in range(8)
)

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab=65536,
    period_pattern=_PERIOD,
    n_experts=16, top_k=2, moe_d_ff=14336,
    ssm_d_state=16, ssm_d_conv=4, ssm_expand=2,
    rotary_frac=0.0,                      # Jamba uses no positional encoding
    norm="rmsnorm", act="silu",
    fsdp_params=True,
)

SMOKE = ModelConfig(
    name="jamba-smoke",
    n_layers=8, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=503,
    period_pattern=tuple(
        ("attn" if i == 0 else "mamba", "moe" if i % 2 == 1 else "dense")
        for i in range(4)),
    n_experts=4, top_k=2, moe_d_ff=64, moe_chunk=64,
    ssm_d_state=4, ssm_d_conv=2, ssm_chunk=8, rotary_frac=0.0,
    ce_chunk=16, attn_chunk=16,
    norm="rmsnorm", act="silu", remat=False,
)

SHAPES = shapes_for(("train_4k", "prefill_32k", "decode_32k", "long_500k"))
