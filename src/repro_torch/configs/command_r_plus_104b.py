"""command-r-plus-104b — dense GQA, no-bias [hf:CohereForAI/c4ai-command-r-plus].

64L d_model=12288 96H (GQA kv=8) d_ff=33792 vocab=256000; head_dim 128.
Pure full attention => `long_500k` SKIPPED.  About 104 B parameters:
beyond one 80 GB card, so the port runs it at its smoke config (head_dim
8; ``fsdp_params`` has no effect on one card).
"""
from repro_torch.configs.common import shapes_for
from repro_torch.models.model import ModelConfig

CONFIG = ModelConfig(
    name="command-r-plus-104b",
    n_layers=64, d_model=12288, n_heads=96, n_kv_heads=8, head_dim=128,
    d_ff=33792, vocab=256000,
    period_pattern=(("attn", "dense"),),
    norm="layernorm", act="silu",
    fsdp_params=True,
)

SMOKE = ModelConfig(
    name="command-r-smoke",
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, head_dim=8,
    d_ff=160, vocab=503,
    period_pattern=(("attn", "dense"),),
    ce_chunk=16, attn_chunk=16,
    norm="layernorm", act="silu", remat=False,
)

SHAPES = shapes_for(("train_4k", "prefill_32k", "decode_32k"))
