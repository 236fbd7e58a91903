"""internvl2-76b — VLM: InternViT frontend + InternLM2 backbone
[arXiv:2404.16821].

Backbone only (the modality frontend is a stub): 80L d_model=8192 64H
(GQA kv=8) d_ff=28672 vocab=128256; head_dim 128.  Inputs are
precomputed patch embeddings (d_frontend=4096, the projector output
width), projected linearly to d_model.  Pure full attention =>
`long_500k` SKIPPED.  About 76 B parameters: beyond one 80 GB card, so
the port runs it at its smoke config (``fsdp_params`` has no effect on
one card).
"""
from repro_torch.configs.common import shapes_for
from repro_torch.models.model import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=28672, vocab=128256,
    period_pattern=(("attn", "dense"),),
    input_kind="embed", d_frontend=4096,
    norm="rmsnorm", act="silu",
    fsdp_params=True,
)

SMOKE = ModelConfig(
    name="internvl2-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=503,
    period_pattern=(("attn", "dense"),),
    input_kind="embed", d_frontend=32, ce_chunk=16, attn_chunk=16,
    norm="rmsnorm", act="silu", remat=False,
)

SHAPES = shapes_for(("train_4k", "prefill_32k", "decode_32k"))
