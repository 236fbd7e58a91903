"""hubert-xlarge — audio encoder-only [arXiv:2106.07447].

48L d_model=1280 16H (kv=16 MHA) d_ff=5120 vocab=504 (masked-prediction
codebook classes); head_dim 80.  Bidirectional attention, no RoPE (HuBERT
uses a conv positional frontend — stubbed with the frame embeddings).
Encoder-only => no autoregressive decode => decode_32k / long_500k
SKIPPED; prefill_32k runs ``models.model.encode`` (full-sequence logits).
About 1.3 B parameters.
"""
from repro_torch.configs.common import shapes_for
from repro_torch.models.model import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    n_layers=48, d_model=1280, n_heads=16, n_kv_heads=16, head_dim=80,
    d_ff=5120, vocab=504,
    period_pattern=(("attn_bidir", "dense"),),
    rotary_frac=0.0,                      # conv-positional stub, no rope
    input_kind="embed", d_frontend=512,   # CNN feature-extractor output dim
    norm="layernorm", act="gelu",
)

SMOKE = ModelConfig(
    name="hubert-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab=61,
    period_pattern=(("attn_bidir", "dense"),),
    rotary_frac=0.0, input_kind="embed", d_frontend=32,
    ce_chunk=16, attn_chunk=16,
    norm="layernorm", act="gelu", remat=False,
)

SHAPES = shapes_for(("train_4k", "prefill_32k"), encoder_only=True)
