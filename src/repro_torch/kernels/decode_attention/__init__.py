from repro_torch.kernels.decode_attention.ops import decode_attention_fused

__all__ = ["decode_attention_fused"]
