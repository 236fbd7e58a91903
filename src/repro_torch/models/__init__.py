"""LM stack of the port: layers, attention, the composable model and the
bridge from the JAX package's parameter and cache trees (``convert``).
Dense attention architectures only; the MoE, mamba and rwkv mixers wait."""
