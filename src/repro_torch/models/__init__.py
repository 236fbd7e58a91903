"""LM stack of the port: layers, attention, the rwkv6 mixer, the
composable model and the bridge from the JAX package's parameter and
cache trees (``convert``).  Dense attention and rwkv6 architectures; the
MoE and mamba mixers wait."""
