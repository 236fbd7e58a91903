"""LM stack of the port: layers (with the templates' partition specs for
a mesh), attention, the rwkv6, MoE and mamba mixers, the composable model
and the bridge from the JAX package's parameter and cache trees
(``convert``)."""
