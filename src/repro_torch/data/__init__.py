"""Host data helpers, numpy, copied from the JAX package's ``repro.data``:
train-statistics scaling and the synthetic benchmark generators."""
