"""Host data helpers, copied from the JAX package's ``repro.data``:
train-statistics scaling and the synthetic benchmark generators (numpy),
and the LM token pipeline (``tokens``, imported where it is used)."""
