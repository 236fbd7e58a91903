"""Launch helpers: the device mesh (``mesh``) and local ranks without
``torchrun`` (``local``).  The JAX package's dry run, cost model, shape
tables and LM command lines are not ported yet."""
