"""Launch helpers and tools: the device mesh (``mesh``), local ranks
without ``torchrun`` (``local``), the per-cell input structs and config
adaptation (``shapes``), the op-level cost counter (``op_cost``), the
production-mesh dry run (``dryrun``) and the LM command lines (``train``,
``serve``)."""
