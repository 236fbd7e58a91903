"""Static load balancing (``planner``: the serving wave plan and the cell
packing) and the wave trainer (``cell_trainer``).  The package init imports
only the planner: the trainer is imported where it is used."""
from repro_torch.distributed.planner import (PackedCells, WavePlan,
                                             pack_cells, plan_wave)

__all__ = ["PackedCells", "WavePlan", "pack_cells", "plan_wave"]
