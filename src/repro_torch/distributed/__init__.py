"""Static load balancing (``planner``: the serving wave plan and the cell
packing), the wave trainer (``cell_trainer``, its waves split over a
mesh's ranks when given one) and int8 error-feedback gradient
compression with its all-reduce over a mesh axis (``compression``).
The package init
imports only the planner: the others are imported where they are used."""
from repro_torch.distributed.planner import (PackedCells, WavePlan,
                                             pack_cells, plan_wave)

__all__ = ["PackedCells", "WavePlan", "pack_cells", "plan_wave"]
