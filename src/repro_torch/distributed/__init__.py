"""Static load balancing: the per-step wave plan for serving (``planner``).
The cell packing and the wave trainer come with the training slice; this
package init imports no trainer."""
from repro_torch.distributed.planner import WavePlan, plan_wave

__all__ = ["WavePlan", "plan_wave"]
