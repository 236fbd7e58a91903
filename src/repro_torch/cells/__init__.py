"""Working-set decomposition into cells (numpy, the JAX package's
``repro.cells``): the padded static-shape :class:`CellPlan`."""
from repro_torch.cells.builder import CellPlan, build_cells

__all__ = ["CellPlan", "build_cells"]
