from repro_torch.core.solvers.base import (BoxQPResult, box_qp,
                                           box_qp_batched, kkt_residual,
                                           power_iteration_l)
from repro_torch.core.solvers.expectile import solve_expectile
from repro_torch.core.solvers.hinge import hinge_boxes, solve_hinge
from repro_torch.core.solvers.least_squares import (solve_krr_chol,
                                                    solve_krr_eigh)
from repro_torch.core.solvers.quantile import quantile_boxes, solve_quantile

__all__ = [
    "BoxQPResult", "box_qp", "box_qp_batched", "kkt_residual",
    "power_iteration_l", "hinge_boxes", "solve_hinge", "solve_krr_eigh",
    "solve_krr_chol", "quantile_boxes", "solve_quantile", "solve_expectile",
]
