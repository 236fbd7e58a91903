from repro_torch.kernels.kernel_matrix.ops import (gram_from_d2,
                                                  kernel_matrix, sq_dists)

__all__ = ["gram_from_d2", "kernel_matrix", "sq_dists"]
