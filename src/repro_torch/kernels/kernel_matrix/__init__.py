from repro_torch.kernels.kernel_matrix.ops import gram_from_d2, sq_dists

__all__ = ["gram_from_d2", "sq_dists"]
