from repro_torch.kernels.assign.ops import assign

__all__ = ["assign"]
