# Hand-written Hopper kernels for the serving path, each package mirroring
# the JAX package's repro/kernels/<name>/:
#   kernel_matrix — batched squared distances (B1) and the per-gamma
#                   epilogue (B2)
#   svm_predict   — fused multi-cell K(test, SV) @ coefs (B3), Gram kept
#                   out of device memory
# Each package ships ops.py (checks + dispatch by the tensor's device) and
# ref.py (the plain PyTorch version); the CUDA sources are in ../csrc/.
