# Hand-written Hopper kernels, each package mirroring the JAX package's
# repro/kernels/<name>/:
#   kernel_matrix    — batched squared distances (B1, B1-sym) and the
#                      per-gamma epilogue (B2)
#   svm_predict      — fused multi-cell K(test, SV) @ coefs (B3), Gram kept
#                      out of device memory
#   cd_solver        — Gauss-Seidel epochs over a wave (B4) or a slot (B5)
#   flash_attention  — online-softmax attention for prefill (B9)
#   decode_attention — one new token over a bf16/int8 ring cache (B10)
# Each package ships ops.py (checks + dispatch by the tensor's device) and
# ref.py (the plain PyTorch version); the CUDA sources are in ../csrc/.
