"""The precision a plain reference computes in.

``EXACT`` is float64 throughout: the judge.  ``TF32`` is the control: float32
with every matrix product's operands rounded to TF32 (10 mantissa bits) and
summed in float32, the precision just below the one the configurations
state (float32 products with TF32 off).  The operands are rounded here, on
the CPU and on the card alike: cuBLAS takes TF32 only where a product's
shapes and alignment suit its tensor-core kernels (not the D^2 of 54 or 28
features, nor a product with one column), so the card's own TF32 switch
would leave some products in float32.  TF32 does not reach an
eigendecomposition: the control's reads its matrix in bfloat16, the next
precision below float32 there (as the program's own ``gram_dtype="bf16"``
path would hand it a Gram).
"""
from __future__ import annotations

import dataclasses

import torch


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest value with a 10-bit mantissa (ties away from
    zero), as float32."""
    bits = t.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


@dataclasses.dataclass(frozen=True)
class Numerics:
    dtype: torch.dtype
    tf32: bool = False

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """``a @ b`` (batched where the operands are) in this precision."""
        if not self.tf32:
            return a @ b
        return round_tf32(a) @ round_tf32(b)

    def eigh_operand(self, a: torch.Tensor) -> torch.Tensor:
        """The matrix an eigendecomposition reads, in this precision."""
        if not self.tf32:
            return a
        return a.to(torch.bfloat16).to(a.dtype)

    def tensor(self, x, device) -> torch.Tensor:
        return torch.as_tensor(x).to(device=device, dtype=self.dtype)


EXACT = Numerics(torch.float64)
TF32 = Numerics(torch.float32, tf32=True)
