"""Bridge from the JAX package's LM parameter and cache trees.

The JAX package keeps parameters and decode caches as nested dicts of
arrays with the same keys as the port (``models.model``).  Given such a
tree as numpy arrays (``jax.device_get`` or ``np.asarray`` per leaf),
these functions return the port's tree of tensors, bit for bit: every
leaf of every architecture carries across, the embed front end's
``frontend/proj`` (hubert, internvl2) in place of ``embed/tok``, the MoE
layers' f32 router and stacked (n_periods, E, d, ff) experts, and the
mamba layers' f32 ``conv_w``, ``a_log`` and ``dt_proj_*``.

bf16 leaves come out of JAX as numpy arrays of the ``bfloat16`` extension
type, which ``torch.from_numpy`` refuses; they are recognised by the type's
name and reinterpreted through their 16-bit pattern, so nothing here
imports the package that defines that type.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.models.layers import tree_map


def tensor_from_numpy(arr: Any, device: Optional[torch.device] = None
                      ) -> torch.Tensor:
    """One leaf, bitwise: bf16 through its uint16 pattern, every other
    dtype through ``torch.from_numpy``."""
    a = np.asarray(arr)
    if a.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(a).view(np.uint16).view(np.int16)
        t = torch.from_numpy(bits.copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(a).copy())
    return t if device is None else t.to(device)


def params_from_reference(tree: Dict[str, Any],
                          device: Optional[torch.device] = None
                          ) -> Dict[str, Any]:
    """The JAX package's parameter tree -> the port's (same keys)."""
    return tree_map(lambda a: tensor_from_numpy(a, device), tree)


# The JAX package's decode cache (stacked ``stack/pos<i>`` leaves and
# ``tail<j>`` leaves, k/v in the compute dtype or int8 with f32 scales)
# has the port's layout too: the same leaf-by-leaf conversion.
cache_from_reference = params_from_reference
