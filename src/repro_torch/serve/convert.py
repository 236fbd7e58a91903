"""Take over a bank built by the JAX package.

A bank is plain arrays plus a few meta keys, so state passes between the
two packages exactly: the array fields (numpy, with bf16 tables carried as
ml_dtypes ``bfloat16`` arrays on the JAX side) and the meta dict the JAX
package's checkpoint writes (``ModelBank._META_KEYS`` there,
``ModelBank.META_KEYS`` here).  bf16 tables keep their bits.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from repro_torch.serve.model_bank import ModelBank


def _table(a: np.ndarray):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(a).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return a


def bank_from_reference(arrays: Dict[str, np.ndarray], meta: dict
                        ) -> ModelBank:
    """The reference bank's array fields and meta keys in, the port's
    bank out.  Meta keys the reference bank predates take this package's
    field defaults."""
    fields = {f.name: f for f in dataclasses.fields(ModelBank)}
    array_names = [n for n in fields if n not in ModelBank.META_KEYS]
    missing = [n for n in array_names if n not in arrays]
    if missing:
        raise ValueError(f"bank_from_reference: missing arrays {missing}")
    kw = {n: _table(arrays[n]) for n in array_names}
    for k in ModelBank.META_KEYS:
        kw[k] = meta.get(k, fields[k].default)
    return ModelBank(**kw)
