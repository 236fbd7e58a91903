"""jax's threefry PRNG in numpy: ``PRNGKey``, ``split``, ``uniform``, ``normal``.

The yardstick's own copy (``repro_torch.core.prng`` holds the program's).
liquidSVM's CV draws three things from jax's threefry stream: the
per-slot fold keys (``split``), the fold masks (``uniform``) and the
power-iteration start vector (``normal``).  The plain reference of the fit
(``perfbench.reference.fit``) works out the same folds and the same start
vector from the configuration's seed, so it solves the very problems the
program solved.  The scheme, under jax 0.9 with
``jax_threefry_partitionable`` on:

* a key is a ``uint32[2]``; ``PRNGKey(seed)`` is ``[0, seed & 0xffffffff]``;
* ``split(key, num)`` and the bits of a draw of shape ``s`` both hash the
  64-bit flat index ``i`` of each output element as the counter pair
  ``(i >> 32, i & 0xffffffff)`` through Threefry-2x32 (20 rounds);
* ``split`` keeps both output words as the new key; 32-bit draws keep
  ``word0 ^ word1``;
* ``uniform`` puts the top 23 random bits into the mantissa of a float in
  [1, 2) and subtracts 1; ``normal`` is ``sqrt(2) * erfinv(u)`` with ``u``
  uniform on (-1, 1), erfinv by XLA's single-precision polynomial.
"""
from __future__ import annotations

from typing import Sequence, Tuple, Union

import numpy as np

Shape = Union[int, Sequence[int]]

_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(v: np.ndarray, r: int) -> np.ndarray:
    return (v << np.uint32(r)) | (v >> np.uint32(32 - r))


def threefry2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """The Threefry-2x32 hash (20 rounds) of the counter pairs (x0, x1);
    ``key[..., 0]`` and ``key[..., 1]`` broadcast against the counters."""
    k0, k1 = key[..., 0], key[..., 1]
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    with np.errstate(over="ignore"):
        x0 = x0.astype(np.uint32) + ks[0]
        x1 = x1.astype(np.uint32) + ks[1]
        for step in range(5):
            for r in _ROT[step % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r) ^ x0
            x0 = x0 + ks[(step + 1) % 3]
            x1 = x1 + ks[(step + 2) % 3] + np.uint32(step + 1)
    return x0, x1


def _shape(shape: Shape) -> Tuple[int, ...]:
    return (int(shape),) if np.ndim(shape) == 0 else tuple(int(s) for s in shape)


def _hash_iota(key: np.ndarray, shape: Tuple[int, ...]
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Hash the flat index of every element of ``shape``; a batch of keys
    (..., 2) gives (..., *shape)."""
    key = np.asarray(key, np.uint32)
    batch = key.shape[:-1]
    size = int(np.prod(shape, dtype=np.int64))
    i = np.arange(size, dtype=np.uint64)
    b0, b1 = threefry2x32(key.reshape(batch + (1, 2)),
                          (i >> np.uint64(32)).astype(np.uint32),
                          (i & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    return b0.reshape(batch + shape), b1.reshape(batch + shape)


def PRNGKey(seed: int) -> np.ndarray:  # noqa: N802 - jax's name
    """Raw threefry key of an integer seed, ``uint32[2]``.

    jax without x64 takes the seed as 32 bits, so the high word is 0."""
    return np.array([0, int(seed) & 0xFFFFFFFF], np.uint32)


def split(key: np.ndarray, num: Shape = 2) -> np.ndarray:
    """``jax.random.split``: ``(*num, 2)`` uint32 keys (a batch of keys
    (..., 2) splits each)."""
    b0, b1 = _hash_iota(key, _shape(num))
    return np.stack([b0, b1], axis=-1)


def random_bits(key: np.ndarray, shape: Shape) -> np.ndarray:
    """32 random bits per element of ``shape``."""
    b0, b1 = _hash_iota(key, _shape(shape))
    return b0 ^ b1


def uniform(key: np.ndarray, shape: Shape, minval: float = 0.0,
            maxval: float = 1.0) -> np.ndarray:
    """``jax.random.uniform`` in float32, bit for bit; a batch of keys
    (..., 2) draws (..., *shape), one draw per key."""
    bits = random_bits(key, shape)
    one = np.array(1.0, np.float32).view(np.uint32)
    floats = ((bits >> np.uint32(9)) | one).view(np.float32) - np.float32(1.0)
    lo, hi = np.float32(minval), np.float32(maxval)
    return np.maximum(lo, floats * (hi - lo) + lo).astype(np.float32)


# XLA's ErfInv32 (Giles' single-precision approximation): a polynomial in
# w - 2.5 for w = -log1p(-x^2) < 5, else in sqrt(w) - 3
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erfinv_f32(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, np.float32)
    w = -np.log1p(-x * x)
    lt = w < np.float32(5.0)
    w = np.where(lt, w - np.float32(2.5),
                 np.sqrt(w) - np.float32(3.0)).astype(np.float32)
    p = np.where(lt, np.float32(_ERFINV_LT5[0]), np.float32(_ERFINV_GE5[0]))
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = (np.where(lt, np.float32(a), np.float32(b)) + p * w
             ).astype(np.float32)
    out = p * x
    edge = np.abs(x) == np.float32(1.0)
    return np.where(edge, x * np.float32(np.inf), out).astype(np.float32)


def normal(key: np.ndarray, shape: Shape) -> np.ndarray:
    """``jax.random.normal`` in float32 (to f32 rounding)."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0), dtype=np.float32)
    u = uniform(key, shape, lo, 1.0)
    return (np.float32(np.sqrt(2.0)) * erfinv_f32(u)).astype(np.float32)
