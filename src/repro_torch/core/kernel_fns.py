"""Kernel functions and the distance-cache API (the JAX package's
``core/kernel_fns.py``).

liquidSVM's RBF convention is ``k_gamma(u, v) = exp(-||u - v||^2 / gamma^2)``:
gamma is a length scale.  Both built-in kernels factor through the
gamma-independent squared-distance matrix, ``K_gamma = epilogue_gamma(D2)``,
so a grid scan pays the O(n^2 d) cross term once (B1) and replays an O(n^2)
elementwise epilogue per gamma (B2).  The registry records that
factorization; a kernel registered without an epilogue is evaluated in full
per gamma.

Everything takes tensors on one device and batches over leading axes where
the kernels do: a (S, n, d) wave of cells gives a (S, n, n) D² in one
launch, and its epilogue takes (S, G) gammas.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Union

import torch

from repro_torch.kernels.kernel_matrix import ops as km_ops

_EPS = 1e-12

Gamma = Union[float, torch.Tensor]
KernelFn = Callable[[torch.Tensor, torch.Tensor, Gamma], torch.Tensor]
# (d2, gamma, out_dtype) -> K;  out_dtype in {"f32", "bf16"}
D2Epilogue = Callable[[torch.Tensor, Gamma, str], torch.Tensor]


def sq_dists(x: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Pairwise squared distances in GEMM form: B1 on the card, its plain
    version on the CPU."""
    return km_ops.sq_dists(x, z)


def _full_kernel(kind: str) -> KernelFn:
    """``epilogue_gamma(D2(x, z))`` through the B1 and B2 wrappers.  A 2-D
    pair takes a scalar gamma; a (S, n, d) wave takes one gamma per slot
    (a scalar, (S,) or (S, 1, 1))."""
    def fn(x: torch.Tensor, z: torch.Tensor, gamma: Gamma) -> torch.Tensor:
        d2 = km_ops.sq_dists(x, z)
        if d2.dim() == 2:
            return km_ops.gram_from_d2(d2, gamma, kind=kind)
        g = torch.as_tensor(gamma, dtype=torch.float32, device=d2.device)
        g = g.reshape(-1, 1).expand(d2.shape[0], 1).contiguous()
        return km_ops.gram_from_d2(d2, g, kind=kind)[:, 0]

    return fn


gaussian = _full_kernel("gauss_rbf")        # exp(-||u - v||^2 / gamma^2)
laplacian = _full_kernel("laplacian")       # exp(-||u - v|| / gamma)


def libsvm_gamma_to_scale(g) -> torch.Tensor:
    """libsvm exp(-g d^2) == liquidSVM exp(-d^2/gamma^2) at gamma = g**-0.5."""
    return torch.as_tensor(g, dtype=torch.float32) ** -0.5


def cast_out(k: torch.Tensor, out_dtype: str) -> torch.Tensor:
    return k.to(torch.bfloat16) if out_dtype == "bf16" else k


def _builtin_epilogue(kind: str) -> D2Epilogue:
    def epilogue(d2: torch.Tensor, gamma: Gamma,
                 out_dtype: str = "f32") -> torch.Tensor:
        return km_ops.gram_from_d2(d2, gamma, kind=kind, out_dtype=out_dtype)

    return epilogue


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """Registry entry: the full kernel plus its (optional) D² epilogue,
    with ``fn(x, z, g) == d2_epilogue(sq_dists(x, z), g, "f32")``."""
    name: str
    fn: KernelFn
    d2_epilogue: Optional[D2Epilogue] = None

    @property
    def factors_through_d2(self) -> bool:
        return self.d2_epilogue is not None


_REGISTRY: Dict[str, KernelSpec] = {
    "gauss_rbf": KernelSpec("gauss_rbf", gaussian,
                            _builtin_epilogue("gauss_rbf")),
    "laplacian": KernelSpec("laplacian", laplacian,
                            _builtin_epilogue("laplacian")),
}


def register_kernel(name: str, fn: KernelFn,
                    d2_epilogue: Optional[D2Epilogue] = None) -> None:
    """Add a user kernel; pass ``d2_epilogue`` when it is a function of
    ||u - v||^2 so grid scans reuse the cached D²."""
    _REGISTRY[name] = KernelSpec(name, fn, d2_epilogue)


def unregister_kernel(name: str) -> None:
    _REGISTRY.pop(name)


def get_spec(name: str) -> KernelSpec:
    if name not in _REGISTRY:
        raise KeyError(f"unknown kernel {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def get_kernel(name: str) -> KernelFn:
    return get_spec(name).fn


def factors_through_d2(name: str) -> bool:
    return get_spec(name).factors_through_d2


def gram(x: torch.Tensor, gamma: Gamma, name: str = "gauss_rbf"
         ) -> torch.Tensor:
    return get_kernel(name)(x, x, gamma)


@dataclasses.dataclass(frozen=True)
class CachedGram:
    """Gamma-independent state of a Gram matrix: D² plus the epilogue.

    ``build(x)`` is the symmetric train Gram (B1's upper-tile kernel, equal
    to its transpose bitwise); ``build(x, z)`` a cross Gram.  ``x`` may be
    a (S, n, d) wave: one launch for all slots.  ``d2_dtype="bf16"`` keeps
    D² in bfloat16 (half the footprint; the epilogue reads it in f32, error
    at most e^-1 2^-8 on the Gaussian kernel).
    """
    d2: torch.Tensor
    name: str = "gauss_rbf"

    @classmethod
    def build(cls, x: torch.Tensor, z: Optional[torch.Tensor] = None,
              name: str = "gauss_rbf", d2_dtype: str = "f32"
              ) -> "CachedGram":
        if not get_spec(name).factors_through_d2:
            raise ValueError(f"kernel {name!r} does not factor through D2; "
                             f"use get_kernel(name) per gamma instead")
        if z is None:
            d2 = km_ops.sq_dists(x, x, symmetric=True)
        else:
            d2 = km_ops.sq_dists(x, z)
        if d2_dtype == "bf16":
            d2 = d2.to(torch.bfloat16)
        elif d2_dtype != "f32":
            raise ValueError(f"d2_dtype must be f32|bf16, got {d2_dtype!r}")
        return cls(d2=d2, name=name)

    @property
    def nbytes(self) -> int:
        return self.d2.numel() * self.d2.element_size()

    def gram(self, gamma: Gamma, out_dtype: str = "f32") -> torch.Tensor:
        """A 2-D D² takes a scalar gamma -> (n, m); a (S, n, m) wave takes
        (S, G) gammas -> (S, G, n, m)."""
        return get_spec(self.name).d2_epilogue(self.d2, gamma, out_dtype)

    def grams(self, gammas: torch.Tensor, out_dtype: str = "f32"
              ) -> torch.Tensor:
        """(G,) gammas over a 2-D D² -> (G, n, m), one launch."""
        if self.d2.dim() != 2:
            raise ValueError("grams: needs a 2-D D²; a wave takes (S, G) "
                             "gammas through gram()")
        g = torch.as_tensor(gammas, dtype=torch.float32,
                            device=self.d2.device)
        return get_spec(self.name).d2_epilogue(self.d2[None], g[None],
                                               out_dtype)[0]


def gram_for_gammas(x: torch.Tensor, z: torch.Tensor, gammas: torch.Tensor,
                    name: str = "gauss_rbf", symmetric: bool = False,
                    out_dtype: str = "f32") -> torch.Tensor:
    """Stacked (G, n, m) Grams with at most one D² materialization;
    ``symmetric=True`` means the Gram of x with itself (z is ignored)."""
    spec = get_spec(name)
    if symmetric:
        z = x
    if not spec.factors_through_d2:
        return torch.stack([cast_out(spec.fn(x, z, float(g)), out_dtype)
                            for g in gammas])
    cg = CachedGram.build(x, None if symmetric else z, name=name)
    return cg.grams(gammas, out_dtype)


def cross_gram_fn(x: torch.Tensor, z: torch.Tensor, name: str = "gauss_rbf",
                  d2_dtype: str = "f32"):
    """Per-gamma cross-Gram closure for a fixed (x, z) pair, the D² cached
    up front when the kernel factors through it."""
    spec = get_spec(name)
    if spec.factors_through_d2:
        return CachedGram.build(x, z, name=name, d2_dtype=d2_dtype).gram
    return lambda gamma, out_dtype="f32": cast_out(spec.fn(x, z, gamma),
                                                    out_dtype)


def _nanmedian(v: torch.Tensor) -> torch.Tensor:
    """jnp.nanmedian: the mean of the two middle values for an even count
    (``torch.nanmedian`` returns the lower one), as jnp's linear quantile
    forms it, ``lo * (1 - w) + hi * w``."""
    v = v.reshape(-1)
    v = torch.sort(v[~torch.isnan(v)]).values
    cnt = v.numel()
    if cnt == 0:
        return torch.tensor(float("nan"))
    q = torch.tensor(0.5 * (cnt - 1), dtype=torch.float32)
    lo_i, hi_i = int(torch.floor(q)), int(torch.ceil(q))
    w_hi = q - torch.floor(q)
    return v[lo_i] * (1.0 - w_hi) + v[hi_i] * w_hi


def median_heuristic(x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                     max_points: int = 512) -> torch.Tensor:
    """Median pairwise distance on a strided subsample (the bandwidth
    scale of the per-cell gamma grid)."""
    n = x.shape[0]
    stride = max(1, n // max_points)
    xs = x[::stride].to(torch.float32).contiguous()
    d2 = sq_dists(xs, xs)
    off = ~torch.eye(xs.shape[0], dtype=torch.bool, device=x.device)
    valid = off
    if mask is not None:
        ms = mask[::stride] > 0
        valid = valid & ms[:, None] & ms[None, :]
    med = _nanmedian(torch.where(valid, d2, torch.nan).cpu())
    return torch.sqrt(torch.clamp(med, min=_EPS))
