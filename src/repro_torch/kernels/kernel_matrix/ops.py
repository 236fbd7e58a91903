"""Wrappers for the kernel-matrix kernels: checks, dispatch by device.

Three entry points:

  * ``kernel_matrix`` — the one-shot Gram K = k_gamma(x, z) (B7): D² and
                        the gamma epilogue in one launch, D² never stored;
  * ``sq_dists``      — the gamma-independent D² matrix (B1), optionally
                        batched over a leading slot axis; ``symmetric=True``
                        (the train Gram of a wave of cells, z is x) takes
                        the upper-tile kernel whose result equals its
                        transpose bitwise;
  * ``gram_from_d2``  — the per-gamma epilogue replayed over a cached D²
                        (B2), f32 or bf16 in and out.

A tensor on the CPU goes to the plain version in ``ref.py``; a CUDA tensor
goes to the hand-written kernel in ``csrc/kernel_matrix.cu`` or the call
raises.  :func:`sq_dists_plan` picks the D² kernel by shape: few query rows
a slot (n <= ROWS_MAX) stream the z table past 8 x rows a block, more rows
and the symmetric D² take the 128 x 128 register tile; both compute every
value with the same arithmetic, so the choice never changes a bit.
``launches`` counts kernel launches (never plain-version calls).
"""
from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Union

import torch

from repro_torch.kernels import runtime
from repro_torch.kernels.kernel_matrix import ref

KINDS = {"gauss_rbf": 0, "laplacian": 1}
OUT_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
SMEM_MAX = 232448   # bytes a block may use on sm_90
ROWS_MAX = 16       # query rows a slot up to which z is streamed
ROW_BLOCK = 8       # x rows a block of the streamed kernel
Z_TILE = 128        # z rows a ring stage of the streamed kernel
ROWS_STAGES = 3     # its ring stages
CHUNKS = (64, 32, 16, 8, 4)   # its feature chunks, widest first
TILE = 128          # square tile of the register-tiled kernel
TILE_WHOLE = 54     # widest d staged a whole tile an item
TILE_CHUNK = 32     # features an item when d is wider
_STATIC = 1024      # static shared bytes of either kernel, rounded up

launches: Dict[str, int] = {"sq_dists": 0, "sq_dists_sym": 0,
                             "gram_from_d2": 0, "gram": 0}


class D2Plan(NamedTuple):
    rows: bool       # stream z past ROW_BLOCK x rows (else the tile)
    v: int           # floats a per-thread copy
    bulk: bool       # row spans moved by the TMA unit
    dk: int          # feature chunk (one chunk when d <= dk)
    ld: int          # shared row stride of a copied chunk (words)
    smem: int        # dynamic shared memory bytes


def tile_plan(n: int, m: int, d: int, v: int,
              aligned: bool = False) -> D2Plan:
    """The register tile, (n, d) rows against (m, d) rows a slot.  Both
    128-row blocks of an item land row-major at a shared stride of 2 mod 4
    words (8-byte reads of a feature pair free of bank conflicts when they
    are transposed to feature-major beside them), so copies move 8 bytes
    at most (v <= 2).  Up to d = TILE_WHOLE an item is a whole tile (two
    blocks an SM fit); wider rows go in chunks of TILE_CHUNK features.
    Each row block is one contiguous span, moved by the TMA unit
    (``bulk``), where it is whole at its own stride (d = 2 mod 4) and
    every span is 16-byte aligned (``aligned``: the tables start so, and
    n d and m d are multiples of 4): d 54."""
    whole = d <= TILE_WHOLE
    dk = max(d, 1) if whole else TILE_CHUNK
    dkp = dk + dk % 2
    ld = dkp + (2 if dkp % 4 == 0 else 0)
    bulk = (aligned and whole and ld == d and (n * d) % 4 == 0
            and (m * d) % 4 == 0)
    return D2Plan(False, min(v, 2), bulk, dk, ld,
                  4 * 2 * TILE * (ld + dkp))


def sq_dists_plan(n: int, m: int, d: int, v: int, aligned: bool = False,
                  vx: int = 4, x_aligned: bool = True) -> D2Plan:
    """B1's launch by shape.  n <= ROWS_MAX query rows a slot (the serving
    wave's 8): the z table streams in tiles of 128 rows through a
    ROWS_STAGES-stage ring past 8 x rows a block, in the widest chunk (the
    whole row up to 64 features, else 64) whose stages fit beside the x
    rows; a tile moves as one span by the TMA unit (``bulk``) when its
    rows are whole in one chunk at their own stride (d / v odd:
    conflict-free) and every span is 16-byte aligned (``aligned``: z
    starts so, and m d % 4 == 0): d 54.  Else, and for more rows, the 128
    x 128 register tile (``tile_plan``).  ``v`` / ``vx``: the copy widths z
    / x allow (``runtime.copy_width``); ``aligned`` / ``x_aligned``: z / x
    start on 16 bytes."""
    if n <= ROWS_MAX and d:
        x_bytes = 4 * ROW_BLOCK * d
        for dk in CHUNKS:
            ld = runtime.smem_stride(min(dk, d), v)
            bulk = aligned and d <= dk and ld == d and (m * d) % 4 == 0
            smem = x_bytes + ROWS_STAGES * 4 * (-(-Z_TILE * ld // 4) * 4)
            if smem + _STATIC <= SMEM_MAX:
                return D2Plan(True, v, bulk, dk, ld, smem)
    return tile_plan(n, m, d, min(v, vx), aligned and x_aligned)


def _lib() -> ctypes.CDLL:
    lib = runtime.library("kernel_matrix")
    if not getattr(lib, "_bound", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.sq_dists_f32.argtypes = [p, p, p] + [i] * 10 + [p]
        lib.sq_dists_f32.restype = i
        lib.sq_dists_sym_f32.argtypes = [p, p] + [i] * 8 + [p]
        lib.sq_dists_sym_f32.restype = i
        lib.gram_from_d2.argtypes = [p, p, p, i, i, ctypes.c_longlong,
                                     i, i, i, p]
        lib.gram_from_d2.restype = i
        lib.gram_f32.argtypes = [p, p, p, i, i, i, ctypes.c_float] + [i] * 6 \
            + [p]
        lib.gram_f32.restype = i
        lib._bound = True
    return lib


def _operand_fit(d: int, *tables: torch.Tensor):
    """(copy width, 16-byte aligned) that every table allows."""
    ptrs = [t.data_ptr() for t in tables]
    return (min(runtime.copy_width(d, p) for p in ptrs),
            all(p % 16 == 0 for p in ptrs))


def kernel_matrix(x: torch.Tensor, z: torch.Tensor, gamma: float,
                  kind: str = "gauss_rbf") -> torch.Tensor:
    """K[i, j] = k_gamma(x_i, z_j); (n, d) x (m, d) -> (n, m) f32.

    One pass on the card: each D² value (clamped at 0) goes through the
    Gaussian or Laplacian epilogue before it is stored.  ``gamma`` is a
    Python scalar or a 0-d tensor.
    """
    if kind not in KINDS:
        raise ValueError(f"unknown kernel kind {kind!r}")
    runtime.check_tensor("x", x, (torch.float32,), ndim=2)
    runtime.check_tensor("z", z, (torch.float32,), ndim=2)
    if x.shape[1] != z.shape[1] or x.device != z.device:
        raise ValueError(f"kernel_matrix: x {tuple(x.shape)} on {x.device}, "
                         f"z {tuple(z.shape)} on {z.device} disagree")
    g = float(gamma)
    if x.device.type == "cpu":
        return ref.kernel_matrix_ref(x, z, g, kind)
    n, d = x.shape
    m = z.shape[0]
    runtime.check_launch("kernel_matrix", (x, z), x.device)
    if -(-n // TILE) * -(-m // TILE) >= 2 ** 31:
        raise ValueError(f"kernel_matrix: {n} x {m} rows exceed the grid")
    out = torch.empty((n, m), dtype=torch.float32, device=x.device)
    if out.numel():
        plan = tile_plan(n, m, d, *_operand_fit(d, x, z))
        rc = _lib().gram_f32(runtime.ptr(x), runtime.ptr(z), runtime.ptr(out),
                             n, m, d, g, KINDS[kind], plan.v, int(plan.bulk),
                             plan.dk, plan.ld, plan.smem,
                             runtime.stream_handle(x.device))
        runtime.raise_on_error("kernel_matrix", rc)
        launches["gram"] += 1
    return out


def sq_dists(x: torch.Tensor, z: torch.Tensor,
             symmetric: bool = False) -> torch.Tensor:
    """Pairwise squared distances, f32.

    (n, d) x (m, d) -> (n, m), or batched (B, n, d) x (B, m, d) ->
    (B, n, m) in one launch (the engine's per-slot wave D²).

    ``symmetric=True`` requires z to be the same points as x (callers pass
    x twice, as the reference's contract says): the kernel computes only
    the upper tiles and stores each tile's transpose, so the result equals
    its transpose bitwise.
    """
    runtime.check_tensor("x", x, (torch.float32,))
    runtime.check_tensor("z", z, (torch.float32,))
    if x.dim() not in (2, 3) or z.dim() != x.dim():
        raise ValueError(f"sq_dists: x {tuple(x.shape)}, z {tuple(z.shape)}: "
                         f"need (n, d), (m, d) or (B, n, d), (B, m, d)")
    if x.shape[-1] != z.shape[-1] or x.shape[:-2] != z.shape[:-2]:
        raise ValueError(f"sq_dists: x {tuple(x.shape)} and z "
                         f"{tuple(z.shape)} disagree")
    if x.device != z.device:
        raise ValueError(f"sq_dists: x on {x.device}, z on {z.device}")
    if symmetric and x.shape != z.shape:
        raise ValueError(f"sq_dists(symmetric=True): x {tuple(x.shape)} and "
                         f"z {tuple(z.shape)} must be the same points")
    if x.device.type == "cpu":
        return ref.sq_dists_ref(x, z, symmetric=symmetric)
    if symmetric:
        return _sq_dists_sym(x)

    xb, zb = (x, z) if x.dim() == 3 else (x[None], z[None])
    b, n, d = xb.shape
    m = zb.shape[1]
    runtime.check_launch("sq_dists", (xb, zb), x.device)
    zp, xp = zb.data_ptr(), xb.data_ptr()
    plan = sq_dists_plan(n, m, d, runtime.copy_width(d, zp), zp % 16 == 0,
                         runtime.copy_width(d, xp), xp % 16 == 0)
    if not plan.rows and b * -(-n // TILE) * -(-m // TILE) >= 2 ** 31:
        raise ValueError(f"sq_dists: batch {b} or rows {n} x {m} exceed "
                         f"the grid")
    out = torch.empty((b, n, m), dtype=torch.float32, device=x.device)
    if out.numel():
        rc = _lib().sq_dists_f32(runtime.ptr(xb), runtime.ptr(zb),
                                 runtime.ptr(out), b, n, m, d,
                                 int(plan.rows), plan.v, int(plan.bulk),
                                 plan.dk, plan.ld, plan.smem,
                                 runtime.stream_handle(x.device))
        runtime.raise_on_error("sq_dists", rc)
        launches["sq_dists"] += 1
    return out if x.dim() == 3 else out[0]


def _sq_dists_sym(x: torch.Tensor) -> torch.Tensor:
    xb = x if x.dim() == 3 else x[None]
    b, n, d = xb.shape
    runtime.check_launch("sq_dists_sym", (xb,), x.device)
    n_tiles = -(-n // TILE)
    if b * (n_tiles * (n_tiles + 1) // 2) >= 2 ** 31:
        raise ValueError(f"sq_dists: batch {b} or rows {n} exceed the grid")
    out = torch.empty((b, n, n), dtype=torch.float32, device=x.device)
    if out.numel():
        plan = tile_plan(n, n, d, *_operand_fit(d, xb))
        rc = _lib().sq_dists_sym_f32(runtime.ptr(xb), runtime.ptr(out), b, n,
                                     d, plan.v, int(plan.bulk), plan.dk,
                                     plan.ld, plan.smem,
                                     runtime.stream_handle(x.device))
        runtime.raise_on_error("sq_dists_sym", rc)
        launches["sq_dists_sym"] += 1
    return out if x.dim() == 3 else out[0]


def gram_from_d2(d2: torch.Tensor, gamma: Union[float, torch.Tensor],
                 kind: str = "gauss_rbf", out_dtype: str = "f32"
                 ) -> torch.Tensor:
    """Apply the per-gamma kernel epilogue to a cached D² matrix.

    ``d2`` (n, m) with a scalar ``gamma`` -> (n, m); or ``d2`` (B, n, m)
    with ``gamma`` a (B, G) tensor -> (B, G, n, m): every batch entry's D²
    replayed for each of its G gammas in one launch.  ``d2`` is f32 or
    bf16; ``out_dtype`` "f32" or "bf16".
    """
    if kind not in KINDS:
        raise ValueError(f"unknown kernel kind {kind!r}")
    if out_dtype not in OUT_DTYPES:
        raise ValueError(f"out_dtype must be f32|bf16, got {out_dtype!r}")
    runtime.check_tensor("d2", d2, (torch.float32, torch.bfloat16))
    if d2.dim() == 2:
        g = torch.as_tensor(gamma, dtype=torch.float32)
        if g.dim() != 0:
            raise ValueError("gram_from_d2: a 2-D d2 takes a scalar gamma")
        if d2.device.type == "cpu":
            return ref.gram_from_d2_ref(d2, g, kind, out_dtype)
        out = _gram_launch(d2[None], g.to(d2.device).reshape(1, 1), kind,
                           out_dtype)
        return out[0, 0]
    if d2.dim() != 3:
        raise ValueError(f"gram_from_d2: d2 must be (n, m) or (B, n, m), "
                         f"got {tuple(d2.shape)}")
    runtime.check_tensor("gamma", gamma, (torch.float32,), ndim=2)
    if gamma.shape[0] != d2.shape[0] or gamma.device != d2.device:
        raise ValueError(f"gram_from_d2: gamma {tuple(gamma.shape)} on "
                         f"{gamma.device} for d2 {tuple(d2.shape)} on "
                         f"{d2.device}")
    if d2.device.type == "cpu":
        return ref.gram_from_d2_ref(d2[:, None], gamma[:, :, None, None],
                                    kind, out_dtype)
    return _gram_launch(d2, gamma, kind, out_dtype)


def _gram_launch(d2: torch.Tensor, gammas: torch.Tensor, kind: str,
                 out_dtype: str) -> torch.Tensor:
    b, n, m = d2.shape
    g_count = gammas.shape[1]
    runtime.check_launch("gram_from_d2", (d2, gammas), d2.device)
    out = torch.empty((b, g_count, n, m), dtype=OUT_DTYPES[out_dtype],
                      device=d2.device)
    if out.numel():
        rc = _lib().gram_from_d2(
            runtime.ptr(d2), runtime.ptr(gammas), runtime.ptr(out), b,
            g_count, n * m, int(d2.dtype == torch.bfloat16),
            int(out_dtype == "bf16"), KINDS[kind],
            runtime.stream_handle(d2.device))
        runtime.raise_on_error("gram_from_d2", rc)
        launches["gram_from_d2"] += 1
    return out
