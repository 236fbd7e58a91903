"""Device resolution and the build of the hand-written CUDA kernels.

Where the JAX package resolves an ``interpret`` knob against the backend,
the port resolves a *device*: entry points run on CUDA unless the caller
asks for the CPU, and a missing card is an error, never a silent CPU run.

The kernels live as CUDA C++ under ``repro_torch/csrc/``, one shared
library per source with a plain C interface, bound through ``ctypes``.
Each library is compiled by ``nvcc`` for ``sm_90a`` at first use into
``build/kernels/`` of the checkout (listed in ``.gitignore``) and rebuilt
when its source, or a header shared by the sources, is newer than the
library.  A source with many template instances splits them into
``#if BUILD_PART == p`` blocks (``build_parts``): it is compiled as one
object a part at once, each with ``-DBUILD_PART=p``, and the objects are
linked into its library.
Nothing is compiled when a module is imported, so the CPU tests import
every module without a toolchain.
"""
from __future__ import annotations

import contextlib
import ctypes
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional, Tuple, Union

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("kernel_matrix", "svm_predict", "cd_solver", "flash_attention",
           "decode_attention", "assign")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_PART_BLOCK = re.compile(r"^#if BUILD_PART == (\d+)\s*$", re.M)

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _rank_card() -> int:
    """The card of this process: under an initialised process group the
    rank's own, ``LOCAL_RANK`` (else the global rank) modulo the cards;
    otherwise the current device."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        return local % torch.cuda.device_count()
    return torch.cuda.current_device()


def resolve_device(device: Union[None, str, torch.device] = None
                   ) -> torch.device:
    """``None`` -> the current CUDA device (under a process group, the
    rank's card: ``cuda:{LOCAL_RANK % device_count}``); raises when there
    is none.

    An explicit ``"cpu"`` selects the plain PyTorch path (the tests' mode);
    an explicit CUDA device without a card raises as well.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the GPU by default; pass "
                "device='cpu' to run the plain PyTorch path")
        return torch.device("cuda", _rank_card())
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is not "
                               f"available")
        if dev.index is None:
            dev = torch.device("cuda", _rank_card())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}: cpu or cuda")
    return dev


def check_tensor(name: str, t: torch.Tensor, dtypes: tuple,
                 ndim: Optional[int] = None) -> None:
    """Raise on a dtype or rank the kernel does not take, or on a device
    that is neither the CPU (plain path) nor CUDA (kernel)."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a torch.Tensor, got {type(t)!r}")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {t.device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype} not in {dtypes}")
    if ndim is not None and t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got {tuple(t.shape)}")


def check_launch(name: str, tensors: Iterable[torch.Tensor],
                 device: torch.device) -> None:
    """Every operand of a kernel launch lies on ``device`` and is
    contiguous (the kernels index with dense row-major strides).  No
    kernel has a backward: with grad enabled, an operand that requires
    grad raises, since the output would silently cut it off from the
    gradient (training runs the plain, differentiable paths)."""
    grad = torch.is_grad_enabled()
    for t in tensors:
        if grad and t.requires_grad:
            raise ValueError(f"{name}: an operand requires grad and the "
                             f"kernel has no backward")
        if t.device != device:
            raise ValueError(f"{name}: operands on {t.device} and {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operand of shape {tuple(t.shape)} is "
                             f"not contiguous")


@contextlib.contextmanager
def full_fp32():
    """fp32 matrix products in full fp32 on the card, never TF32, for the
    duration (the GEMM-form distances and the solver already cancel to
    ~1e-4; TF32's 10-bit mantissa would swamp that).  Restores the
    caller's setting on exit."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                           "source on a machine with the CUDA toolkit")
    return path


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    """Missing, or older than its source or any shared header."""
    lib = _lib_path(name)
    if not lib.exists():
        return True
    srcs = [CSRC / f"{name}.cu", *CSRC.glob("*.cuh")]
    return lib.stat().st_mtime < max(p.stat().st_mtime for p in srcs)


def build_parts(src: Path) -> int:
    """Objects a source is compiled as: one for each part number of its
    ``#if BUILD_PART == p`` blocks (decode_attention: ~190 instances of
    cache type x head dim x group x heads a block x path), 0 for a source
    built in one piece."""
    found = {int(p) for p in _PART_BLOCK.findall(src.read_text())}
    if found and found != set(range(len(found))):
        raise ValueError(f"{src.name}: BUILD_PART blocks {sorted(found)} "
                         f"are not 0..n-1")
    return len(found)


def _run(procs) -> list:
    """(log, returncode) of each started process, in order."""
    return [(*p.communicate()[:1], p.returncode) for p in procs]


def build(names: Iterable[str] = SOURCES) -> Dict[str, dict]:
    """Compile the named sources, one ``nvcc`` each (one a part for a
    source in parts, ``build_parts``, then one link), all started
    together.

    Returns ``{name: {"seconds": wall time, "log": nvcc's stderr}}`` (the
    ``-Xptxas -v`` register and shared-memory report).  Raises with the
    compiler's output when a build fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    obj_flags = [f for f in NVCC_FLAGS if f != "-shared"] + ["-c"]
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        tmp = BUILD_DIR / f"lib{name}.{os.getpid()}.tmp.so"
        src = str(CSRC / f"{name}.cu")
        parts = build_parts(CSRC / f"{name}.cu")
        if parts:
            objs = [BUILD_DIR / f"{name}.{os.getpid()}.part{p}.o"
                    for p in range(parts)]
            cmds = [[exe, *obj_flags, f"-DBUILD_PART={p}", "-o", str(o), src]
                    for p, o in enumerate(objs)]
        else:
            objs, cmds = [], [[exe, *NVCC_FLAGS, "-o", str(tmp), src]]
        procs[name] = (tmp, objs, [subprocess.Popen(
            c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for c in cmds])
    out: Dict[str, dict] = {}
    failed = []
    for name, (tmp, objs, started) in procs.items():
        runs = _run(started)
        if objs and all(rc == 0 for _, rc in runs):
            runs += _run([subprocess.Popen(
                [exe, "-shared", "-o", str(tmp), *map(str, objs)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)])
        for o in objs:
            o.unlink(missing_ok=True)
        log = "".join(lg for lg, _ in runs)
        out[name] = {"seconds": time.perf_counter() - t0, "log": log}
        bad = [rc for _, rc in runs if rc != 0]
        if bad:
            failed.append(f"--- {name} (rc {bad[0]}) ---\n{log}")
            continue
        os.replace(tmp, _lib_path(name))
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return out


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built first if missing or stale."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            if _stale(name):
                build([name])
            lib = ctypes.CDLL(str(_lib_path(name)))
            _LIBS[name] = lib
        return lib


_SM_COUNT: Dict[int, int] = {}
_TICKETS: Dict[Tuple[str, int], torch.Tensor] = {}


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device (asked once)."""
    n = _SM_COUNT.get(device.index)
    if n is None:
        n = torch.cuda.get_device_properties(device).multi_processor_count
        _SM_COUNT[device.index] = n
    return n


def ticket_counters(name: str, device: torch.device, n: int) -> torch.Tensor:
    """At least ``n`` zeroed int32 tickets of kernel ``name`` on ``device``,
    kept across calls: a kernel's split merge takes its ticket with an
    atomic add and leaves it 0 again for the next launch."""
    buf = _TICKETS.get((name, device.index))
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _TICKETS[(name, device.index)] = buf
    return buf


def smem_stride(width: int, v: int) -> int:
    """Shared row stride (words) of a chunk ``width`` wide, read v floats
    a row by consecutive threads: a multiple of v with an odd quotient,
    so a warp's loads hit distinct banks."""
    ld = width
    while ld % v or (ld // v) % 2 == 0:
        ld += 1
    return ld


def copy_width(d: int, data_ptr: int) -> int:
    """Floats a cp.async copy of a row-major table moves: 4 where rows and
    the table are 16-byte aligned, 2 where 8-byte, else 1 (d 54: 2)."""
    for v in (4, 2):
        if d % v == 0 and data_ptr % (4 * v) == 0:
            return v
    return 1


def stream_handle(device: torch.device) -> ctypes.c_void_p:
    """PyTorch's current stream on ``device``, for a kernel launch."""
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def raise_on_error(name: str, rc: int) -> None:
    """The C entry points return ``cudaGetLastError()`` after the launch."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")
