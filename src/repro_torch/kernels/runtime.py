"""Device resolution and the build of the hand-written CUDA kernels.

Where the JAX package resolves an ``interpret`` knob against the backend,
the port resolves a *device*: entry points run on CUDA unless the caller
asks for the CPU, and a missing card is an error, never a silent CPU run.

The kernels live as CUDA C++ under ``repro_torch/csrc/``, one shared
library per source with a plain C interface, bound through ``ctypes``.
Each library is compiled by ``nvcc`` for ``sm_90a`` at first use into
``build/kernels/`` of the checkout (listed in ``.gitignore``) and rebuilt
when its source is newer than the library.  Nothing is compiled when a
module is imported, so the CPU tests import every module without a
toolchain.
"""
from __future__ import annotations

import contextlib
import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional, Union

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("kernel_matrix", "svm_predict", "cd_solver", "flash_attention",
           "decode_attention", "assign")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def resolve_device(device: Union[None, str, torch.device] = None
                   ) -> torch.device:
    """``None`` -> the current CUDA device; raises when there is none.

    An explicit ``"cpu"`` selects the plain PyTorch path (the tests' mode);
    an explicit CUDA device without a card raises as well.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the GPU by default; pass "
                "device='cpu' to run the plain PyTorch path")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is not "
                               f"available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
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
    contiguous (the kernels index with dense row-major strides)."""
    for t in tensors:
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
    lib = _lib_path(name)
    return (not lib.exists()
            or lib.stat().st_mtime < (CSRC / f"{name}.cu").stat().st_mtime)


def build(names: Iterable[str] = SOURCES) -> Dict[str, dict]:
    """Compile the named sources, one ``nvcc`` each, all started together.

    Returns ``{name: {"seconds": wall time, "log": nvcc's stderr}}`` (the
    ``-Xptxas -v`` register and shared-memory report).  Raises with the
    compiler's output when a build fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        tmp = BUILD_DIR / f"lib{name}.{os.getpid()}.tmp.so"
        cmd = [exe, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out: Dict[str, dict] = {}
    failed = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        out[name] = {"seconds": time.perf_counter() - t0, "log": log}
        if proc.returncode != 0:
            failed.append(f"--- {name} (rc {proc.returncode}) ---\n{log}")
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


def stream_handle(device: torch.device) -> ctypes.c_void_p:
    """PyTorch's current stream on ``device``, for a kernel launch."""
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def raise_on_error(name: str, rc: int) -> None:
    """The C entry points return ``cudaGetLastError()`` after the launch."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")
