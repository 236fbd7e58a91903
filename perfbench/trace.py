"""The device trace of a fit: ``torch.profiler`` around it, its Chrome
trace parsed into what the per-layer readers take.

``capture(fn)`` runs ``fn`` under the profiler (the card's activity, and
every host op with its input shapes, which give each matrix product its
operations) and returns its result, the profiler and the seconds ``fn``
took to the card's last kernel.  Recording a host op costs the host some
microseconds, so a fit whose pace the host sets runs slower under the
profiler and its idle share reads high.  (The card's activity alone would
cost less, but torch 2.11's CUDA-only profile gave every kernel zero
seconds on the H100.)  ``reduce`` writes the Chrome trace under a work
directory, parses it and deletes it: after the window, so the window's
clock never counts it.
"""
from __future__ import annotations

import bisect
import dataclasses
import json
import os
from typing import Callable, Dict, List, Tuple

# device activity: kernels, copies and fills
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# leaf matrix products whose input shapes give their operations
GEMM_OPS = ("aten::mm", "aten::bmm")
_ELEM_BYTES = {"float": 4, "double": 8}


@dataclasses.dataclass
class Gemm:
    name: str
    flops: float
    nbytes: float
    dtype: str
    device_s: float


@dataclasses.dataclass
class Trace:
    """``kernels``: (name, start s, seconds) of every device op; ``gemms``:
    the leaf matrix products with their kernels' seconds; ``busy_s`` the
    union of device activity; ``window_s`` the traced span; ``gaps``: idle
    seconds between device ops, by the host op in flight when each began."""
    kernels: List[Tuple[str, float, float]]
    gemms: List[Gemm]
    busy_s: float
    window_s: float
    gaps: Dict[str, float]


def _gemm_cost(dims, types) -> Tuple[float, float, str]:
    """(operations, bytes read once and written once, dtype) of one
    ``mm`` or ``bmm`` call."""
    esz = _ELEM_BYTES.get(types[0] if types else "float", 4)
    a, b = dims[0], dims[1]
    batch = a[0] if len(a) == 3 else 1
    n, k, m = a[-2], a[-1], b[-1]
    flops = 2.0 * batch * n * k * m
    nbytes = esz * batch * (n * k + k * m + n * m)
    return flops, nbytes, types[0] if types else "float"


def parse(path: str) -> Trace:
    """Read a Chrome trace; its window runs from the first host or device
    op to the end of the last."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    dev, cpu_ops, launches = [], [], {}
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        if cat in _DEVICE_CATS:
            dev.append(e)
        elif cat == "cpu_op":
            cpu_ops.append(e)
        elif cat in ("cuda_runtime", "cuda_driver"):
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = e
    del events
    dev.sort(key=lambda e: e["ts"])
    host = cpu_ops
    spans = dev + host
    t0_us = min(e["ts"] for e in spans)
    t1_us = max(e["ts"] + e["dur"] for e in spans)
    kernels = [(e["name"], e["ts"] * 1e-6, e["dur"] * 1e-6) for e in dev]

    # the innermost leaf GEMM op enclosing each launch, by thread
    gemm_ops = sorted((e for e in cpu_ops if e["name"] in GEMM_OPS),
                      key=lambda e: (e["tid"], e["ts"]))
    by_tid: Dict = {}
    for i, e in enumerate(gemm_ops):
        by_tid.setdefault(e["tid"], ([], []))
        by_tid[e["tid"]][0].append(e["ts"])
        by_tid[e["tid"]][1].append(i)
    gemm_s = [0.0] * len(gemm_ops)
    for e in dev:
        launch = launches.get(e.get("args", {}).get("correlation"))
        if launch is None or launch["tid"] not in by_tid:
            continue
        starts, ids = by_tid[launch["tid"]]
        j = bisect.bisect_right(starts, launch["ts"]) - 1
        if j >= 0:
            op = gemm_ops[ids[j]]
            if launch["ts"] <= op["ts"] + op["dur"]:
                gemm_s[ids[j]] += e["dur"] * 1e-6
    gemms = []
    for op, sec in zip(gemm_ops, gemm_s):
        args = op.get("args", {})
        dims, types = args.get("Input Dims"), args.get("Input type")
        if not dims or sec <= 0.0:
            continue
        flops, nbytes, dtype = _gemm_cost(dims, types or [])
        gemms.append(Gemm(op["name"], flops, nbytes, dtype, sec))

    # busy time: the union of device intervals inside the window
    busy, gaps, end = 0.0, {}, t0_us
    host.sort(key=lambda e: e["ts"])
    host_starts = [e["ts"] for e in host]
    for e in dev:
        s, t = max(e["ts"], t0_us), min(e["ts"] + e["dur"], t1_us)
        if t <= s:
            continue
        if s > end:
            gaps_key = _host_at(host, host_starts, end)
            gaps[gaps_key] = gaps.get(gaps_key, 0.0) + (s - end) * 1e-6
        if t > end:
            busy += (t - max(s, end)) * 1e-6
            end = t
    if t1_us > end:
        key = _host_at(host, host_starts, end)
        gaps[key] = gaps.get(key, 0.0) + (t1_us - end) * 1e-6
    return Trace(kernels=kernels, gemms=gemms, busy_s=busy,
                 window_s=(t1_us - t0_us) * 1e-6, gaps=gaps)


def _host_at(host: List[dict], starts: List[float], ts: float) -> str:
    """The latest-starting host op still running at ``ts`` (the innermost
    on its thread), or ``host (no op)``."""
    j = bisect.bisect_right(starts, ts) - 1
    best = None
    for i in range(j, max(j - 256, -1), -1):
        e = host[i]
        if e["ts"] + e["dur"] >= ts:
            best = e
            break
    return best["name"] if best is not None else "host (no op)"


def capture(fn: Callable):
    """Run ``fn()`` under the profiler: (result, profiler, seconds)."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts, record_shapes=True) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
    return out, prof, sec


def reduce(prof, workdir: str) -> Trace:
    """The profiler's Chrome trace, parsed; the file is deleted."""
    os.makedirs(workdir, exist_ok=True)
    path = os.path.join(workdir, "fit_trace.json")
    prof.export_chrome_trace(path)
    try:
        return parse(path)
    finally:
        os.remove(path)
