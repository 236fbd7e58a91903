"""The yardstick's counts against hand counts at small shapes, and the
device trace's reduction on a recorded Chrome trace."""
from __future__ import annotations

import json

import numpy as np
import pytest

from perfbench import trace, yardstick

FIT = {"live": [3, 2], "held": [4, 1], "d": 5, "G": 2, "F": 2, "P": 3,
       "Pt": 1, "cd_polish": 1, "solver": "hinge",
       "iters": np.array([[[10, 3], [0, 21]], [[1, 1], [2, 2]]])}


def test_peaks_are_the_data_sheets():
    assert yardstick.PEAKS["fp32_flops"] == 67e12
    assert yardstick.PEAKS["hbm_bytes_per_s"] == 3.35e12
    assert yardstick.bound_s(67e12, 0) == 1.0
    assert yardstick.bound_s(1.0, 3.35e12) == 1.0


def test_fit_flops_by_hand():
    # D2: pairs n(n+1)/2 = 6 + 3 of 2*5+3 = 13
    d2 = 9 * 13
    b2 = 2 * 3 * (9 + 4)
    val = 2 * 2 * 2 * 3 * (9 + 4)
    # FISTA products, per (slot, gamma, fold): iters + iters//10 + 1
    prods_0 = (10 + 1 + 1) + (3 + 0 + 1) + (0 + 0 + 1) + (21 + 2 + 1)
    prods_1 = (1 + 1) + (1 + 1) + (2 + 1) + (2 + 1)
    fista = 2 * 3 * (9 * prods_0 + 4 * prods_1)
    power = 2 * 33 * 2 * (9 + 4)
    polish = 2 * 2 * 2 * 2 * 3 * (9 + 4)          # (epochs + 1) x 2n^2FP
    test = (4 * 3 + 1 * 2) * 13 + 3 * 1 * (12 + 2) + 2 * (12 + 2) * 1
    assert yardstick.fit_flops(FIT) == pytest.approx(
        d2 + b2 + val + fista + power + polish + test)


def test_fit_flops_least_squares_by_hand():
    fit = dict(FIT, solver="ls")
    d2 = 9 * 13
    b2 = 2 * 3 * (9 + 4)
    val = 2 * 2 * 2 * 3 * (9 + 4)
    eigh = 2 * 2 * (9 * (27 + 8) + 4 * 3 * (9 + 4))
    test = (4 * 3 + 1 * 2) * 13 + 3 * 1 * (12 + 2) + 2 * (12 + 2) * 1
    assert yardstick.fit_flops(fit) == pytest.approx(d2 + b2 + val + eigh
                                                     + test)


def test_kernel_bounds_by_hand():
    b = yardstick.kernel_bounds_s(FIT)
    fl, bw = 67e12, 3.35e12
    b1 = max(9 * 13 / fl, 4 * (5 * 5 + 13) / bw)
    b1 += max(14 * 13 / fl, 4 * ((7 + 3) * 5 + 14) / bw)
    assert b["B1"] == pytest.approx(b1)
    assert b["B2"] == pytest.approx(2 * max(3 * 13 / fl, 8 * 13 / bw)
                                    + max(3 * 14 / fl, 4 * 2 * 14 / bw))
    assert b["B4"] == pytest.approx(
        2 * max(2 * 2 * 3 * 13 / fl, 4 * (13 + 6 * 2 * 3 * 5) / bw))
    assert yardstick.kernel_bounds_s(dict(FIT, solver="ls"))["B4"] == 0.0


def _chrome(path):
    ev = [
        {"ph": "X", "cat": "cpu_op", "name": "aten::bmm", "tid": 1,
         "ts": 0, "dur": 10,
         "args": {"Input Dims": [[2, 4, 8], [2, 8, 3]],
                  "Input type": ["float", "float"]}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "tid": 1, "ts": 2, "dur": 1, "args": {"correlation": 7}},
        {"ph": "X", "cat": "kernel", "name": "sgemm_x", "tid": 9, "ts": 20,
         "dur": 30, "args": {"correlation": 7}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "tid": 1,
         "ts": 45, "dur": 40, "args": {}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "tid": 1, "ts": 46, "dur": 1, "args": {"correlation": 8}},
        {"ph": "X", "cat": "kernel", "name": "d2_tile_kernel<1>", "tid": 9,
         "ts": 40, "dur": 20, "args": {"correlation": 8}},
        {"ph": "X", "cat": "kernel", "name": "gram_from_d2_kernel", "tid": 9,
         "ts": 90, "dur": 10, "args": {"correlation": 9}},
        {"ph": "i", "cat": "marker", "name": "ignored", "ts": 5},
    ]
    path.write_text(json.dumps({"traceEvents": ev}))


def test_trace_reduction(tmp_path):
    p = tmp_path / "t.json"
    _chrome(p)
    t = trace.parse(str(p))
    assert t.window_s == pytest.approx(100e-6)
    # device busy 20..60 and 90..100
    assert t.busy_s == pytest.approx(50e-6)
    assert sum(t.gaps.values()) == pytest.approx(50e-6)
    assert t.gaps["aten::bmm"] == pytest.approx(20e-6)   # 0..20
    assert t.gaps["aten::add"] == pytest.approx(30e-6)   # 60..90
    (g,) = t.gemms
    assert (g.name, g.flops, g.dtype) == ("aten::bmm", 2 * 2 * 4 * 8 * 3,
                                          "float")
    assert g.nbytes == 4 * 2 * (32 + 24 + 12)
    assert g.device_s == pytest.approx(30e-6)
    assert [k[0] for k in t.kernels] == ["sgemm_x", "d2_tile_kernel<1>",
                                         "gram_from_d2_kernel"]
