"""The per-layer readers on a recorded span list, counters and trace."""
from __future__ import annotations

import numpy as np
import pytest

from perfbench import harness, trace, yardstick


def span(name, dur_s, device_ms=None):
    return {"name": name, "dur_s": dur_s, "depth": 0, "device_ms": device_ms,
            "attrs": {}}


def fit(wall_s, spans, **kw):
    base = {"rows": 1000, "wall_s": wall_s, "peak_bytes": 2 * 10 ** 9,
            "spans": spans, "live": [3, 2], "held": [4, 1], "d": 5, "G": 2,
            "F": 2, "P": 3, "Pt": 1, "cd_polish": 1, "solver": "hinge",
            "iters": np.array([[[10, 3], [0, 21]], [[1, 1], [2, 2]]]),
            "slots_per_wave": 1}
    base.update(kw)
    return base


WAVE = [span("train.stage", 0.2, 150.0), span("train.d2", 0.01, 2.0),
        span("train.epilogue", 0.01, 1.0), span("train.fista", 0.5, 300.0),
        span("train.polish", 0.1, 40.0), span("train.select", 0.05, 7.0),
        span("train.wave", 1.0, 600.0)]


def ctx(profiled=(), tr=None):
    fits = [fit(3.0, WAVE), fit(5.0, WAVE + WAVE)]
    return harness.Context(fits=fits, profiled=list(profiled), trace=tr)


def read(name, c):
    return harness.load_metric(name).read(c)


def test_span_readers():
    c = ctx()
    # stage: (3 - 1 + 0.2) + (5 - 2 + 0.4), over two fits
    assert read("stage_s_per_fit", c) == pytest.approx((2.2 + 3.4) / 2)
    assert read("gram_ms_per_wave", c) == pytest.approx(3.0)
    assert read("select_ms_per_wave", c) == pytest.approx(7.0)
    assert read("solve_ms_per_wave", c) == pytest.approx(600 - 150 - 3 - 7)


def test_span_readers_leave_out_the_profiled_fit():
    c = ctx(profiled=[1])
    assert read("stage_s_per_fit", c) == pytest.approx(2.2)


def test_counter_readers():
    c = ctx()
    # one slot a wave: slot 0 trips 10 + 21, slot 1 1 + 2, for each fit
    assert read("fista_trips_per_wave", c) == pytest.approx((31 + 3) / 2)
    assert read("peak_mem_gb", c) == pytest.approx(2.0)
    flops = yardstick.fit_flops(c.fits[0]) * 2
    assert read("train_mfu", c) == pytest.approx(
        100 * flops / (8.0 * 67e12))
    ls = harness.Context(fits=[fit(1.0, [], solver="ls")], profiled=[],
                         trace=None)
    assert read("fista_trips_per_wave", ls) is None


def test_trace_readers_find_nothing_without_a_trace():
    c = ctx()
    for name in ("kernel_roofline", "gemm_roofline", "device_idle_share"):
        assert read(name, c) is None


def test_trace_readers():
    tr = trace.Trace(
        kernels=[("void d2_tile_kernel<1>", 0.0, 2e-6),
                 ("gram_from_d2_kernel<float>", 0.0, 1e-6),
                 ("cd_wave_epoch_kernel", 0.0, 1e-6),
                 ("sgemm_128x64", 0.0, 5e-6)],
        gemms=[trace.Gemm("aten::bmm", 67e6, 0.0, "float", 2e-6),
               trace.Gemm("aten::bmm", 67e6, 0.0, "double", 1.0)],
        busy_s=0.75, window_s=1.0, gaps={})
    c = ctx(profiled=[0, 1], tr=tr)
    bound = sum(yardstick.kernel_bounds_s(c.fits[0]).values())
    assert read("kernel_roofline", c) == pytest.approx(100 * bound / 4e-6)
    assert read("gemm_roofline", c) == pytest.approx(50.0)
    assert read("device_idle_share", c) == pytest.approx(25.0)


def test_breakdown():
    tr = trace.Trace(kernels=[("a", 0, 1.0), ("b", 0, 3.0), ("a", 1, 1.5)],
                     gemms=[], busy_s=5.5, window_s=6.0,
                     gaps={"aten::item": 0.25, "host (no op)": 0.5})
    b = harness.breakdown(tr)
    assert b["device_ops"] == [["b", 3.0], ["a", 2.5]]
    assert b["idle_gaps"] == [["host (no op)", 0.5], ["aten::item", 0.25]]
