"""Reading the device trace, on a synthetic Chrome trace (the CPU's
profiler records no device operations), and the readers built on it."""

import pytest

from port_bench import readers, spec, trace
from port_bench.harness import Run


def _x(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": args}


def _events():
    # a window of 100 us; two spans; the host launches two kernels in
    # "leg.a" (correlations 1, 2), a kernel and a copy in "leg.b" (3, 4);
    # device 0 runs 10-30 and 25-40 (overlapping) and 70-80; device 1
    # copies over 0-100 and fills at 95, launched by no call it recorded
    return [
        _x("user_annotation", trace.WINDOW, 0, 100),
        _x("user_annotation", "leg.a", 0, 50),
        _x("user_annotation", "leg.b", 50, 50),
        _x("cpu_op", "aten::mm", 2, 6),
        _x("cuda_runtime", "cudaLaunchKernel", 3, 1, correlation=1),
        _x("cuda_runtime", "cudaLaunchKernel", 5, 1, correlation=2),
        _x("cuda_runtime", "cudaStreamSynchronize", 41, 20),
        _x("cuda_runtime", "cudaLaunchKernel", 62, 1, correlation=3),
        _x("kernel", "k1(int)", 10, 20, device=0, correlation=1),
        _x("kernel", "k2(int)", 25, 15, device=0, correlation=2),
        _x("kernel", "k1(int)", 70, 10, device=0, correlation=3),
        _x("cuda_runtime", "cudaMemcpyAsync", 64, 1, correlation=4),
        _x("gpu_memcpy", "Memcpy DtoD", 0, 100, device=1, correlation=4),
        _x("gpu_memset", "Memset", 95, 1, device=1),
        {"ph": "s", "cat": "ac2g", "ts": 3},
    ]


def test_busy_time_merges_overlaps_and_keeps_to_the_window():
    t = trace.parse(_events())
    assert t.window == (0, 100) and t.window_s == pytest.approx(1e-4)
    assert t.busy_intervals(0) == [(10, 40), (70, 80)]
    assert t.busy_s(0) == pytest.approx(40e-6)
    assert t.busy_mean_s([0, 1]) == pytest.approx(70e-6)


def test_ops_belong_to_the_span_that_launched_them():
    t = trace.parse(_events())
    assert sorted(op.name for op in t.under("leg.a")) == ["k1(int)",
                                                          "k2(int)"]
    assert sorted(op.start for op in t.under("leg.b")) == [0, 70, 95]
    assert t.count("leg.a") == 1 and t.count("leg.c") == 0


def test_breakdown_sums_ops_by_name_and_gaps_by_host_activity():
    t = trace.parse(_events())
    ops = dict(t.device_ops())
    assert ops["k1(int)"] == pytest.approx(30e-6)
    assert ops["Memcpy DtoD"] == pytest.approx(100e-6)
    gaps = dict(t.idle_gaps([0]))
    # by the middle of each gap: 0-10 in leg.a's launch, 40-70 in the
    # sync inside leg.b, 80-100 in leg.b with no host op
    assert gaps["leg.a / cudaLaunchKernel"] == pytest.approx(10e-6)
    assert gaps["leg.b / cudaStreamSynchronize"] == pytest.approx(30e-6)
    assert gaps["leg.b / no host op"] == pytest.approx(20e-6)
    assert sum(gaps.values()) == pytest.approx(60e-6)


def test_readers_on_a_trace():
    t = trace.parse(_events())
    here = spec.Pieces()
    config = here.config(here.benchmark(), "validator-1gpu")
    run = Run("c", config, {}, "NVIDIA H100 80GB HBM3", [0], 1.0, 1.0, 1,
              0, {}, t)
    idle = here.module("metrics", "device_idle.validate").read(run)
    assert idle == pytest.approx(60.0)
    # 35 us of work at the peak over 35 us of device time under leg.a
    share = readers.roofline_percent(run, "leg.a", 3.35e12 * 35e-6,
                                     "hbm_bytes")
    assert share == pytest.approx(100.0)
    assert here.module("metrics", "hbm_roofline.validate").read(run) is None
    unknown = Run("c", {}, {}, "some card", [0], 1.0, 1.0, 1, 0, {}, t)
    assert readers.roofline_percent(unknown, "leg.a", 1.0, "hbm_bytes") \
        is None
    untraced = Run("c", {}, {}, "NVIDIA H100 80GB HBM3", [0], 1.0, 1.0, 1,
                   0, {})
    assert readers.idle_percent(untraced) is None
