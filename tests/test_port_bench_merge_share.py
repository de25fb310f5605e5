"""The benchmark's reader of the flash merge's share of device time
(``port_bench/metrics/flash_merge_share.attn.py``) on synthetic traces: the
merge's device time under the traced ``flash.call`` spans over all of theirs,
0 where no merge ran, and nothing where nothing was traced."""

import pytest

from port_bench import spec, trace
from port_bench.harness import Run

CARD = "NVIDIA H100 80GB HBM3"


def _x(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": args}


def _events(merges: bool):
    """Two flash calls in a window of 600 us, each launching the unit
    kernel (200 us) and, with ``merges``, the merge (50 and 40 us); a fill
    launched outside any call (60 us) counts for neither."""
    events = [
        _x("user_annotation", trace.WINDOW, 0, 600),
        _x("user_annotation", "flash.call", 10, 100),
        _x("user_annotation", "flash.call", 210, 100),
        _x("cuda_runtime", "cudaLaunchKernel", 60, 4, correlation=1),
        _x("cuda_runtime", "cudaLaunchKernel", 240, 10, correlation=3),
        _x("cuda_runtime", "cudaMemsetAsync", 150, 5, correlation=5),
        _x("kernel", "void flash_fwd_kernel<__nv_bfloat16, 128>(int)", 100,
           200, device=0, correlation=1),
        _x("kernel", "void flash_fwd_kernel<__nv_bfloat16, 128>(int)", 350,
           200, device=0, correlation=3),
        _x("gpu_memset", "Memset", 540, 60, device=0, correlation=5),
    ]
    if merges:
        events += [
            _x("cuda_runtime", "cudaLaunchKernel", 70, 3, correlation=2),
            _x("cuda_runtime", "cudaLaunchKernel", 260, 2, correlation=4),
            _x("kernel", "void flash::flash_combine_kernel<__nv_bfloat16>"
               "(int4 const*, float const*)", 300, 50, device=0,
               correlation=2),
            _x("kernel", "void flash::flash_combine_kernel<__nv_bfloat16>"
               "(int4 const*, float const*)", 550, 40, device=0,
               correlation=4),
        ]
    return events


def _read(events):
    here = spec.Pieces()
    config = here.config(here.benchmark(), "attn-probe-16k")
    run = Run("attn.causal-16k", config, {}, CARD, [0], 10.0, 2.0, 5, 0,
              {"flash.call": [2e-4]},
              None if events is None else trace.parse(events))
    return here.module("metrics", "flash_merge_share.attn").read(run)


@pytest.mark.parametrize("events,want", [
    (_events(True), 100.0 * (50 + 40) / (200 + 50 + 200 + 40)),
    (_events(False), 0.0),
    # traced, but no operation under a flash call
    ([_x("user_annotation", trace.WINDOW, 0, 600),
      _x("user_annotation", "flash.call", 10, 100)], None),
    (None, None)])
def test_merge_share_reads_the_merge_under_the_flash_calls(events, want):
    got = _read(events)
    assert got == (None if want is None else pytest.approx(want))


def test_merge_share_is_listed_for_the_attention_cell_alone():
    bench = spec.Pieces().benchmark()
    entry, = [m for m in bench["per_layer"]
              if m["name"] == "flash_merge_share.attn"]
    assert entry["workloads"] == ["attn.causal-16k"]
    assert (entry["source"], entry["moves"], entry["unit"]) == \
        ("device_trace", "attn_tflops", "%")
    for cell, listed in (("attn.causal-16k", True),
                         ("validate.default", False)):
        names = {m["name"] for m in spec.metrics(bench, cell, True)}
        assert ("flash_merge_share.attn" in names) is listed
