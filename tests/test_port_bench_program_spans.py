"""The benchmark's readers of the program's own spans, on synthetic traces.

In a traced run the program's span sites are profiler annotations beside
the benchmark's own (``port_bench/program_spans.py``). Adding them to a
trace moves no reader the benchmark had before them; the six readers of
the program's spans return the means worked out here; and the program's
span names never meet the benchmark's annotation names.
"""

import re

import pytest
import torch

from port_bench import program_spans, spec, trace
from port_bench.harness import Run
from tpu_operator_torch.health import probes
from tpu_operator_torch.ops.flash_attention import flash_attention
from tpu_operator_torch.utils import trace as port_trace
from tpu_operator_torch.validator.components import WorkloadComponent

CARD = "NVIDIA H100 80GB HBM3"
#: the benchmark's own annotations, which no program span may share
BENCHMARK_SPANS = {trace.WINDOW, "validation", "leg.matmul", "leg.hbm",
                   "leg.flash", "flash.call"}
NEW = {"flash_prepare_us.attn", "flash_schedule_us.attn",
       "flash_launch_us.attn", "flash_launch_wait_us.attn",
       "probe_untimed_ms.validate", "validate_self_ms.validate"}
CELLS = {"validate.default": "validator-1gpu",
         "attn.causal-16k": "attn-probe-16k"}


def _x(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": args}


def _validate_events():
    """One validation in a window of 1000 us: the benchmark's spans, the
    legs' launches and kernels."""
    return [
        _x("user_annotation", trace.WINDOW, 0, 1000),
        _x("user_annotation", "validation", 0, 1000),
        _x("user_annotation", "leg.matmul", 10, 290),
        _x("user_annotation", "leg.hbm", 310, 490),
        _x("user_annotation", "leg.flash", 810, 90),
        _x("cuda_runtime", "cudaLaunchKernel", 20, 1, correlation=1),
        _x("cuda_runtime", "cudaLaunchKernel", 320, 1, correlation=2),
        _x("cuda_runtime", "cudaLaunchKernel", 820, 1, correlation=3),
        _x("cuda_runtime", "cudaStreamSynchronize", 330, 460),
        _x("kernel", "nvjet_tst(int)", 30, 260, device=0, correlation=1),
        _x("kernel", "read_sweeps(int)", 330, 460, device=0,
           correlation=2),
        _x("kernel", "flash_fwd_kernel(int)", 830, 50, device=0,
           correlation=3),
    ]


def _validate_program():
    """The program's spans in that validation: 998 us in all, legs of
    300, 499 and 99 us, 79 + 81 us untimed."""
    return [_x("user_annotation", name, ts, dur) for name, ts, dur in [
        ("validator.validate", 1, 998),
        ("validator.matmul", 5, 300), ("matmul.inputs", 12, 8),
        ("matmul.warmup", 21, 79), ("matmul.timed", 100, 190),
        ("validator.hbm", 306, 499), ("hbm.alloc", 312, 6),
        ("hbm.gate", 319, 81), ("hbm.timed", 400, 390),
        ("validator.flash", 806, 99), ("flash_op.call", 815, 15),
        ("validator.flash_reference", 885, 14),
        ("validator.runtime_build", 910, 80)]]


def _attn_events():
    """Two flash calls in a window of 600 us, each launching two kernels,
    and a launch outside any call."""
    return [
        _x("user_annotation", trace.WINDOW, 0, 600),
        _x("user_annotation", "flash.call", 10, 100),
        _x("user_annotation", "flash.call", 210, 100),
        _x("cuda_runtime", "cudaFuncSetAttribute", 55, 2),
        _x("cuda_runtime", "cudaLaunchKernel", 60, 4, correlation=1),
        _x("cuda_runtime", "cudaLaunchKernel", 70, 3, correlation=2),
        _x("cuda_runtime", "cudaLaunchKernel", 240, 10, correlation=3),
        _x("cuda_runtime", "cudaLaunchKernelExC", 260, 2, correlation=4),
        _x("cuda_runtime", "cudaLaunchKernel", 150, 5, correlation=5),
        _x("kernel", "flash_fwd_kernel(int)", 100, 200, device=0,
           correlation=1),
        _x("kernel", "flash_combine_kernel(int)", 300, 50, device=0,
           correlation=2),
        _x("kernel", "flash_fwd_kernel(int)", 350, 200, device=0,
           correlation=3),
        _x("kernel", "flash_combine_kernel(int)", 550, 40, device=0,
           correlation=4),
        _x("gpu_memset", "Memset", 595, 1, device=0, correlation=5),
    ]


def _attn_program():
    """Prepare 18 and 10 us, schedule 20 and 10, launch 55 and 68; inside
    the launches the launch calls take 4 + 3 and 10 + 2 us."""
    return [_x("user_annotation", name, ts, dur) for name, ts, dur in [
        ("flash_op.call", 12, 96), ("flash_op.prepare", 12, 18),
        ("flash_op.schedule", 30, 20), ("flash_op.launch", 50, 55),
        ("flash_op.call", 212, 96), ("flash_op.prepare", 212, 10),
        ("flash_op.schedule", 222, 10), ("flash_op.launch", 232, 68)]]


EVENTS = {"validate.default": (_validate_events, _validate_program),
          "attn.causal-16k": (_attn_events, _attn_program)}


def _run(cell, events):
    here = spec.Pieces()
    config = here.config(here.benchmark(), CELLS[cell])
    return Run(cell, config, {}, CARD, [0], 10.0, 2.0, 5, 0,
               {"program.leg.hbm": [1.9], "program.leg.matmul": [0.26],
                "program.leg.flash": [0.002], "flash.call": [2e-4]},
               trace.parse(events))


def _metrics(cell):
    bench = spec.Pieces().benchmark()
    return [m["name"] for m in bench["end_to_end"] + bench["per_layer"]
            if cell in m.get("workloads", [cell])]


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_program_spans_move_no_reader_the_benchmark_had(cell):
    bench_only, program = EVENTS[cell]
    here = spec.Pieces()
    without = _run(cell, bench_only())
    with_program = _run(cell, bench_only() + program())
    old = [name for name in _metrics(cell) if name not in NEW]
    assert len(old) >= 4
    for name in old:
        reader = here.module("metrics", name)
        assert reader.read(with_program) == reader.read(without), name
    # the new readers find nothing where the program made no spans
    for name in set(_metrics(cell)) & NEW:
        assert here.module("metrics", name).read(without) is None, name
    # and idle gaps are now named by the program's spans too
    gaps = dict(with_program.trace.idle_gaps([0]))
    assert any(g.startswith(("validator.", "hbm.", "matmul.", "flash_op."))
               for g in gaps)


@pytest.mark.parametrize("name,want", [
    ("flash_prepare_us.attn", 14.0), ("flash_schedule_us.attn", 15.0),
    ("flash_launch_us.attn", 61.5), ("flash_launch_wait_us.attn", 9.5)])
def test_flash_step_readers(name, want):
    run = _run("attn.causal-16k", _attn_events() + _attn_program())
    assert spec.Pieces().module("metrics", name).read(run) == \
        pytest.approx(want)


def test_the_flash_steps_and_the_call_self_time_add_up_to_the_call():
    run = _run("attn.causal-16k", _attn_events() + _attn_program())
    here = spec.Pieces()
    steps = sum(here.module("metrics", f"flash_{s}_us.attn").read(run)
                for s in ("prepare", "schedule", "launch"))
    call = program_spans.mean_us(run, "flash_op.call")
    # the calls' self time: 96 - 93 and 96 - 88 us
    assert steps <= call and call - steps == pytest.approx(5.5)


@pytest.mark.parametrize("name,want", [
    ("probe_untimed_ms.validate", (79 + 81) / 1e3),
    ("validate_self_ms.validate", (998 - 300 - 499 - 99) / 1e3)])
def test_validator_readers(name, want):
    run = _run("validate.default", _validate_events() + _validate_program())
    assert spec.Pieces().module("metrics", name).read(run) == \
        pytest.approx(want)


def test_untimed_runs_count_inside_validations_only():
    """Two validations, 160 and 40 us untimed, and a gated run outside
    either: 100 us a validation."""
    second = [_x("user_annotation", name, ts, dur) for name, ts, dur in [
        ("validator.validate", 1000, 500), ("hbm.gate", 1100, 30),
        ("matmul.warmup", 1200, 10), ("hbm.gate", 1600, 50)]]
    run = _run("validate.default",
               _validate_events() + _validate_program() + second)
    reader = spec.Pieces().module("metrics", "probe_untimed_ms.validate")
    assert reader.read(run) == pytest.approx((160 + 40) / 2 / 1e3)


def test_readers_without_a_trace_read_nothing():
    untraced = Run("c", {}, {}, CARD, [0], 1.0, 1.0, 1, 0, {})
    for name in NEW:
        assert spec.Pieces().module("metrics", name).read(untraced) is None


def _benchmark_annotations():
    """The annotation names the benchmark's own code makes: its trace
    window and every literal it hands to a span."""
    root = spec.ROOT / "port_bench"
    names = {trace.WINDOW}
    for path in [root / "harness.py", *sorted((root / "entries").glob(
            "*.py"))]:
        names |= set(re.findall(r'(?:span|leg)\("([^"]+)"\)',
                                path.read_text()))
    return names


def _program_span_names(tmp_path, monkeypatch):
    """Every span name the program makes on the CPU (a validation over two
    virtual ranks, a health sweep, a flash call), and the flash op's steps
    on the card."""
    monkeypatch.delenv("REQUIRE_GPU_PLATFORM", raising=False)
    tracer = port_trace.Tracer()
    with tracer.start_trace("root"):
        WorkloadComponent(validations_dir=str(tmp_path), device="cpu",
                          require_gpu=False, ranks=2,
                          collective_mb=1).validate()
        probes.HbmSweepProbe(size_mb=1, device="cpu").run()
        q = torch.randn(64, 32)
        flash_attention(q, q, q)
    names = {s.name for t in tracer.traces() for s in t} - {"root"}
    return names | {"flash_op.prepare", "flash_op.schedule",
                    "flash_op.launch"}


def test_program_span_names_are_disjoint_from_the_benchmarks(tmp_path,
                                                            monkeypatch):
    ours = _benchmark_annotations()
    assert ours == BENCHMARK_SPANS
    program = _program_span_names(tmp_path, monkeypatch)
    assert {"validator.validate", "hbm.timed", "matmul.timed",
            "flash_op.call"} <= program
    assert program.isdisjoint(ours)
    assert set(program_spans.VALIDATOR_LEGS) <= program
