"""The port's bench, ``tpu_operator_torch/bench.py``, against the root
``bench.py``: the reference's contract tests (``tests/test_bench.py``) on
the port's functions, each line built by both copies from the same report
(no harness runs), and the one JSON line. CPU only; the whole bench runs
on the card in ``chip_smoke.py``'s bench path."""

import ast
import copy
import importlib
import json
import os
import threading
import time
import unittest.mock as mock

import pytest
import torch

import bench as ref_bench
from torch_names import BENCH_METRIC_NAMES
from tpu_operator_torch import bench
from tpu_operator_torch.ops.matmul import PEAK_BF16

H100 = "NVIDIA H100 80GB HBM3"


def _smoke_patches(nodes=(), selftest=True):
    return (mock.patch.object(bench, "_find_or_build_smoke",
                              return_value="/bin/true"),
            mock.patch.object(bench, "_find_libcuda", return_value="/x.so"),
            mock.patch.object(bench, "_local_device_nodes",
                              return_value=list(nodes)),
            mock.patch.object(bench, "_binary_selftest",
                              return_value=selftest))


def _smoke_with(rep, nodes=(), selftest=True):
    a, b, c, d = _smoke_patches(nodes, selftest)
    with a, b, c, d, mock.patch.object(bench.subprocess, "run") as run:
        run.return_value = mock.Mock(stdout=json.dumps(rep))
        return bench._bench_smoke()


# -- the reference's contract tests, on the port --------------------------

def test_smoke_scoring_matrix():
    """1.0 = the add ran on a card; 0.5 = the driver answered and counted
    no device, and the control run found no card node; 0.0 = the driver
    never answered, it counted devices and the add failed, or card nodes
    exist where it counted none."""
    cases = [({"ok": False, "devices": 2, "cuda_driver_version": "12.8"},
              [], 0.0),
             ({"ok": False, "devices": 0, "cuda_driver_version": "12.8"},
              [], 0.5),
             ({"ok": False, "devices": 0, "cuda_driver_version": "12.8"},
              ["/dev/nvidia0"], 0.0),
             ({"ok": False, "devices": 0, "cuda_driver_version": "0.0"},
              [], 0.0),
             ({"ok": True, "devices": 1, "cuda_driver_version": "12.8"},
              [], 1.0)]
    for rep, nodes, want in cases:
        got = _smoke_with(rep, nodes)
        assert got["value"] == want, (rep, nodes, got)
        assert got["vs_baseline"] == want
    assert got["detail"]["transport"] == "libcuda-local"


def test_smoke_broken_binary_downgrades_half_score():
    """0.5 needs the binary to pass its self-test against the fake
    libcuda: a binary that cannot run the add through a healthy driver is
    broken, not a host without a card."""
    rep = {"ok": False, "devices": 0, "cuda_driver_version": "12.8"}
    got = _smoke_with(rep, selftest=False)
    assert got["value"] == 0.0
    assert got["detail"]["binary_selftest"] is False
    # no signal (no fake built): the benefit of the doubt stays 0.5
    assert _smoke_with(rep, selftest=None)["value"] == 0.5


def test_audit_flags_unmatched_and_above_peak():
    ok = bench._audit(H100, 989.0, PEAK_BF16, value=700.0)
    assert ok == {"device_kind": H100, "peak": 989.0,
                  "peak_matched": True, "suspect": False}
    unknown = bench._audit("NVIDIA X999", 989.0, PEAK_BF16, value=700.0)
    assert unknown["peak_matched"] is False and unknown["suspect"] is True
    above = bench._audit(H100, 989.0, PEAK_BF16, value=1040.0)
    assert above["peak_matched"] is True and above["suspect"] is True


def test_smoke_missing_binary_degrades():
    with mock.patch.object(bench, "_find_or_build_smoke", return_value=None):
        got = bench._bench_smoke()
    assert got["value"] == 0.0 and "detail" in got


def test_audit_env_override_counts_as_matched(monkeypatch):
    """A policy-supplied denominator (PEAK_TFLOPS) is deliberate, not a
    guess: an unknown card is then not suspect."""
    monkeypatch.setenv("PEAK_TFLOPS", "300")
    got = bench._audit("NVIDIA X999", 300.0, PEAK_BF16, value=290.0,
                       override_env="PEAK_TFLOPS")
    assert got["peak_matched"] is True and got["suspect"] is False
    monkeypatch.delenv("PEAK_TFLOPS")
    got = bench._audit("NVIDIA X999", 989.0, PEAK_BF16, value=700.0,
                       override_env="PEAK_TFLOPS")
    assert got["suspect"] is True


def test_binary_selftest_no_signal_cases(tmp_path):
    """An environmental failure is no signal (None), never a broken
    binary: no fake libcuda beside the binary, a crashed or timed-out
    process, or a fake that did not load (the driver never answered)."""
    smoke = str(tmp_path / "gpu-smoke")
    assert bench._binary_selftest(smoke) is None          # no fake
    (tmp_path / "libfake-cuda.so").touch()
    for rep, want in (((None, "TimeoutExpired: 60s"), None),
                      (({"ok": False, "cuda_driver_version": "0.0"}, None),
                       None),
                      (({"ok": False, "cuda_driver_version": "12.8"}, None),
                       False),
                      (({"ok": True, "cuda_driver_version": "12.8"}, None),
                       True)):
        with mock.patch.object(bench, "_run_smoke", return_value=rep):
            assert bench._binary_selftest(smoke) is want, rep


def test_smoke_run_failure_reason_reaches_detail():
    with mock.patch.object(bench, "_find_or_build_smoke",
                           return_value="/bin/true"), \
         mock.patch.object(bench, "_find_libcuda", return_value="/x.so"), \
         mock.patch.object(bench, "_run_smoke",
                           return_value=(None, "TimeoutExpired: 120s")):
        got = bench._bench_smoke()
    assert got["value"] == 0.0
    assert "TimeoutExpired" in got["detail"]


def test_wedged_device_emits_honest_line(capsys):
    """A device whose every touch hangs gives ONE honest JSON line."""
    with mock.patch.object(bench, "_bench_smoke", return_value={
            "metric": "gpu_smoke_cuda", "value": 0.5, "unit": "ok",
            "vs_baseline": 0.5}), \
         mock.patch.object(bench, "_init_device", return_value=(
             None, "probe timed out after 180s (wedged driver or card)")):
        assert bench.main([]) == 0
    lines = [l for l in capsys.readouterr().out.splitlines() if l.strip()]
    assert len(lines) == 1
    d = json.loads(lines[0])
    assert d["value"] == 0.0 and "unreachable" in d["detail"]
    assert "wedged driver" in d["detail"]
    assert d["extra"][0]["metric"] == "gpu_smoke_cuda"


def test_run_smoke_crash_is_not_an_empty_report():
    rep, err = bench._run_smoke("/bin/false", "/x.so", n=4, timeout=5)
    assert rep is None and "exit 1" in err
    rep, err = bench._run_smoke("/bin/sh", "-c", n=4, timeout=5)  # junk argv
    assert rep is None


def test_init_device_fast_failure_reports_cause(monkeypatch):
    """Without a card the probe fails at once with its cause, not after the
    watchdog's wait with a wedge diagnosis."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    t0 = time.monotonic()
    dev, err = bench._init_device("cuda", timeout_s=30)
    assert dev is None
    assert "no CUDA device is available" in err
    assert time.monotonic() - t0 < 10


def test_init_device_watchdog_reports_a_wedge(monkeypatch):
    """A probe that never returns is reported after ``timeout_s``."""
    from tpu_operator_torch.utils import device
    hang = threading.Event()
    monkeypatch.setattr(device, "resolve_device", lambda d: hang.wait(30))
    try:
        dev, err = bench._init_device("cuda", timeout_s=1.0)
    finally:
        hang.set()
    assert dev is None and "timed out after 1s" in err


def test_bench_emits_one_json_line_with_extras(monkeypatch, capsys):
    """``main(["--device", "cpu"])`` with the harnesses stubbed: exactly
    one stdout line, the reference's shape, every device line under its
    ``gpu_`` name, the harness lines under the reference's names."""
    for case in HARNESSES:
        monkeypatch.setattr(importlib.import_module(
            f"tpu_operator_torch.e2e.{case.module}"), case.measure,
            lambda *a, _rep=case.report, **kw: copy.deepcopy(_rep))
    assert bench.main(["--device", "cpu"]) == 0
    lines = [l for l in capsys.readouterr().out.splitlines() if l.strip()]
    assert len(lines) == 1, lines
    d = json.loads(lines[0])
    assert list(d)[:4] == ["metric", "value", "unit", "vs_baseline"]
    assert d["metric"] == BENCH_METRIC_NAMES["validator_burnin_matmul_bf16"]
    for e in d["extra"]:
        assert list(e)[:4] == ["metric", "value", "unit", "vs_baseline"]
        assert e["metric"] != "probe_error", e
    metrics = [d["metric"]] + [e["metric"] for e in d["extra"]]
    assert set(BENCH_METRIC_NAMES.values()) <= set(metrics)
    assert metrics[5:] == [metric for _, metric, *_ in bench.HARNESS_LINES]
    assert not any("tpu" in m or "ici" in m for m in metrics)
    flash = d["extra"][1]
    assert flash["detail"]["sdpa_backend"] == "MATH"
    assert flash["detail"]["seq_len"] == 512


# -- what the port adds -----------------------------------------------------

@pytest.mark.parametrize("env, want", [({}, 1.0),
                                       ({"FAKE_CUDA_FAIL": "cuInit"}, 0.0)],
                         ids=["healthy", "cuInit-fails"])
def test_smoke_scores_through_the_real_binary(monkeypatch, env, want):
    """``gpu-smoke`` as built from the checkout, against the compiled fake
    ``libcuda.so.1``: 1.0 over ``libcuda-local``; 0.0 when ``cuInit``
    fails."""
    from tpu_operator_torch.native import build
    fake = str(build.build() / "libfake-cuda.so")
    monkeypatch.setattr(bench, "_find_libcuda", lambda: fake)
    monkeypatch.setattr(bench, "_local_device_nodes", lambda: [])
    monkeypatch.delenv("GPU_SMOKE_BIN", raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    got = bench._bench_smoke()
    assert got["value"] == got["vs_baseline"] == want, got
    if want == 1.0:
        assert got["detail"]["transport"] == "libcuda-local"
        assert got["detail"]["ok"] is True
    else:
        assert got["detail"]["error"] == "cuInit"


def test_main_without_a_card_runs_nothing(monkeypatch, capsys):
    """``main([])`` without CUDA: the honest unreachable line, and no
    probe or harness runs on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(bench, "_bench_smoke", lambda: {
        "metric": "gpu_smoke_cuda", "value": 0.0, "unit": "ok",
        "vs_baseline": 0.0})

    def ran(*a, **kw):
        raise AssertionError("ran without a card")
    for name in ("_bench_matmul", "_bench_hbm", "_bench_flash",
                 "_bench_collectives"):
        monkeypatch.setattr(bench, name, ran)
    monkeypatch.setattr(bench, "HARNESS_LINES", tuple(
        (ran, *rest) for _, *rest in bench.HARNESS_LINES))
    assert bench.main([]) == 0
    lines = [l for l in capsys.readouterr().out.splitlines() if l.strip()]
    assert len(lines) == 1
    d = json.loads(lines[0])
    assert d["metric"] == "gpu_validator_burnin_matmul_bf16"
    assert d["value"] == 0.0 and "device unreachable" in d["detail"]
    assert "no CUDA device is available" in d["detail"]
    assert [e["metric"] for e in d["extra"]] == ["gpu_smoke_cuda"]


def test_crash_lines_are_the_references():
    """A crashed harness gives the reference's line: each try block of the
    root ``bench.py``'s ``main`` (read from its source) names the same
    function, metric, value, unit and crash text, in the same order."""
    with open(ref_bench.__file__) as f:
        tree = ast.parse(f.read())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    ref = []
    for node in main.body:
        if not (isinstance(node, ast.Try)
                and isinstance(node.body[0], ast.Expr)
                and isinstance(node.body[0].value, ast.Call)):
            continue
        call = node.body[0].value.args[0]
        if not isinstance(call, ast.Call) or call.func.id == "_bench_smoke":
            continue
        line = node.handlers[0].body[0].value.args[0]
        fields = {k.value: v for k, v in zip(line.keys, line.values)}
        ref.append((call.func.id, fields["metric"].value,
                    fields["unit"].value, fields["value"].value,
                    fields["detail"].values[0].value))
    port = [(fn.__name__, metric, unit, value, f"{label} crashed: ")
            for fn, metric, unit, value, label in bench.HARNESS_LINES]
    assert port == ref and len(ref) == 17


def test_f13_reads_the_same_on_both_copies_at_the_bench_arguments():
    """The tier harness at the bench's arguments (its defaults): under the
    port's kind table the reference reports the same scaling problem the
    port does, 2.66x (``chip_smoke.py``'s ``BENCH_TIER_FAULT``)."""
    from torch_relay import same_kinds
    from tpu_operator.e2e.relay_tier import measure_relay_tier as ref
    from tpu_operator_torch.e2e.relay_tier import measure_relay_tier as port
    with same_kinds():
        want = ref()
    got = port()
    fault = ["4-replica aggregate rps only 2.66x single-replica (< 3x)"]
    assert got["problems"] == want["problems"] == fault
    assert got["scaling"]["speedup_4x"] == want["scaling"]["speedup_4x"]


# -- each line on both copies, from the same report -------------------------

class Harness:
    def __init__(self, fn, module, measure, report):
        self.fn, self.module, self.measure = fn, module, measure
        self.report = report

    def __repr__(self):
        return self.fn


HARNESSES = [
    Harness("_bench_time_to_ready", "time_to_ready", "measure_time_to_ready",
            {"time_to_ready_s": 0.4315, "ok": True, "budget_s": 300.0,
             "passes": 4, "per_state_s": {"state-driver": 0.0123,
                                          "state-validator": 0.2},
             "serial_sum_s": 1.25, "dag_wall_s": 0.5, "concurrency": 4,
             "cache_hit_ratio": 0.97, "converged": True,
             "latency": {"p50_s": 0.01}, "trace": {"spans": 40,
                                                  "orphans": 0},
             "error": "late state"}),
    Harness("_bench_chaos", "chaos_convergence", "measure_chaos_convergence",
            {"wall_s": 1.0047, "converged": True, "unhandled_exceptions": 0,
             "fault_rate": 0.3, "seed": 7, "passes": 12,
             "degraded_passes": 3, "retries_total": 9,
             "circuit_open_total": 1, "faults_injected": 22}),
    Harness("_bench_steady", "steady_state", "measure_steady_state",
            {"ok": True, "converged_pass_cpu_s": 0.0032,
             "cpu_speedup_vs_uncached": 6.5, "passes": 20, "nodes": 64,
             "converged_pass_wall_s": 0.0041,
             "desired_cache_hit_ratio": 1.0, "api_writes_per_pass": 0,
             "api_reads_per_pass": 0, "noop_fastpath_passes": 20,
             "object_cache_hit_ratio": 1.0, "connections": 1,
             "uncached": {"converged_pass_cpu_s": 0.0208},
             "error": "none"}),
    Harness("_bench_mttr", "mttr", "measure_mttr",
            {"ok": True, "seed": 3, "nodes": 6, "bad_nodes": 2,
             "flappy_nodes": 1, "budget": 1, "quarantined": 2,
             "false_quarantines": 0, "max_quarantined": 1,
             "budget_deferrals": 1, "validator_gate_respected": True,
             "time_to_quarantine_s": {"p50": 12.0, "max": 20.0},
             "time_to_recover_s": {"p50": 354.0, "max": 420.0}}),
    Harness("_bench_fleet", "fleet_scale", "measure_fleet_scale",
            {"ok": False, "problems": ["sharded walk speedup at 5000 nodes "
                                       "is 2.92x, acceptance bar is 3.0x"],
             "seed": 11, "rtt_s": 0.0005, "walk_speedup_5k": 2.92,
             "sizes": {str(n): {
                 "serial": {"first_walk_s": 0.1 * n / 1000},
                 "sharded": {"first_walk_s": 0.034 * n / 1000,
                             "shards": 8, "steady_api_rw": 0,
                             "steady_pass_s": 0.002},
                 "walk_speedup": 2.94} for n in (1000, 5000, 10000)},
             "churn": {"fleet": 10000}, "failover": {"duplicates": 0}}),
    Harness("_bench_relay", "relay_serving", "measure_relay_serving",
            {"ok": True, "problems": [], "seed": 1,
             "throughput": {"pooled_rps": 3703.6, "speedup": 22.59,
                            "baseline_rps": 164.0,
                            "pool_reuse_ratio": 0.99},
             "latency": {"overhead_p99_s": 0.0004, "relay_p99_s": 0.003},
             "chaos": {"lost": 0}, "fairness": {"floor": 0.9}}),
    Harness("_bench_serving_slo", "serving_slo", "measure_serving_slo",
            {"ok": True, "problems": [], "seed": 1,
             "p99": {"continuous": {"p99_s": 0.002493},
                     "window": {"p99_s": 0.0156}, "p99_speedup": 6.27,
                     "offered_rps": 500.0},
             "warm_start": {"speedup": 9.1}, "slo": {"silent_misses": 0},
             "bucketing": {"compile_reduction": 4.0}}),
    Harness("_bench_request_trace", "request_trace", "measure_request_trace",
            {"ok": True, "problems": [], "seed": 1,
             "overhead": {"p99_ratio": 1.0, "traced": {"p99_s": 0.0025},
                          "untraced": {"p99_s": 0.0025},
                          "wall_ratio": 1.01},
             "attribution": {"sheds": 40, "retained_sheds": 40,
                             "sum_violations": 0,
                             "dominant_phases": {"queue": 30}},
             "replay": {"attributed": True}}),
    Harness("_bench_relay_tier", "relay_tier", "measure_relay_tier",
            {"ok": False, "problems": ["4-replica aggregate rps only 2.66x "
                                       "single-replica (< 3x)"], "seed": 2,
             "scaling": {"by_replicas": {"1": {"aggregate_rps": 702.7},
                                         "4": {"aggregate_rps": 1869.1}},
                         "speedup_4x": 2.66, "speedup_8x": 4.1},
             "affinity": {"compiles": 64},
             "autoscaler": {"steps": 3, "timeline": [1, 2, 4]},
             "kill": {"duplicated": 0}}),
    Harness("_bench_relay_mem", "relay_mem", "measure_relay_mem",
            {"ok": True, "problems": [], "seed": 1,
             "steady_state": {"allocs_per_request": 0.0, "warmup_allocs": 64,
                              "steady_requests": 600, "reuses": 600,
                              "high_water_bytes": 1 << 20},
             "p99_ab": {"p99_speedup": 5.41, "copying": {"p99_s": 0.0108},
                        "donated": {"p99_s": 0.002}},
             "torn_stream": {"double_releases": 0}}),
    Harness("_bench_relay_qos", "relay_qos", "measure_relay_qos",
            {"ok": True, "problems": [], "seed": 1,
             "contention": {"qos_p99_s": 0.0022, "classless_p99_s": 0.0097,
                            "uncontended_p99_s": 0.0019,
                            "qos_vs_uncontended": 1.16,
                            "classless_vs_uncontended": 5.1},
             "shed_order": {"guaranteed_sheds": 0},
             "starvation": {"schedules": 100}, "attainment": {"ok": True}}),
    Harness("_bench_pump_speed", "pump_speed", "measure_pump_speed",
            {"ok": True, "problems": [], "seed": 42,
             "throughput": {"vector_rps": 200110.5, "speedup": 7.27,
                            "scalar_rps": 27525.5, "backlog_depth": 2048},
             "identity": {"identical": True}, "alloc": {"blocks": 0}}),
    Harness("_bench_relay_utilization", "utilization", "measure_utilization",
            {"ok": True, "problems": [], "seed": 1,
             "burn_rate": {"baseline_fraction": 0.5183,
                           "healthy_ratio": 0.887, "degraded_events": 1,
                           "degraded_cause": "idle_backlogged"},
             "isolation": {"requests": 400, "clean": {"busy": 0.5},
                           "variants": {"slow_pump": {}, "cold": {}}},
             "conservation": {"max_residue": 0.0},
             "overhead": {"p99_ratio": 1.01}}),
    Harness("_bench_relay_federation", "federation", "measure_federation",
            {"ok": True, "problems": [], "seed": 1,
             "kill": {"queued_on_victim": 18, "resubmitted": 18,
                      "missing": 0, "duplicated": 0, "p99_spike": 2.1,
                      "extra": 1},
             "scaling": {"by_cells": {"1": {"aggregate_rps": 1100.0},
                                      "4": {"aggregate_rps": 4197.9}},
                         "speedup_2x": 1.9, "speedup_4x": 3.8,
                         "drain": {"lost": 0}},
             "warm_cache": {"cold_compile_reduction": 3.0,
                            "replication_on": {"replicated_entries": 12}}}),
    Harness("_bench_relay_spmd", "spmd", "measure_spmd",
            {"ok": True, "problems": [],
             "plan_sweep": {"plans": {"1x1": {"rps": 8650.0},
                                      "2x4": {"rps": 35540.2}},
                            "best_plan": "2x4",
                            "speedup_best_vs_1x1": 4.11,
                            "steady_state": {"gather_copies": 0}},
             "reshard_chaos": {"lost": 0}}),
    Harness("_bench_relay_sessions", "sessions", "measure_sessions",
            {"ok": True, "problems": [],
             "capacity": {"sessions_at_slo": 32, "curve": [[8, 1.0]],
                          "slo_s": 0.05},
             "qos_split": {"improvement": 2.29},
             "steady_state": {"allocs_per_step": 0},
             "kill_migration": {"lost": 0}}),
    Harness("_bench_goodput", "goodput", "measure_goodput",
            {"ok": True, "problems": [], "seed": 5, "fleet_score": 1.0,
             "pacing_vs_static_delta": 0.0322, "availability": 1.0,
             "efficiency": 0.99, "overhead": 0.0,
             "sizes": {"100": {"steady_api_rw": 0},
                       "1000": {"steady_api_rw": 0}},
             "degradation": {"visible_within": 1},
             "chaos": {"pacing": {"goodput": 0.97},
                       "static": {"goodput": 0.94}}}),
]


def _line(copy_, harness, report, monkeypatch):
    """``harness``'s line as ``copy_`` (the reference's or the port's)
    builds it from ``report``, and the arguments it measured with."""
    package = "tpu_operator" if copy_ is ref_bench else "tpu_operator_torch"
    calls = []

    def measure(*args, **kwargs):
        calls.append((args, kwargs))
        return copy.deepcopy(report)
    with monkeypatch.context() as m:
        m.setattr(importlib.import_module(
            f"{package}.e2e.{harness.module}"), harness.measure, measure)
        try:
            return getattr(copy_, harness.fn)(), calls
        except Exception as e:
            return type(e), calls


def _dropped(report):
    """``report`` without each of its keys in turn, down to the second
    level: the reports a harness may give where the line reads
    ``.get``."""
    for key, value in report.items():
        yield {k: v for k, v in report.items() if k != key}
        if isinstance(value, dict):
            for sub in value:
                yield {**report, key: {k: v for k, v in value.items()
                                       if k != sub}}


@pytest.mark.parametrize("harness", HARNESSES, ids=repr)
def test_harness_line_is_the_references(harness, monkeypatch):
    """The same report through the reference's and the port's line: equal,
    and measured with the same arguments (no harness runs)."""
    ref, ref_calls = _line(ref_bench, harness, harness.report, monkeypatch)
    port, port_calls = _line(bench, harness, harness.report, monkeypatch)
    assert isinstance(port, dict) and port == ref
    assert port_calls == ref_calls and len(port_calls) == 1


@pytest.mark.parametrize("harness", HARNESSES, ids=repr)
def test_harness_line_is_the_references_without_each_key(harness,
                                                         monkeypatch):
    """The report with each key (to the second level) missing in turn:
    where the reference's line fails, the port's fails the same way, and
    where it takes a default, the port's line is equal."""
    n = 0
    for report in _dropped(harness.report):
        ref, _ = _line(ref_bench, harness, report, monkeypatch)
        port, _ = _line(bench, harness, report, monkeypatch)
        assert port == ref, (report, ref, port)
        n += 1
    assert n >= len(harness.report)


#: the flash line's comparator: XLA's lowering in the reference, SDPA in
#: the port (reported under these names)
FLASH_NAMES = {"xla_tflops": "sdpa_tflops",
               "xla_same_process": "sdpa_same_process"}
#: what the port's flash line adds: the comparator's backend and each
#: side's Δt
FLASH_PORT_ONLY = ("sdpa_backend", "flash_dt_s", "sdpa_dt_s")


def _to_port(line: dict) -> dict:
    text = json.dumps(line)
    for old, new in {**BENCH_METRIC_NAMES, **FLASH_NAMES}.items():
        text = text.replace(f'"{old}"', f'"{new}"')
    return json.loads(text)


@pytest.mark.parametrize("on_device", [True, False], ids=["card", "cpu"])
@pytest.mark.parametrize("flash_tflops", [277.4512, 1100.0],
                         ids=["measured", "above-peak"])
def test_flash_line_is_the_references(on_device, flash_tflops, monkeypatch):
    """The flash line from the same report on both copies: equal after the
    name map but for the port's added fields, measured with the
    reference's arguments (on the CPU, its small sizes), audited against
    the same peak."""
    # the modules (each ``ops/__init__.py`` exports a function of the name)
    ref_flash, ref_matmul, port_flash, port_matmul = (
        importlib.import_module(f"{package}.ops.{name}")
        for package in ("tpu_operator", "tpu_operator_torch")
        for name in ("flash_attention", "matmul"))
    report = {"seq_len": 16384, "d": 128, "flash_tflops": flash_tflops,
              "xla_tflops": 342.6401, "sdpa_tflops": 342.6401,
              "sdpa_backend": "CUDNN_ATTENTION",
              "speedup": flash_tflops / 342.6401,
              "checksum_rel_err": 9.1234567e-06,
              "flash_dt_s": 0.0091, "sdpa_dt_s": 0.0072}
    calls = {}

    def measure(side):
        def run(**kwargs):
            # the reference's ``flash_reps_scale`` has no counterpart: the
            # port times both sides over chains of equal length
            calls[side] = {k: v for k, v in kwargs.items()
                           if k not in ("device", "interpret",
                                        "flash_reps_scale")}
            return dict(report)
        return run
    monkeypatch.setattr(ref_flash, "flash_vs_xla_tflops", measure("ref"))
    monkeypatch.setattr(port_flash, "flash_vs_sdpa_tflops",
                        measure("port"))
    monkeypatch.setattr(ref_matmul, "chip_peak_tflops", lambda dev: 989.0)
    monkeypatch.setattr(port_matmul, "chip_peak_tflops", lambda kind: 989.0)
    monkeypatch.setattr(bench, "_kind", lambda dev: H100)
    ref = ref_bench._bench_flash(mock.Mock(device_kind=H100), on_device)
    port = bench._bench_flash(torch.device("cuda" if on_device else "cpu"),
                              on_device)
    added = {k: port["detail"].pop(k) for k in FLASH_PORT_ONLY}
    assert port == _to_port(ref)
    assert added == {k: report[k] for k in FLASH_PORT_ONLY}
    assert calls["port"] == calls["ref"]
    if on_device:
        assert port["detail"]["suspect"] is (flash_tflops > 1.05 * 989.0)


def test_device_lines_carry_the_gpu_names():
    """The five renamed device lines are the map's, and no harness line
    is renamed."""
    harness_metrics = {metric for _, metric, *_ in bench.HARNESS_LINES}
    assert not harness_metrics & set(BENCH_METRIC_NAMES)
    assert all(v.startswith("gpu_") and "tpu" not in v and "ici" not in v
               for v in BENCH_METRIC_NAMES.values())
    src = open(bench.__file__).read()
    for name in BENCH_METRIC_NAMES.values():
        assert f'"{name}"' in src
    for name in BENCH_METRIC_NAMES:
        assert f'"{name}"' not in src
    assert os.path.basename(bench.__file__) == "bench.py"


# -- flash_vs_sdpa_tflops on the CPU ----------------------------------------

def test_flash_vs_sdpa_reports_the_references_fields():
    """On the CPU: the reference's fields (its comparator's under the
    port's name), the math backend as the comparator, the note that the
    times are not a card's, and the checksum error of the plain version
    against SDPA on the same seeded inputs."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from tpu_operator_torch.ops.flash_attention import (attention_plain,
                                                        flash_vs_sdpa_tflops)
    rep = flash_vs_sdpa_tflops(t=128, d=128, reps_hi=2, reps_lo=1, iters=1,
                               repeats=1, device="cpu")
    want = {FLASH_NAMES.get(k, k) for k in
            ("seq_len", "d", "flash_tflops", "xla_tflops", "speedup",
             "checksum_rel_err")}
    assert want <= set(rep) and "sdpa_backend" in rep
    assert rep["sdpa_backend"] == "MATH" and "not a card's" in rep["note"]
    assert (rep["seq_len"], rep["d"]) == (128, 128)
    assert all(rep[k] > 0 for k in ("flash_tflops", "sdpa_tflops",
                                    "speedup"))
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((128, 128), generator=gen, dtype=torch.bfloat16)
               for _ in range(3))
    got = attention_plain(q, k, v, causal=True).float().sum().item()
    with sdpa_kernel(SDPBackend.MATH):
        ref = F.scaled_dot_product_attention(
            q[None, None], k[None, None], v[None, None],
            is_causal=True)[0, 0].float().sum().item()
    assert rep["checksum_rel_err"] == abs(got - ref) / max(abs(ref), 1e-6)


def test_chained_calls_feed_each_output_back_as_q():
    """A chain of ``reps`` calls is the reference's ``fori_loop``: each
    output is the next call's q, k and v stay, and the fetched number is
    the last output's f32 sum."""
    from tpu_operator_torch.ops.flash_attention import _chained
    q, k, v = (torch.full((4, 2), x) for x in (1.0, 2.0, 3.0))
    seen = []

    def fn(a, b, c):
        seen.append((a[0, 0].item(), b is k, c is v))
        return a + b * c
    assert _chained(fn, q, k, v, 3)() == 8 * (1.0 + 3 * 6.0)
    assert seen == [(1.0, True, True), (7.0, True, True),
                    (13.0, True, True)]


def test_flash_vs_sdpa_needs_a_card_unless_asked(monkeypatch):
    from tpu_operator_torch.ops.flash_attention import flash_vs_sdpa_tflops
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        flash_vs_sdpa_tflops()
