"""The harness end to end on the CPU: the result line, discovery by name,
no fallback without a card, and the import guard."""

import json
import os
import shutil
import subprocess
import sys
import types

import pytest

from port_bench import guard, spec
from port_bench.harness import main, run_cell

ROOT = str(spec.ROOT)

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("cell", ["validate.default", "attn.causal-16k"])
def test_line_of_each_cell(cpu_run, cell):
    line = cpu_run(cell)
    assert list(line)[:5] == KEYS and list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    e2e = {m["name"] for m in spec.metrics(spec.Pieces().benchmark(), cell, False)}
    assert set(line["metrics"]) == e2e
    for m in line["metrics"].values():
        assert m["value"] > 0 and m["unit"]
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(line)


def test_traced_line_has_per_layer_metrics_and_a_breakdown(cpu_run):
    line = cpu_run("validate.default", seconds=2.5, trace=True)
    assert {"leg_s.hbm", "leg_s.matmul", "leg_s.flash"} <= set(
        line["metrics"])
    # no device ops on the CPU: no roofline and no idle share is made up
    assert "hbm_roofline.validate" not in line["metrics"]
    assert "device_idle.validate" not in line["metrics"]
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert len(line["breakdown"]["idle_gaps"]) <= 10


def test_no_card_no_result(capsys):
    pytest.importorskip("torch")
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is reachable here")
    rc = main(["--workload", "attn.causal-16k", "--seed", str(2**31 + 5),
               "--seconds", "1", "--trace", "0"], 0.0)
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""
    assert "torch.cuda.is_available() is false" in out.err


def test_command_alone_without_the_program_fails(tmp_path):
    """In a directory holding only BENCHMARK.json and port_bench/, the
    command exits non-zero and prints no result."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "port_bench"), tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, *bench["command"], "--workload", "attn.causal-16k",
         "--seed", str(2**31 + 3), "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout == ""


def _dummy_checkout(tmp_path, mix: dict):
    """A checkout with a new configuration, traffic mix (``mix`` over the
    back-to-back one), metric and cell: files and entries only, no edit of
    a file that is there."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "port_bench"), tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    pb = tmp_path / "port_bench"
    config = json.loads((pb / "configs/attn-probe-16k.json").read_text())
    config.update(name="attn-probe-dummy", t=128, heads=2)
    (pb / "configs/attn-probe-dummy.json").write_text(json.dumps(config))
    traffic = json.loads((pb / "traffic/back_to_back.json").read_text())
    traffic.update(pool=2, sample=3, **mix)
    (pb / "traffic/dummy_mix.json").write_text(json.dumps(traffic))
    (pb / "metrics/dummy_calls.py").write_text(
        "def read(run):\n    return float(run.steps)\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "attn-probe-dummy", "source": "x",
                             "file": "port_bench/configs/attn-probe-dummy.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "attn.dummy", "config":
                               "attn-probe-dummy", "traffic": "dummy_mix",
                               "chips": 1, "why": "a test"})
    bench["end_to_end"].append({"name": "dummy_calls", "unit": "calls",
                                "better": "higher", "bound": 0.1,
                                "source": "host_clock",
                                "workloads": ["attn.dummy"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp_path


def _count_syncs(counts):
    def fault(session):
        sync = session.sync

        def counted():
            counts.append(1)
            sync()
        session.sync = counted
    return fault


@pytest.mark.parametrize("loop", ["dispatch", "closed"])
def test_a_cell_added_as_files_alone_is_found(tmp_path, loop):
    """The mix's ``loop`` alone sets the pacing: one wait where the window
    ends, or one after each unit (and one after set-up's warm pass)."""
    root = _dummy_checkout(tmp_path, {"loop": loop})
    syncs = []
    line = run_cell("attn.dummy", 2**31 + 1, 0.3, False, device="cpu",
                    root=root, fault=_count_syncs(syncs))
    assert line["correct"] is True
    assert line["metrics"]["dummy_calls"]["value"] == line["attempted"]
    assert set(line["metrics"]) == {"dummy_calls", "setup_s"}
    waits = line["attempted"] if loop == "closed" else 0
    assert len(syncs) == 2 + waits


def test_a_mix_added_as_data_paces_its_units(tmp_path):
    """``interval_s``: a unit starts at most once an interval, a mix that
    needs no new code (a periodic check, arrivals at a fixed rate)."""
    root = _dummy_checkout(tmp_path, {"loop": "closed", "interval_s": 0.1})
    line = run_cell("attn.dummy", 2**31 + 2, 0.35, False, device="cpu",
                    root=root)
    assert line["correct"] is True
    steps, seconds = line["attempted"], line["window"]["seconds"]
    assert 4 <= steps <= 5 and seconds >= (steps - 1) * 0.1


@pytest.mark.parametrize("mix", [{"loop": "open"}, {"loop": None},
                                 {"loop": "closed", "interval_s": -1}])
def test_a_mix_whose_pacing_no_loop_knows_is_refused(tmp_path, mix):
    root = _dummy_checkout(tmp_path, mix)
    with pytest.raises(spec.SpecError, match="loop|interval_s"):
        run_cell("attn.dummy", 2**31 + 3, 0.3, False, device="cpu",
                 root=root)


def test_guard_compares_whole_top_level_names():
    assert guard.forbidden_loaded(["tpu_operator_torch.ops", "jaxtyping",
                                   "flaxen", "torch"]) == []
    assert guard.forbidden_loaded(["tpu_operator.ops.hbm", "jax.numpy",
                                   "jaxlib", "flax.linen"]) == [
        "flax", "jax", "jaxlib", "tpu_operator"]
    with pytest.raises(guard.ForbiddenImport, match="tpu_operator"):
        guard.check("test", ["tpu_operator"])


def test_nothing_the_benchmark_loads_is_jax():
    """Every module of the harness, its entries, readers and references,
    and the program modules they reach, in a fresh process."""
    code = (
        "import sys, pathlib\n"
        "from port_bench import harness, calibrate, spec\n"
        "here = spec.Pieces()\n"
        "for kind in ('entries', 'metrics'):\n"
        "    for p in sorted((here.dir / kind).glob('*.py')):\n"
        "        if p.stem != '__init__':\n"
        "            here.module(kind, p.stem)\n"
        "import port_bench.entries.validate, port_bench.entries.flash_op\n"
        "import tpu_operator_torch.validator.components\n"
        "import tpu_operator_torch.ops.flash_attention\n"
        "from port_bench import guard\n"
        "print(guard.forbidden_loaded())\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


def test_run_refuses_a_forbidden_module(monkeypatch, cpu_run):
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    with pytest.raises(guard.ForbiddenImport, match="jax"):
        cpu_run("attn.causal-16k")
