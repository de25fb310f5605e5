"""The reference's ``tests/test_analysis.py`` on both copies of the
invariant analyzer (``tpu_operator_torch/analysis``): every per-rule
fixture must fire on the port as on the reference and every negative
fixture must stay clean, with every value the assertions look at equal
after the name map (``tests/torch_relay.py::run_case`` with
``tests/torch_analysis.py``'s maps: fixture paths under the port's
package, ``gpucheck`` for ``tpucheck``). Then what only the port has: its
CLI on this checkout in a fresh interpreter without torch, its empty
baseline, its suppressions under its own tool name, and the health
monitor's env read the wiring pass sees."""

import contextlib
import io
import json
import os
import subprocess
import sys
import textwrap

import pytest

import torch_analysis
from torch_relay import cases, run_case

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = os.path.join(ROOT, "tpu_operator_torch")


@pytest.mark.parametrize("name, fn, params", cases("test_analysis"))
def test_same_as_the_reference(name, fn, params, tmp_path):
    run_case(name, fn, params, tmp_path, maps=torch_analysis.MAPS,
             assertions_only=f"{name}.py::{fn}"
             in torch_analysis.ASSERTIONS_ONLY)


def test_cli_is_clean_on_this_checkout_without_torch():
    """``python -m tpu_operator_torch.analysis --all`` exits 0 with no
    finding, in a fresh interpreter that never loads torch, grpc or the
    reference."""
    code = textwrap.dedent("""
        import runpy, sys
        sys.argv = ["tpu_operator_torch.analysis", "--all", "--format",
                    "json"]
        try:
            runpy.run_module("tpu_operator_torch.analysis",
                             run_name="__main__")
            rc = 0
        except SystemExit as e:
            rc = e.code
        leaked = sorted(m for m in sys.modules if m.split(".")[0] in
                        ("torch", "grpc", "jax", "tpu_operator"))
        print(rc, leaked, file=sys.stderr)
        sys.exit(rc if not leaked else 3)
    """)
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout) == {"findings": []}
    assert "gpucheck: 0 finding(s) from 8 pass(es)" in out.stderr


def _listed(main) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(["--list"]) == 0
    return out.getvalue()


def test_list_names_the_references_passes_and_rules():
    from tpu_operator.analysis.__main__ import main as ref_main
    from tpu_operator_torch.analysis.__main__ import main as port_main
    listed = _listed(port_main)
    assert listed == _listed(ref_main)
    assert len(listed.splitlines()) == 8


def test_shipped_baseline_is_empty():
    from tpu_operator_torch.analysis.core import BASELINE_NAME
    assert BASELINE_NAME == "tpu_operator_torch/gpucheck-baseline.json"
    data = json.load(open(os.path.join(ROOT, BASELINE_NAME)))
    assert data["findings"] == []


def test_suppressions_carry_the_ports_tool_name_and_a_reason():
    """Every inline suppression in the port reads ``# gpucheck:
    ignore[rule] -- why``; none is under the reference's tool name."""
    marks = []
    for dirpath, _, names in os.walk(PACKAGE):
        for n in names:
            if not n.endswith(".py"):
                continue
            path = os.path.join(dirpath, n)
            for i, line in enumerate(open(path), start=1):
                rel = f"{os.path.relpath(path, ROOT)}:{i}"
                assert "tpucheck:" not in line, rel
                if "# gpucheck: ignore[" in line and "analysis/" not in rel:
                    marks.append(rel)
                    assert " -- " in line.split("# gpucheck:")[1], rel
    assert sorted(m.split(":")[0] for m in marks) == [
        "tpu_operator_torch/_native.py", "tpu_operator_torch/relay/batcher.py",
        "tpu_operator_torch/relay/sessions.py",
        "tpu_operator_torch/relay/sessions.py"]


def test_health_monitor_reads_the_projected_health_file_literal():
    """The transform projects ``HEALTH_FILE_ENV``; the CLI reads the same
    name as a literal, which is what the wiring pass's reader sees."""
    from tpu_operator_torch.analysis.core import Context
    from tpu_operator_torch.analysis.passes import wiring
    from tpu_operator_torch.deviceplugin.discovery import HEALTH_FILE_ENV
    assert HEALTH_FILE_ENV == "GPU_HEALTH_FILE"
    cli = Context(ROOT).module("tpu_operator_torch/cli/health_monitor.py")
    assert HEALTH_FILE_ENV in wiring._read_env(cli)
