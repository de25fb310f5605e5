"""``chip_smoke.py``'s last path, "static gate", on the CPU: the
analyzer over the checkout, its ``--list``, the byte-compile sweep and the
CDI case's render check run here as processes, as they run on the card
machine; and the path is the last one ``main`` drives, counting no
kernel."""

import inspect

import chip_smoke


def test_the_static_gate_path_on_the_cpu(capsys):
    chip_smoke.phase_static_gate()
    out = capsys.readouterr().out
    for line in (
            "[lint] python -m tpu_operator_torch.analysis --all --format "
            "json: rc 0;",
            "[lint] gpucheck: 0 finding(s) from 8 passes",
            "[lint] python -m tpu_operator_torch.analysis --list: rc 0;",
            "[lint] passes: locks, clocks, errors, randomness, allocations, "
            "pump-alloc, wiring, metrics-docs",
            "[lint] make -C tpu_operator_torch lint-compile: rc 0;",
            "[lint] scripts/cases/cdi-runtime.sh (render check): rc 0;",
            "[lint]   [case] render check OK",
            "[lint]   [case] handed over with CHART_SET_OPTIONS=--set "
            "containerToolkit.cdiEnabled=true --set "
            "devicePlugin.resourceName=nvidia.com/gpu-h100",
            "[lint] the static gate launches no kernel"):
        assert line in out, line


def test_the_static_gate_is_the_last_path_and_counts_no_kernel():
    src = inspect.getsource(chip_smoke.main)
    paths = src[src.index("paths = ("):src.index("# a kernel's launches")]
    assert paths.rstrip().endswith(
        '("static gate", (phase_static_gate,), {}),\n    )')
