"""``chip_smoke.py``'s eleventh path, "operator installed from its chart", on
the CPU.

The path runs here as it runs on the card — the cfg tool's four gates, the
port's apiserver over TLS seeded through the kubectl shim, the chart
rendered and applied over the wire, the operator started from the applied
Deployment through the operator image's shim, the override re-applied,
must-gather and the uninstall — with the one step that needs the card, the
rendered ``workload`` container, replaced by a stand-in that records the
entry point the validator image's shim resolved to.
"""

import chip_smoke


def test_the_install_path_on_the_cpu(monkeypatch, capsys):
    handed = []

    def workload(client, tag, validator=None):
        ds = client.get("DaemonSet", "gpu-operator-validator",
                        chip_smoke.STATES_NS)
        [c] = [c for c in ds.get("spec", "template", "spec",
                                 "initContainers")
               if c["name"] == "workload-validation"]
        handed.append((tag, c["command"], validator.__module__))
    monkeypatch.setattr(chip_smoke, "run_rendered_workload", workload)
    chip_smoke.phase_install()
    assert handed == [("[install]", ["gpu-validator", "--component",
                                     "workload"],
                       "tpu_operator_torch.cli.validator")]
    out = capsys.readouterr().out
    for gate in ("chart", "crd", "clusterpolicy --path", "csv"):
        assert f"[install] gpu-cfg validate {gate}" in out, gate
    for line in (
            '"customresourcedefinition": 1, "deployment": 1, '
            '"gpuclusterpolicy": 1',
            "-> ['python', '-m', 'tpu_operator_torch.cli.operator', "
            "'--metrics-port=0', '--leader-elect']",
            "substitution: image ENV GPU_OPERATOR_ASSETS=/opt/gpu-operator/"
            "tpu_operator_torch/assets -> ",
            "substitution: --client incluster (the default) -> --client "
            "https://127.0.0.1:",
            "install -> ready", "the applied CR shows "
            "metricsExporter.enabled false", "[install] must-gather: ",
            "none left; the operator exited rc 0 on SIGINT"):
        assert line in out, (line, out)
