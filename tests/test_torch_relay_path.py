"""``chip_smoke.py``'s twelfth path, "relay replica", on the CPU.

The path runs here as it runs on the card — the operator CLI drives a
policy with the relay enabled to ready, the rendered ``gpu-relay-service``
command resolves through the relay image and self-tests as its own
process, the seeded drive runs at full width under the rendered
environment, and the command serves on a free port until SIGINT — with the
one step that needs the card, the rendered ``workload`` container, replaced
by a stand-in that records what it was handed.
"""

import re

import chip_smoke


def test_the_relay_path_on_the_cpu(monkeypatch, capsys):
    handed = []

    def workload(client, tag, validator=None):
        ds = client.get("DaemonSet", "gpu-operator-validator",
                        chip_smoke.STATES_NS)
        [c] = [c for c in ds.get("spec", "template", "spec",
                                 "initContainers")
               if c["name"] == "workload-validation"]
        handed.append((tag, c["command"]))
    monkeypatch.setattr(chip_smoke, "run_rendered_workload", workload)
    for phase in (chip_smoke.phase_relay_render,
                  chip_smoke.phase_relay_workload,
                  chip_smoke.phase_relay_self_test,
                  chip_smoke.phase_relay_drive,
                  chip_smoke.phase_relay_serve):
        phase()
    assert handed == [("[relay]", ["gpu-validator", "--component",
                                   "workload"])]
    assert "tmp" not in chip_smoke.RELAY_RUN
    out = capsys.readouterr().out
    for line in (
            "[relay] state-relay-service ready; the policy ready True",
            "image ghcr.io/gpu-operator/gpu-relay-service:v0.1.0 -> "
            "tpu_operator_torch/docker/Dockerfile.operands; command "
            "['gpu-relay-service'] -> ['-m', "
            "'tpu_operator_torch.cli.relay_service']",
            "--self-test: rc 0, ok True, admitted 64, completed 64, "
            "missing 0",
            "executed twice 0, admitted and never run 0, lost 0, stray 0",
            "KV caches wrong []",
            "SPMD gather copies 0",
            "ledger kind h100",
            "kind h100, residue",
            "SIGINT: rc 0"):
        assert line in out, (line, out)
    fired = re.search(r"plan generations fired \[\((\d+), .*?\), \((\d+), "
                      r"2, 2\)\]", out)
    assert fired and int(fired.group(2)) == int(fired.group(1)) + 1, out
