"""``chip_smoke.py``'s thirteenth path, "relay tier", on the CPU.

The path runs here as it runs on the card — the operator CLI drives a
policy with the router, its autoscaler and the federation switched on to
ready, both front commands resolve through the relay image and self-test
as their own processes, the seeded drives run under the rendered
environments, both commands serve on a free port until SIGINT, and the
tier's two harnesses run as processes — with the one step that needs the
card, the rendered ``workload`` container, replaced by a stand-in that
records what it was handed.
"""

import re

import chip_smoke


def test_the_relay_tier_path_on_the_cpu(monkeypatch, capsys):
    handed = []

    def workload(client, tag, validator=None):
        ds = client.get("DaemonSet", "gpu-operator-validator",
                        chip_smoke.STATES_NS)
        [c] = [c for c in ds.get("spec", "template", "spec",
                                 "initContainers")
               if c["name"] == "workload-validation"]
        handed.append((tag, c["command"]))
    monkeypatch.setattr(chip_smoke, "run_rendered_workload", workload)
    for phase in (chip_smoke.phase_tier_render,
                  chip_smoke.phase_tier_workload,
                  chip_smoke.phase_tier_self_test,
                  chip_smoke.phase_tier_drive,
                  chip_smoke.phase_tier_serve,
                  chip_smoke.phase_tier_harnesses):
        phase()
    assert handed == [("[relay-tier]", ["gpu-validator", "--component",
                                        "workload"])]
    assert "tmp" not in chip_smoke.TIER_RUN
    out = capsys.readouterr().out
    for line in (
            "[relay-tier] state-relay-service ready; the policy ready True",
            "Deployment gpu-relay-router: 1 replicas",
            "Deployment gpu-relay-federation: 1 replicas",
            "command ['gpu-relay-router'] -> ['-m', "
            "'tpu_operator_torch.cli.relay_router']",
            "gpu-relay-router --self-test: rc 0, ok True, routed 144, "
            "completed 144, missing 0",
            "gpu-relay-federation --self-test: rc 0, ok True, placed 96, "
            "completed 96, missing 0",
            "killed relay-0 (resubmitted ",
            "killed cell-0 (resubmitted ",
            "0 refused ids run or completed",
            "replicas at the end ['relay-1']",
            "cells at the end ['cell-2']",
            "keyed by ['relay-0', 'relay-1'], upstream gpu-relay-service:8479",
            "keyed by ['cell-0', 'cell-1']",
            "gpu-relay-router SIGINT: rc 0",
            "gpu-relay-federation SIGINT: rc 0",
            "e2e.federation --ci: rc 0, ok True, problems []",
            "e2e.relay_tier --ci: rc 1, ok False"):
        assert line in out, (line, out)
    for ledger in re.findall(r"drive: \d+ admitted, .*", out):
        assert "executed twice 0, admitted and never run 0, lost 0, " \
               "stray 0" in ledger, ledger
        front, replicas = re.search(r"'429': (\d+).*?\((\d+) 429s",
                                    ledger).groups()
        assert int(front) > 0 and front == replicas, ledger
