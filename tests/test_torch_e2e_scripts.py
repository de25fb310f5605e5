"""The port's e2e scenario scripts (``tpu_operator_torch/scripts/``) in
fake mode, and the port's must-gather and chart-override scenarios: the
port versions of ``tests/test_e2e_harness.py``'s
``test_end_to_end_harness`` (file-backed fake cluster),
``test_must_gather_against_fake_cluster`` and
``test_chart_overrides_reach_applied_release``. The wire-mode run of the
same scenario is ``tests/test_torch_e2e_scripts_wire.py`` (each takes about
a minute).
"""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "tpu_operator_torch")
SCRIPTS = os.path.join(PKG, "scripts")
KUBECTL = [sys.executable, "-m", "tpu_operator_torch.cli.kubectl"]


def _env(**extra):
    """The scripts' environment: the machine's basics and the checkout, and
    nothing a test before this one left in ``os.environ`` (a cluster URL,
    a device glob)."""
    keep = {k: os.environ[k] for k in ("PATH", "HOME", "TMPDIR", "LANG")
            if k in os.environ}
    return {**keep, "PYTHONPATH": ROOT, **extra}


def test_end_to_end_harness(tmp_path):
    p = subprocess.run(
        ["bash", os.path.join(SCRIPTS, "e2e", "end-to-end.sh")],
        capture_output=True, text=True, timeout=600,
        env=_env(E2E_TMP=str(tmp_path)))
    assert p.returncode == 0, f"stdout:\n{p.stdout}\nstderr:\n{p.stderr}"
    assert "e2e PASSED" in p.stdout
    for step in ("verify-operator", "install-workload", "update-clusterpolicy",
                 "upgrade-driver", "slice-partition", "feature-discovery",
                 "disable-enable-operands"):
        assert f"[e2e] {step} OK" in p.stdout, step


def test_must_gather_against_fake_cluster(tmp_path):
    state = tmp_path / "cluster.json"
    kctl = [*KUBECTL, "--client", f"fake:{state}"]
    env = _env()
    node_yaml = tmp_path / "node.yaml"
    node_yaml.write_text("""
apiVersion: v1
kind: Node
metadata:
  name: gpu-node-0
  labels:
    feature.node.kubernetes.io/pci-10de.present: "true"
    nvidia.com/gpu.product: NVIDIA-H100-80GB-HBM3
status:
  nodeInfo: {containerRuntimeVersion: "containerd://1.7.0"}
""")
    subprocess.run([*kctl, "apply", "-f", str(node_yaml)],
                   check=True, env=env, capture_output=True)
    cr = tmp_path / "cr.yaml"
    cr.write_text("apiVersion: nvidia.com/v1alpha1\nkind: GPUClusterPolicy\n"
                  "metadata:\n  name: gpu-cluster-policy\nspec: {}\n")
    subprocess.run([*kctl, "apply", "-f", str(cr)],
                   check=True, env=env, capture_output=True)
    subprocess.run([sys.executable, "-m", "tpu_operator_torch.cli.operator",
                    "--client", f"fake:{state}", "--once"],
                   env=env, capture_output=True)

    out = tmp_path / "gather"
    p = subprocess.run(
        ["bash", os.path.join(PKG, "hack", "must-gather.sh"), str(out)],
        capture_output=True, text=True, timeout=120,
        env={**env, "KCTL": " ".join(kctl)})
    assert p.returncode == 0, p.stderr
    nodes = json.load(open(out / "nodes.json"))
    assert nodes["items"][0]["metadata"]["name"] == "gpu-node-0"
    policy = json.load(open(out / "clusterpolicy.json"))
    assert policy["kind"] == "GPUClusterPolicy"
    ds = json.load(open(out / "daemonsets.json"))
    assert len(ds["items"]) >= 5
    assert {d["metadata"]["name"] for d in ds["items"]} >= {
        "gpu-operator-validator", "gpu-device-plugin"}


def test_chart_overrides_reach_applied_release(tmp_path):
    """CHART_SET_OPTIONS flows through install-operator.sh into the APPLIED
    cluster state, not just the render: the test reads the stored CR."""
    state = tmp_path / "cluster.json"
    env = _env(CLUSTER_STATE=str(state),
               CHART_SET_OPTIONS="--set containerToolkit.cdiEnabled=false "
                                 "--set devicePlugin.resourceName="
                                 "nvidia.com/gpu-h100")
    p = subprocess.run(
        ["bash", os.path.join(SCRIPTS, "e2e", "install-operator.sh")],
        capture_output=True, text=True, timeout=120, env=env)
    assert p.returncode == 0, f"stdout:\n{p.stdout}\nstderr:\n{p.stderr}"
    out = subprocess.run(
        [*KUBECTL, "--client", f"fake:{state}",
         "get", "gpucp", "gpu-cluster-policy", "-o", "json"],
        capture_output=True, text=True, timeout=60, env=env)
    assert out.returncode == 0, out.stderr
    spec = json.loads(out.stdout)["spec"]
    assert spec["containerToolkit"]["cdiEnabled"] is False
    assert spec["devicePlugin"]["resourceName"] == "nvidia.com/gpu-h100"
    dep = subprocess.run(
        [*KUBECTL, "--client", f"fake:{state}",
         "get", "deployment", "gpu-operator", "-n", "gpu-operator",
         "-o", "json"], capture_output=True, text=True, timeout=60, env=env)
    assert json.loads(dep.stdout)["spec"]["template"]["spec"][
        "containers"][0]["command"] == ["gpu-operator"]


def test_ci_run_lists_the_ported_modes():
    """The CI entry point runs the static gates (``make lint``) first, then
    the scenario in both modes, the five control-plane harnesses and the
    relay tier's twelve, the relay tier's own last (fault F13)."""
    text = open(os.path.join(SCRIPTS, "ci-run-e2e.sh")).read()
    steps = [line for line in text.splitlines()
             if line and not line.startswith(("#", "echo", " ", "}"))]
    lint = 'make -C "${ROOT}/tpu_operator_torch" lint'
    first = steps.index(lint)
    assert steps[first + 1].startswith('"${HERE}/e2e/end-to-end.sh"')
    assert "mode 1/20: static gates" in text and "mode 20/20: relay tier" \
        in text
    assert "E2E_APISERVER=1" in text
    modules = [line.split()[1] for line in text.splitlines()
               if line.startswith("harness ")]
    assert modules == ["chaos_convergence", "steady_state", "mttr",
                       "fleet_scale", "goodput", "relay_serving",
                       "serving_slo", "request_trace", "relay_mem", "reshard",
                       "relay_qos", "pump_speed", "utilization", "federation",
                       "spmd", "sessions", "relay_tier"]
    import importlib
    for m in modules:
        assert importlib.util.find_spec(f"tpu_operator_torch.e2e.{m}"), m
    assert "wait" not in text and "F13" in text
    assert "tpu_operator." not in text.replace("tpu_operator_torch.", "")


def _stub(tmp_path):
    """A stand-in for the CI entry point a case script hands over to: it
    prints its arguments and the chart options it was given."""
    stub = tmp_path / "ci-run.sh"
    stub.write_text('echo "[stub] args: $*"\n'
                    'echo "[stub] CHART_SET_OPTIONS=${CHART_SET_OPTIONS:-}"\n')
    return str(stub)


@pytest.mark.parametrize("case", ["defaults", "cdi-runtime"])
def test_case_scripts_check_the_render_and_hand_over(case, tmp_path):
    """Each case script up to its ``exec`` of the CI entry point
    (``CI_RUN`` points it at a stub): ``cdi-runtime.sh`` renders the chart
    with its two overrides and checks they landed, then hands over with
    them exported; ``defaults.sh`` hands over with stock values."""
    p = subprocess.run(
        ["bash", os.path.join(SCRIPTS, "cases", f"{case}.sh"), "--x"],
        capture_output=True, text=True, timeout=120,
        env=_env(CI_RUN=_stub(tmp_path)))
    assert p.returncode == 0, f"stdout:\n{p.stdout}\nstderr:\n{p.stderr}"
    assert "[stub] args: --x" in p.stdout
    if case == "defaults":
        assert "[stub] CHART_SET_OPTIONS=\n" in p.stdout
    else:
        assert "[case] render check OK" in p.stdout
        assert ("[stub] CHART_SET_OPTIONS=--set containerToolkit.cdiEnabled="
                "true --set devicePlugin.resourceName=nvidia.com/gpu-h100"
                in p.stdout)


def test_case_script_fails_when_an_override_does_not_render(tmp_path):
    """The render check is a check: a copy of the script whose override
    names another resource than the one it looks for fails before it
    hands over."""
    text = open(os.path.join(SCRIPTS, "cases", "cdi-runtime.sh")).read()
    doctored = text.replace("--set devicePlugin.resourceName=nvidia.com/"
                            "gpu-h100", "--set devicePlugin.resourceName="
                            "nvidia.com/gpu-a100")
    assert doctored != text
    script = tmp_path / "cases" / "cdi-runtime.sh"
    script.parent.mkdir()
    script.write_text(doctored.replace('ROOT="$(cd "${HERE}/../../.." && pwd)"',
                                       f'ROOT="{ROOT}"'))
    p = subprocess.run(["bash", str(script)], capture_output=True,
                       text=True, timeout=120, env=_env(CI_RUN=_stub(tmp_path)))
    assert p.returncode == 1, p.stdout + p.stderr
    assert "[case] FAIL: resourceName override missing" in p.stdout
    assert "[stub]" not in p.stdout


def test_case_script_render_check_holds_on_a_large_render(tmp_path):
    """The render check reads the whole render without a pipe: a copy of
    the script whose render carries 1 MiB after the overrides (grep -q
    matches in its first lines and stops reading) still passes under
    ``pipefail``."""
    text = open(os.path.join(SCRIPTS, "cases", "cdi-runtime.sh")).read()
    render = "render chart ${CHART_SET_OPTIONS})"
    assert render in text
    doctored = text.replace(render, render[:-1] + "; head -c 1048576 "
                            "/dev/zero | tr '\\0' x)")
    script = tmp_path / "cases" / "cdi-runtime.sh"
    script.parent.mkdir()
    script.write_text(doctored.replace('ROOT="$(cd "${HERE}/../../.." && pwd)"',
                                       f'ROOT="{ROOT}"'))
    p = subprocess.run(["bash", str(script)], capture_output=True,
                       text=True, timeout=120, env=_env(CI_RUN=_stub(tmp_path)))
    assert p.returncode == 0, p.stdout + p.stderr
    assert "[case] render check OK" in p.stdout


def test_the_workload_pod_runs_the_validator_image():
    """``gpu-pod.yaml`` asks for one ``nvidia.com/gpu`` under the
    ``nvidia`` runtime class, and its command resolves in its image to the
    validator CLI's ``workload`` component."""
    import yaml
    from tpu_operator_torch.packaging import images
    pod = yaml.safe_load(open(os.path.join(SCRIPTS, "e2e", "gpu-pod.yaml")))
    assert pod["spec"]["runtimeClassName"] == "nvidia"
    [c] = pod["spec"]["containers"]
    assert c["resources"]["limits"] == {"nvidia.com/gpu": 1}
    assert images.resolve(images.image_for(c["image"]), c["command"]) == [
        "python", "-m", "tpu_operator_torch.cli.validator", "--component",
        "workload"]
