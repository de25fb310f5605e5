"""The contract between the state pipeline and the operands it deploys.

For every container the port's pipeline renders (init containers, main
containers, their probes and lifecycle hooks), under the default policy and
under a policy that turns on every optional knob the transforms read:

- its command names an entry point of the port: a ``cli/`` module with a
  ``main`` (and, for ``gpu-validator``, a component it has) or a
  ``native/`` target whose ``main.cc`` handles the subcommand;
- every environment variable a transform or an asset sets is one the port's
  code reads (an ``os.environ``/``env.get``/``getenv`` of that name), or a
  downward-API value another variable of the same container expands;
- every variable an operand reads with no default fit for a cluster is one
  the pipeline sets.

The reference resolves its commands through its Dockerfiles
(``tests/test_operands.py:432``); the port has no images yet, so
``ENTRY_POINTS`` maps each command to the module or target that provides
it. A planted misspelling (``REQUIRE_TPU_PLATFORM`` left in an asset) fails
the check. The relay tier's operands are not ported yet (ROADMAP item 17):
the relay is opt-in, renders nothing by default, and its commands are
listed in ``PENDING``.
"""

import ast
import importlib
import os
import re
import shutil

import pytest

from tpu_operator_torch.api.v1alpha1 import GPUClusterPolicy
from tpu_operator_torch.controllers.state_manager import StateManager
from tpu_operator_torch.kube import FakeClient, Obj
from tpu_operator_torch.validator.components import VALID_COMPONENTS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "tpu_operator_torch")
ASSETS = os.path.join(PKG, "assets")
NS = "gpu-operator"

#: command → ("python", module) or ("native", target directory)
ENTRY_POINTS = {
    "gpu-validator": ("python", "tpu_operator_torch.cli.validator"),
    "gpu-device-plugin": ("python", "tpu_operator_torch.cli.device_plugin"),
    "gpu-feature-discovery": ("python",
                              "tpu_operator_torch.cli.feature_discovery"),
    "gpu-health-monitor": ("python", "tpu_operator_torch.cli.health_monitor"),
    "gpu-metrics-exporter": ("python",
                             "tpu_operator_torch.cli.metrics_exporter"),
    "gpu-slice-manager": ("python", "tpu_operator_torch.cli.slice_manager"),
    "gpu-node-agent": ("native", "gpu_node_agent"),
    "gpu-metrics-agent": ("native", "gpu_metrics_agent"),
    "gpu-oci-hook": ("native", "gpu_oci_hook"),
    "gpu-smoke": ("native", "gpu_smoke"),
}
#: operands the pipeline can render whose port is still to come
PENDING = {"gpu-relay-service", "gpu-relay-router", "gpu-relay-federation"}

#: (command, validator component or subcommand) → variables it reads with
#: no default fit for a cluster
REQUIRED = {
    ("gpu-validator", "workload"): {"REQUIRE_GPU_PLATFORM",
                                    "DRIVER_INSTALL_DIR"},
    ("gpu-validator", "fabric"): {"REQUIRE_GPU_PLATFORM",
                                  "DRIVER_INSTALL_DIR"},
    ("gpu-validator", "driver"): {"DRIVER_INSTALL_DIR"},
    ("gpu-validator", "plugin"): {"NODE_NAME", "GPU_RESOURCE_NAME"},
    ("gpu-validator", "metrics"): {"NODE_NAME"},
    ("gpu-device-plugin", None): {"GPU_RESOURCE_NAME", "GPU_HEALTH_FILE",
                                  "SLICE_AWARE"},
    ("gpu-feature-discovery", None): {"NODE_NAME"},
    ("gpu-health-monitor", None): {"NODE_NAME"},
    ("gpu-slice-manager", None): {"NODE_NAME", "GPU_RESOURCE_NAME"},
    ("gpu-metrics-exporter", None): {"NODE_NAME", "GPU_METRICS_AGENT_ADDR"},
    ("gpu-node-agent", "driver-install"): {"DRIVER_INSTALL_DIR"},
    ("gpu-node-agent", "runtime-configure"): {"DRIVER_INSTALL_DIR",
                                              "CDI_SPEC_DIR",
                                              "CONTAINERD_CONFIG"},
    ("gpu-oci-hook", "install"): {"DRIVER_INSTALL_DIR"},
}

#: a policy under which every transform sets every variable it can
FULL = {"nodeStatusExporter": {"enabled": True},
        "multinode": {"enabled": True},
        "driver": {"requiredVersion": "580.159.03"},
        "validator": {"peakTflops": 989.0, "peakHbmGbps": 3350.0},
        "featureDiscovery": {"nfdFeatureDir": "/etc/nfd/features.d"},
        "healthMonitor": {"hbmSweep": {"enable": True, "sizeMb": 256},
                          "counterThresholds": {
                              "ecc_uncorrected_volatile": 0}}}


def _env_names_python(path: str) -> set[str]:
    """The names a Python source reads from the environment."""
    tree = ast.parse(open(path).read())
    out = set()

    def env_like(node) -> bool:
        src = ast.unparse(node)
        return "environ" in src or src in ("env", "self.env")

    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and isinstance(node.func,
                                                     ast.Attribute):
            if node.func.attr in ("get", "pop", "getenv") and node.args \
                    and isinstance(node.args[0], ast.Constant) \
                    and isinstance(node.args[0].value, str) \
                    and (node.func.attr == "getenv"
                         or env_like(node.func.value)):
                out.add(node.args[0].value)
        elif isinstance(node, ast.Subscript) and env_like(node.value) \
                and isinstance(node.slice, ast.Constant):
            out.add(node.slice.value)
        elif isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and node.targets[0].id.endswith("_ENV") \
                and isinstance(node.value, ast.Constant):
            out.add(node.value.value)
    return out


def _env_names_native(path: str) -> set[str]:
    """The names a C++ source reads: ``getenv`` of a literal, the worker
    identity filter (``k == "X"``) and the hook's baked variable list."""
    text = open(path).read()
    out = set(re.findall(r'getenv\("([A-Z0-9_]+)"\)', text))
    out |= set(re.findall(r'\bk == "([A-Z0-9_]+)"', text))
    for group in re.findall(r"for \(const char\* key : \{([^}]*)\}", text):
        out |= set(re.findall(r'"([A-Z0-9_]+)"', group))
    return out


def names_read_by_the_port() -> set[str]:
    out = set()
    for d, dirs, files in os.walk(PKG):
        dirs[:] = [x for x in dirs if x != "build"]
        for f in files:
            path = os.path.join(d, f)
            if f.endswith(".py"):
                out |= _env_names_python(path)
            elif f.endswith((".cc", ".h")):
                out |= _env_names_native(path)
    return out


def render(spec=None, assets=ASSETS, monkeypatch=None):
    c = FakeClient(auto_ready=True)
    c.add_node("gpu-node", {
        "feature.node.kubernetes.io/pci-10de.present": "true",
        "nvidia.com/gpu.product": "NVIDIA-H100-80GB-HBM3"})
    cr = c.create(Obj({"apiVersion": "nvidia.com/v1alpha1",
                       "kind": "GPUClusterPolicy",
                       "metadata": {"name": "gpu-cluster-policy"},
                       "spec": spec or {}}))
    sm = StateManager(c, NS, assets)
    sm.init(GPUClusterPolicy.from_obj(cr.raw), cr)
    sm.run_all()
    return [o for kind in ("DaemonSet", "Deployment")
            for o in c.list(kind, NS)]


def _containers(obj):
    spec = obj.get("spec", "template", "spec")
    return list(spec.get("initContainers") or []) + \
        list(spec.get("containers") or [])


def _commands(c):
    """Every command the container execs: its own, its probes' and its
    lifecycle hooks'."""
    out = []

    def walk(x):
        if isinstance(x, dict):
            if isinstance(x.get("command"), list) and x["command"]:
                out.append(x["command"])
            for v in x.values():
                walk(v)
        elif isinstance(x, list):
            for v in x:
                walk(v)
    walk(c)
    return out


def _role(cmd):
    """(command, component or subcommand) of a command line."""
    if cmd[0] == "gpu-validator":
        return cmd[0], cmd[cmd.index("--component") + 1]
    sub = cmd[1] if len(cmd) > 1 and not cmd[1].startswith("-") else None
    return cmd[0], sub


def problems(objs, read=None) -> list[str]:
    """Every breach of the contract in the rendered objects."""
    read = names_read_by_the_port() if read is None else read
    out = []
    for obj in objs:
        for c in _containers(obj):
            where = f"{obj.name}/{c['name']}"
            cmds = _commands(c)
            if any(cmd[0] in PENDING for cmd in cmds):
                continue
            for cmd in cmds:
                out += [f"{where}: {p}" for p in _resolve(cmd)]
            env = c.get("env", [])
            values = " ".join(str(e.get("value", "")) for e in env)
            for e in env:
                name = e["name"]
                expanded = "valueFrom" in e and f"$({name})" in values
                if name not in read and not expanded:
                    out.append(f"{where}: sets {name}, which no port code "
                               f"reads")
            main = c.get("command") or []
            need = REQUIRED.get(_role(main), set()) if main else set()
            missing = need - {e["name"] for e in env}
            out += [f"{where}: does not set {n}" for n in sorted(missing)]
    return out


def _resolve(cmd) -> list[str]:
    if cmd[0].startswith("/"):
        return []                       # the OS's (/bin/sh)
    if cmd[0] not in ENTRY_POINTS:
        return [f"{cmd[0]} is no entry point of the port"]
    kind, target = ENTRY_POINTS[cmd[0]]
    if kind == "python":
        mod = importlib.import_module(target)
        if not callable(getattr(mod, "main", None)):
            return [f"{target} has no main"]
        if cmd[0] == "gpu-validator":
            comp = _role(cmd)[1]
            if comp not in VALID_COMPONENTS + ("metrics", "all"):
                return [f"gpu-validator has no component {comp}"]
            if "--gates" in cmd:
                gates = cmd[cmd.index("--gates") + 1].split(",")
                bad = [g for g in gates if g not in VALID_COMPONENTS]
                if bad:
                    return [f"gpu-validator has no component {bad}"]
        return []
    main_cc = os.path.join(PKG, "native", target, "main.cc")
    if not os.path.exists(main_cc):
        return [f"no native target {target}"]
    sub = _role(cmd)[1]
    if sub is not None and f'"{sub}"' not in open(main_cc).read():
        return [f"{cmd[0]} has no subcommand {sub}"]
    return []


@pytest.fixture
def env_images(monkeypatch):
    for env in ("DRIVER_IMAGE", "CONTAINER_TOOLKIT_IMAGE",
                "DEVICE_PLUGIN_IMAGE", "FEATURE_DISCOVERY_IMAGE",
                "SLICE_MANAGER_IMAGE", "METRICS_AGENT_IMAGE",
                "METRICS_EXPORTER_IMAGE", "VALIDATOR_IMAGE"):
        monkeypatch.setenv(env, "reg/operand:v1")


@pytest.mark.parametrize("policy", ["default", "full"])
def test_every_rendered_container_keeps_the_contract(policy, env_images):
    objs = render({} if policy == "default" else FULL)
    assert len(objs) == (9 if policy == "default" else 10)
    assert problems(objs) == []


def test_every_entry_point_is_deployed(env_images):
    """Each entry point of the table is the command of some rendered
    container: the table holds nothing the pipeline does not run."""
    used = {cmd[0] for o in render(FULL) for c in _containers(o)
            for cmd in _commands(c)}
    assert set(ENTRY_POINTS) <= used


def test_the_scan_sees_the_readers():
    read = names_read_by_the_port()
    # Python (os.environ, env.get, *_ENV constants) and C++ (getenv, the
    # worker identity filter, the hook's baked list)
    for name in ("REQUIRE_GPU_PLATFORM", "GPU_DEVICE_GLOB", "NODE_NAME",
                 "SLICE_AWARE", "DRIVER_REQUIRED_VERSION", "MASTER_PORT",
                 "MULTINODE_ENABLED", "GPU_METRICS_AGENT_PORT",
                 "GFD_INTERVAL_SECONDS", "MESH_PORT"):
        assert name in read, name
    for name in ("REQUIRE_TPU_PLATFORM", "LIBTPU_INSTALL_DIR",
                 "TPU_RESOURCE_NAME", "CDI_ENABLED"):
        assert name not in read, name


def test_a_planted_misspelling_fails(tmp_path, env_images):
    """``REQUIRE_TPU_PLATFORM`` left in the validator's asset is a variable
    no operand reads, and the workload container then lacks the one it
    needs."""
    assets = tmp_path / "assets"
    shutil.copytree(ASSETS, assets)
    ds = assets / "state-operator-validation" / "0500_daemonset.yaml"
    ds.write_text(ds.read_text().replace("REQUIRE_GPU_PLATFORM",
                                         "REQUIRE_TPU_PLATFORM"))
    found = problems(render(assets=str(assets)))
    assert any("sets REQUIRE_TPU_PLATFORM" in p for p in found), found
    assert any("workload-validation: does not set REQUIRE_GPU_PLATFORM"
               in p for p in found), found


def test_a_command_with_no_entry_point_fails(tmp_path, env_images):
    assets = tmp_path / "assets"
    shutil.copytree(ASSETS, assets)
    ds = assets / "state-slice-manager" / "0500_daemonset.yaml"
    ds.write_text(ds.read_text().replace('["gpu-slice-manager"]',
                                         '["tpu-slice-manager"]'))
    found = problems(render(assets=str(assets)))
    assert any("tpu-slice-manager is no entry point" in p for p in found)


def test_the_relay_is_opt_in_and_pending(env_images):
    assert not any(o.name.startswith("gpu-relay") for o in render())
    relay = [o for o in render({"relay": {"enabled": True}})
             if o.name.startswith("gpu-relay")]
    assert relay and all(
        cmd[0] in PENDING for o in relay for c in _containers(o)
        for cmd in _commands(c))
