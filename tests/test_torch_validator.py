"""The port's validator components and CLI, through the reference's own
scenarios (``tests/test_validator.py``) with the TPU names mapped to the GPU
ones: libtpu → driver, runtime-hook → container-toolkit, ICI → NVLink,
``tpu.dev/chip`` → ``nvidia.com/gpu``, ``TPU_*`` environment → the port's.
The cluster is the port's own ``FakeClient``; the fabric runs over CPU
devices passed in, the workload on an explicit CPU."""

import json
import os
import socket
import subprocess
import sys
import textwrap
import threading
import time

import pytest
import torch

from tpu_operator.validator import components as ref_components
from tpu_operator_torch.cli.validator import main as validator_main
from tpu_operator_torch.kube import FakeClient, Obj
from tpu_operator_torch.kube.client import KubeError
from tpu_operator_torch.validator import components as port_components
from tpu_operator_torch.validator.components import (
    ContainerToolkitComponent, DriverComponent, FabricComponent,
    GateComponent, PluginComponent, ValidationFailed, WorkloadComponent,
    build_component)
from tpu_operator_torch.validator.metrics import NodeMetrics
from torch_fake_libcuda import libcuda_copies  # noqa: F401 (a fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPUS = ["cpu"] * 8
FABRIC_ENV = ("WORKER_HOSTNAMES", "WORKER_ID", "EXPECTED_TOPOLOGY",
              "MULTINODE_ENABLED", "MESH_PORT", "REQUIRE_GPU_PLATFORM")


@pytest.fixture
def vdir(tmp_path):
    return str(tmp_path / "validations")


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for name in FABRIC_ENV:
        monkeypatch.delenv(name, raising=False)


def _driver_tree(libs, tmp_path, loadable=True):
    """A driver root with a ``libcuda.so.1`` (when ``loadable``, a hard link
    to the test run's one plain libc copy, ``libs``: the ``libcuda_copies``
    fixture; else not an ELF file) and one device node."""
    libdir = tmp_path / "root/usr/lib64"
    libdir.mkdir(parents=True)
    if loadable:
        libs.link(libdir / "libcuda.so.1")
    else:
        (libdir / "libcuda.so.1").write_text("not an elf")
    (tmp_path / "nvidia0").touch()
    return {"driver_root": str(tmp_path / "root"),
            "device_glob": str(tmp_path / "nvidia[0-9]*")}


# -- driver -------------------------------------------------------------------

def test_driver_missing_library(vdir, tmp_path):
    comp = DriverComponent(driver_root=str(tmp_path / "none"),
                           device_glob=str(tmp_path / "nvidia*"),
                           validations_dir=vdir)
    with pytest.raises(ValidationFailed, match="libcuda.so.1 not found"):
        comp.run()
    assert not os.path.exists(comp.status_path())


def test_driver_happy_path_with_real_shared_object(vdir, tmp_path,
                                                   libcuda_copies):
    comp = DriverComponent(validations_dir=vdir,
                           **_driver_tree(libcuda_copies, tmp_path))
    info = comp.run()
    assert info["devices"] == [str(tmp_path / "nvidia0")]
    assert info["library"].endswith("usr/lib64/libcuda.so.1")
    st = json.load(open(comp.status_path()))
    assert st["ok"] and st["component"] == "driver"


def test_driver_unloadable_library(vdir, tmp_path, libcuda_copies):
    comp = DriverComponent(validations_dir=vdir,
                           **_driver_tree(libcuda_copies, tmp_path,
                                          loadable=False))
    with pytest.raises(ValidationFailed, match="dlopen failed"):
        comp.run()


def test_driver_without_device_nodes(vdir, tmp_path, libcuda_copies):
    tree = _driver_tree(libcuda_copies, tmp_path)
    os.unlink(tmp_path / "nvidia0")
    with pytest.raises(ValidationFailed, match="no GPU device nodes"):
        DriverComponent(validations_dir=vdir, **tree).run()


def test_device_glob_custom_no_fallback(vdir, tmp_path):
    comp = DriverComponent(driver_root=str(tmp_path),
                           device_glob=str(tmp_path / "nvidia*"),
                           validations_dir=vdir)
    assert comp.find_devices() == []


def test_driver_defaults(monkeypatch):
    monkeypatch.delenv("NVIDIA_DRIVER_ROOT", raising=False)
    monkeypatch.delenv("GPU_DEVICE_GLOB", raising=False)
    comp = DriverComponent()
    assert comp.driver_root == "/"
    assert comp.device_glob == "/dev/nvidia[0-9]*"


# -- container toolkit --------------------------------------------------------

def test_container_toolkit_cdi_spec(vdir, tmp_path):
    cdi = tmp_path / "cdi"
    cdi.mkdir()
    comp = ContainerToolkitComponent(
        cdi_spec_dir=str(cdi),
        containerd_config=str(tmp_path / "containerd/config.toml"),
        validations_dir=vdir)
    with pytest.raises(ValidationFailed):
        comp.run()
    (cdi / "tpu.json").write_text("{}")       # the reference's name: no
    with pytest.raises(ValidationFailed):
        comp.run()
    (cdi / "nvidia.yaml").write_text("")
    assert comp.run()["cdi_specs"] == [str(cdi / "nvidia.yaml")]


def test_container_toolkit_containerd_drop_in(vdir, tmp_path):
    conf = tmp_path / "containerd"
    (conf / "conf.d").mkdir(parents=True)
    (conf / "conf.d" / "nvidia-container-runtime.toml").write_text("")
    comp = ContainerToolkitComponent(
        cdi_spec_dir=str(tmp_path / "cdi"),
        containerd_config=str(conf / "config.toml"), validations_dir=vdir)
    info = comp.run()
    assert info["containerd_drop_in"].endswith(
        "conf.d/nvidia-container-runtime.toml")
    assert info["cdi_specs"] == []


# -- gate ---------------------------------------------------------------------

def test_gate_blocks_until_files_exist(vdir):
    gate = GateComponent(gates=["driver", "container-toolkit"],
                         validations_dir=vdir, wait=False)
    with pytest.raises(ValidationFailed, match="waiting for"):
        gate.run()
    os.makedirs(vdir, exist_ok=True)
    open(os.path.join(vdir, "driver-ready"), "w").write("{}")
    open(os.path.join(vdir, "container-toolkit-ready"), "w").write("{}")
    assert gate.run()["gates"] == ["driver", "container-toolkit"]
    assert not os.path.exists(os.path.join(vdir, "gate-ready"))


def test_gate_empty_list_is_configuration_error(vdir):
    with pytest.raises(ValueError, match="non-empty"):
        GateComponent(gates=[], validations_dir=vdir)


def test_wait_is_effectively_unbounded(vdir):
    comp = GateComponent(gates=["x"], validations_dir=vdir, wait=True)
    assert comp.max_tries >= 10 ** 6


# -- fabric (NVLink ring over CPU devices; hosts with injected sockets) -------

def test_fabric_ring_round_trip(vdir):
    comp = FabricComponent(validations_dir=vdir, devices=CPUS)
    info = comp.run()
    assert info["nvlink"] == "ring round-trip ok over 8 devices"
    assert info["local_devices"] == 8 and info["platform"] == "cpu"
    assert info["dcn"].startswith("skipped")
    assert os.path.exists(os.path.join(vdir, "fabric-ready"))


def test_fabric_single_device_is_skipped_not_passed(vdir):
    info = FabricComponent(validations_dir=vdir, devices=["cpu"]).validate()
    assert info["nvlink"] == "skipped (single device)"
    assert info["local_devices"] == 1


def test_fabric_ring_detects_a_corrupted_hop(vdir, monkeypatch):
    """A link that delivers a wrong value breaks the round trip."""
    real, calls = torch.Tensor.to, []

    def faulty(self, *args, **kw):
        out = real(self, *args, **kw)
        calls.append(1)
        return out + 1 if len(calls) == 12 else out
    monkeypatch.setattr(torch.Tensor, "to", faulty)
    with pytest.raises(ValidationFailed, match="ring round-trip corrupted"):
        FabricComponent(validations_dir=vdir, devices=CPUS[:4]).validate()


def test_fabric_defaults_to_every_card(vdir, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    comp = FabricComponent(validations_dir=vdir)
    assert comp.devices is None and comp.mesh_port == 29500
    with pytest.raises(ValidationFailed, match="no CUDA device"):
        comp.validate()


def test_fabric_checks_peer_access_between_cards(vdir, monkeypatch):
    """Every ordered pair of cards is asked for peer access; one refused
    pair fails the fabric before any data moves."""
    asked = []

    def peer(a, b):
        asked.append((a, b))
        return (a, b) != (1, 0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "can_device_access_peer", peer)
    comp = FabricComponent(validations_dir=vdir,
                           devices=[torch.device("cuda", i)
                                    for i in range(3)])
    with pytest.raises(ValidationFailed, match="no peer access between "
                                               "cards 1->0"):
        comp.validate()
    assert sorted(asked) == [(a, b) for a in range(3) for b in range(3)
                             if a != b]


def test_fabric_topology_consistency(vdir):
    comp = FabricComponent(validations_dir=vdir, expected_topology="2x4",
                           devices=CPUS)
    assert comp.validate()["slice_chips"] == 8
    comp = FabricComponent(validations_dir=vdir, expected_topology="4x4",
                           devices=CPUS)
    with pytest.raises(ValidationFailed, match="implies 16 local"):
        comp.validate()
    comp = FabricComponent(validations_dir=vdir, expected_topology="bogus",
                           devices=CPUS)
    with pytest.raises(ValidationFailed, match="malformed EXPECTED_TOPOLOGY"):
        comp.validate()


def test_fabric_dcn_peer_reachability(vdir, monkeypatch):
    monkeypatch.setenv("WORKER_HOSTNAMES", "host-0,host-1,host-2,host-3")
    monkeypatch.setenv("WORKER_ID", "1")
    monkeypatch.setenv("EXPECTED_TOPOLOGY", "4x8")  # 32 cards / 4 = 8 local
    seen = []
    comp = FabricComponent(
        validations_dir=vdir, devices=CPUS,
        resolver=lambda h, p: [(None, None, None, None, (h, p))],
        connector=lambda h, p: seen.append((h, p)))
    info = comp.validate()
    assert info["workers"] == 4 and len(seen) == 4
    assert all(p == FabricComponent.DEFAULT_MESH_PORT for _, p in seen)


def test_fabric_dcn_unreachable_peer(vdir, monkeypatch):
    monkeypatch.setenv("WORKER_HOSTNAMES", "host-0,host-1")

    def refuse(host, port):
        raise OSError("connection refused")
    comp = FabricComponent(validations_dir=vdir, devices=CPUS,
                           resolver=lambda h, p: [], connector=refuse)
    with pytest.raises(ValidationFailed, match="DCN peers unreachable"):
        comp.validate()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_fabric_dcn_real_sockets_self_barrier(vdir, monkeypatch):
    port = _free_port()
    monkeypatch.setenv("WORKER_HOSTNAMES", "127.0.0.1,127.0.0.1")
    monkeypatch.setenv("WORKER_ID", "0")
    comp = FabricComponent(validations_dir=vdir, mesh_port=port,
                           devices=CPUS)
    comp.linger_s = 0
    info = comp.validate()
    assert info["workers"] == 2 and info["mesh_port"] == port


def test_fabric_worker_id_out_of_range(vdir, monkeypatch):
    monkeypatch.setenv("WORKER_HOSTNAMES", "host-0,host-1")
    monkeypatch.setenv("WORKER_ID", "7")
    comp = FabricComponent(validations_dir=vdir, devices=CPUS,
                           resolver=lambda h, p: [],
                           connector=lambda h, p: None)
    with pytest.raises(ValidationFailed, match="out of range"):
        comp.validate()


def _bare_fabric(port):
    comp = FabricComponent.__new__(FabricComponent)
    comp.mesh_port = port
    comp._listener = None
    comp.linger_s = 0
    comp._connector = None
    return comp


def test_fabric_dcn_listener_persists_across_retries():
    comp = _bare_fabric(_free_port())

    def resolver(host, port):
        if host == "peer-not-started":
            raise OSError("no such host yet")
    comp._resolver = resolver
    with pytest.raises(ValidationFailed):
        comp.check_dcn(["127.0.0.1", "peer-not-started"])
    try:
        assert comp._listener is not None
        with socket.create_connection(("127.0.0.1", comp.mesh_port),
                                      timeout=2):
            pass
        info = comp.check_dcn(["127.0.0.1"])
        assert info["workers"] == 1
        assert comp._listener is None
    finally:
        comp._close_listener()


def test_fabric_dcn_listener_released_when_giving_up(tmp_path):
    comp = _bare_fabric(_free_port())
    comp._resolver = lambda host, port: (_ for _ in ()).throw(
        OSError("unreachable"))
    comp.max_tries = 2
    comp.retry_interval = 0.01
    comp.dir = str(tmp_path)
    comp.validate = lambda: comp.check_dcn(["peer-a", "peer-b"])
    with pytest.raises(ValidationFailed):
        comp.run()
    assert comp._listener is None
    with socket.socket() as s:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind(("", comp.mesh_port))


def test_fabric_asserts_multinode_worker_identity(vdir, monkeypatch):
    monkeypatch.setenv("MULTINODE_ENABLED", "true")
    comp = FabricComponent(validations_dir=vdir, wait=False, devices=CPUS)
    with pytest.raises(ValidationFailed, match="worker identity"):
        comp.run()
    monkeypatch.setenv("WORKER_ID", "0")
    monkeypatch.setenv("WORKER_HOSTNAMES", "localhost")
    comp = FabricComponent(validations_dir=vdir, wait=False, devices=CPUS)
    assert comp.run()["multislice"] == "worker identity injected"


def test_fabric_dcn_barrier_two_processes(tmp_path):
    """Two real processes with the multi-node environment run the barrier
    against each other over loopback."""
    port = _free_port()
    script = textwrap.dedent("""
        import json, sys
        from tpu_operator_torch.validator.components import FabricComponent
        comp = FabricComponent(validations_dir=sys.argv[1], wait=True)
        comp.max_tries = 40
        comp.retry_interval = 0.25
        comp.linger_s = 1.0
        info = comp.check_multislice_env()
        info.update(comp.check_dcn(comp.peers()))
        comp.abort()
        print(json.dumps(info))
    """)
    env = {**os.environ, "PYTHONPATH": ROOT, "MULTINODE_ENABLED": "true",
           "WORKER_HOSTNAMES": "127.0.0.1,127.0.0.1",
           "MESH_PORT": str(port), "DCN_BARRIER_LINGER_S": "1.0"}
    procs = [subprocess.Popen(
        [sys.executable, "-c", script, str(tmp_path / f"v{wid}")],
        env={**env, "WORKER_ID": wid}, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for wid in ("0", "1")]
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-800:]
        info = json.loads(out.strip().splitlines()[-1])
        assert info["workers"] == 2 and info["mesh_port"] == port
        assert info["multislice"] == "worker identity injected"


def test_require_gpu_refuses_cpu_fabric_and_workload(vdir, monkeypatch):
    comp = WorkloadComponent(device="cpu", matmul_dim=256,
                             validations_dir=vdir, require_gpu=True)
    with pytest.raises(ValidationFailed, match="marked GPU-present"):
        comp.run()
    assert not os.path.exists(comp.status_path())
    comp = FabricComponent(validations_dir=vdir, require_gpu=True,
                           devices=CPUS)
    with pytest.raises(ValidationFailed, match="marked GPU-present"):
        comp.run()
    monkeypatch.setenv("REQUIRE_GPU_PLATFORM", "true")
    assert WorkloadComponent(validations_dir=vdir).require_gpu is True
    assert FabricComponent(validations_dir=vdir).require_gpu is True
    monkeypatch.delenv("REQUIRE_GPU_PLATFORM")
    assert FabricComponent(validations_dir=vdir).require_gpu is False


# -- plugin (fake cluster) ----------------------------------------------------

def mk_gpu_node(client, name="n1", cards="4"):
    client.add_node(name, {"nvidia.com/gpu.present": "true"})
    node = client.get("Node", name)
    node.raw["status"]["capacity"] = {"nvidia.com/gpu": cards}
    client.update_status(node)


def _pods_end_in(client, phase, message=None):
    """A fake kubelet: each pod created moves straight to ``phase``."""
    orig_create, orig_get = client.create, client.get

    def create(obj):
        out = orig_create(obj)
        if obj.kind == "Pod":
            pod = orig_get("Pod", obj.name, obj.namespace)
            pod.raw["status"] = {"phase": phase, "message": message}
            client.update_status(pod)
        return out
    client.create = create


def test_plugin_waits_for_resource_then_runs_pod(vdir):
    c = FakeClient()
    mk_gpu_node(c)
    comp = PluginComponent(client=c, node_name="n1", namespace="gpu-operator",
                           image="reg/validator:v1", validations_dir=vdir,
                           retry_interval=0.01, max_tries=3)
    created = []
    orig_create = c.create
    c.create = lambda obj: created.append(obj.raw) or orig_create(obj)
    _pods_end_in(c, "Succeeded")
    info = comp.run()
    assert info == {"resource": "nvidia.com/gpu",
                    "pod": "gpu-plugin-validator-n1"}
    pod = created[0]
    container = pod["spec"]["containers"][0]
    assert container["command"] == ["gpu-validator", "--component",
                                    "workload", "--no-status-file"]
    assert container["resources"]["limits"] == {"nvidia.com/gpu": "1"}
    assert pod["spec"]["tolerations"] == [{"key": "nvidia.com/gpu",
                                           "operator": "Exists"}]
    assert c.get_or_none("Pod", comp.pod_name, "gpu-operator") is None
    assert os.path.exists(comp.status_path())


def test_plugin_pod_matches_the_reference_but_for_the_names():
    port = PluginComponent(node_name="n1", namespace="ns", image="i")
    ref = ref_components.PluginComponent(node_name="n1", namespace="ns",
                                         image="i")
    got, want = port.child_pod(), ref.child_pod()
    assert got["metadata"]["name"] == "gpu-plugin-validator-n1"
    for pod in (got, want):
        pod["metadata"].pop("name")
        pod["metadata"].pop("labels")
        pod["spec"].pop("tolerations")
        c = pod["spec"]["containers"][0]
        c["command"].pop(0)
        c["resources"] = list(c["resources"]["limits"].values())
    assert got == want


def test_plugin_fails_when_resource_never_appears(vdir):
    c = FakeClient()
    c.add_node("n1", {"nvidia.com/gpu.present": "true"})
    comp = PluginComponent(client=c, node_name="n1", validations_dir=vdir,
                           retry_interval=0.01, resource_wait_tries=2)
    with pytest.raises(ValidationFailed, match="never appeared"):
        comp.run()


def test_plugin_reports_failed_pod(vdir):
    c = FakeClient()
    mk_gpu_node(c)
    _pods_end_in(c, "Failed", "OOM")
    comp = PluginComponent(client=c, node_name="n1", image="i",
                           validations_dir=vdir, retry_interval=0.01)
    with pytest.raises(ValidationFailed, match="workload pod failed: OOM"):
        comp.run()


def test_plugin_survives_transient_api_errors(vdir):
    c = FakeClient()
    mk_gpu_node(c)
    _pods_end_in(c, "Succeeded")
    calls = {"n": 0}
    orig_get = c.get

    def flaky_get(kind, name, ns=None):
        calls["n"] += 1
        if calls["n"] == 1:
            raise KubeError("apiserver blip")
        return orig_get(kind, name, ns)
    c.get = flaky_get
    comp = PluginComponent(client=c, node_name="n1", image="i",
                           validations_dir=vdir, retry_interval=0.01,
                           max_tries=5)
    assert comp.run()["resource"] == "nvidia.com/gpu"


def test_plugin_stale_pod_becomes_validation_failed(vdir):
    c = FakeClient()
    mk_gpu_node(c)
    c.delete = lambda *a, **k: None
    c.create(Obj({"apiVersion": "v1", "kind": "Pod",
                  "metadata": {"name": "gpu-plugin-validator-n1",
                               "namespace": "gpu-operator"}, "spec": {}}))
    comp = PluginComponent(client=c, node_name="n1", image="i",
                           validations_dir=vdir, retry_interval=0.01,
                           resource_wait_tries=2)
    with pytest.raises(ValidationFailed, match="still terminating"):
        comp.run()


def test_plugin_outside_a_cluster_fails_validation(vdir, monkeypatch,
                                                   tmp_path):
    from tpu_operator_torch.kube import incluster
    monkeypatch.setattr(incluster, "SA_DIR", str(tmp_path / "no-sa"))
    comp = PluginComponent(node_name="n1", validations_dir=vdir)
    with pytest.raises(ValidationFailed, match="no API server: no "
                                               "service-account token"):
        comp.run()


def test_plugin_resource_name_from_the_environment(monkeypatch):
    monkeypatch.setenv("GPU_RESOURCE_NAME", "nvidia.com/mig-1g.10gb")
    assert PluginComponent().resource_name == "nvidia.com/mig-1g.10gb"


# -- component table ----------------------------------------------------------

def test_components_mirror_the_reference_table():
    assert port_components.VALID_COMPONENTS == (
        "driver", "container-toolkit", "fabric", "workload", "plugin", "gate")
    ref = {"libtpu": "driver", "runtime-hook": "container-toolkit"}
    assert tuple(ref.get(n, n) for n in ref_components.VALID_COMPONENTS) \
        == port_components.VALID_COMPONENTS
    for name in port_components.VALID_COMPONENTS:
        kw = {"gates": ["x"]} if name == "gate" else {}
        assert build_component(name, **kw).name == name
    with pytest.raises(ValueError, match="unknown component"):
        build_component("libtpu")


# -- CLI ----------------------------------------------------------------------

def test_cli_unknown_component_rejected(capsys):
    with pytest.raises(SystemExit):
        validator_main(["--component", "libtpu"])


def test_cli_gate_and_exit_codes(vdir, capsys):
    rc = validator_main(["--component", "gate", "--gates", "driver",
                         "--validations-dir", vdir])
    assert rc == 1
    out = json.loads(capsys.readouterr().out)
    assert out == {"component": "gate", "ok": False,
                   "error": "gate: waiting for: driver"}
    os.makedirs(vdir, exist_ok=True)
    open(os.path.join(vdir, "driver-ready"), "w").write("{}")
    rc = validator_main(["--component", "gate", "--gates", "driver",
                         "--validations-dir", vdir])
    assert rc == 0
    assert json.loads(capsys.readouterr().out)["info"] == {
        "gates": ["driver"]}


def test_cli_gate_requires_gates(vdir):
    with pytest.raises(SystemExit):
        validator_main(["--component", "gate", "--validations-dir", vdir])


def test_cli_workload_no_status_file(vdir, capsys):
    rc = validator_main(["--component", "workload", "--no-status-file",
                         "--device", "cpu", "--validations-dir", vdir])
    assert rc == 0
    line = json.loads(capsys.readouterr().out)
    assert line["ok"] is True and line["info"]["platform"] == "cpu"
    assert not os.path.exists(os.path.join(vdir, "workload-ready"))


def test_cli_defaults_to_the_card(vdir, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("workload", "fabric"):
        assert validator_main(["--component", name,
                               "--validations-dir", vdir]) == 1
        out = json.loads(capsys.readouterr().out)
        assert out["ok"] is False and "no CUDA device" in out["error"]


def test_cli_all_on_the_cpu_against_fixture_trees(vdir, tmp_path, capsys,
                                                  monkeypatch,
                                                  libcuda_copies):
    """``--component all`` runs every component but the gate, in order,
    against a fixture driver tree and CDI directory and a fake cluster
    standing in for the in-cluster client; then the gate passes on their
    status files."""
    tree = _driver_tree(libcuda_copies, tmp_path)
    monkeypatch.setenv("NVIDIA_DRIVER_ROOT", tree["driver_root"])
    monkeypatch.setenv("GPU_DEVICE_GLOB", tree["device_glob"])
    (tmp_path / "cdi").mkdir()
    (tmp_path / "cdi" / "nvidia.yaml").write_text("")
    monkeypatch.setenv("CDI_SPEC_DIR", str(tmp_path / "cdi"))
    monkeypatch.setenv("NODE_NAME", "n1")
    c = FakeClient()
    mk_gpu_node(c)
    _pods_end_in(c, "Succeeded")
    from tpu_operator_torch.kube import incluster
    monkeypatch.setattr(incluster, "InClusterClient", lambda: c)
    rc = validator_main(["--component", "all", "--device", "cpu",
                         "--validations-dir", vdir])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert rc == 0, lines
    assert [x["component"] for x in lines] == [
        "driver", "container-toolkit", "fabric", "workload", "plugin"]
    assert all(x["ok"] for x in lines)
    assert lines[2]["info"]["nvlink"] == "skipped (single device)"
    assert validator_main(["--component", "gate", "--gates",
                           ",".join(x["component"] for x in lines),
                           "--validations-dir", vdir]) == 0


# -- node metrics -------------------------------------------------------------

def test_node_metrics_serves_and_scans(vdir, tmp_path, monkeypatch):
    monkeypatch.setenv("NVIDIA_DRIVER_ROOT", str(tmp_path / "none"))
    os.makedirs(vdir)
    with open(os.path.join(vdir, "workload-ready"), "w") as f:
        json.dump({"ok": True, "info": {"matmul_tflops": 623.4,
                                        "efficiency": 0.63}}, f)
    open(os.path.join(vdir, "driver-ready"), "w").write("{}")
    nm = NodeMetrics(vdir, port=0)
    stop = threading.Event()
    t = threading.Thread(target=nm.run,
                         kwargs={"stop": stop, "scan_period": 0.05,
                                 "revalidate_period": 0.05}, daemon=True)
    t.start()
    for _ in range(100):
        time.sleep(0.05)
        if nm.revalidation.get() == 0 and nm.ready["driver"].get() == 0:
            break
    text = nm.registry.render()
    stop.set()
    t.join(timeout=5)
    assert not t.is_alive()
    assert "gpu_operator_node_workload_ready 1" in text
    assert "gpu_operator_node_container_toolkit_ready 0" in text
    assert "gpu_operator_node_workload_matmul_tflops 623.4" in text
    assert "gpu_operator_node_driver_validation 0" in text
    assert "gpu_operator_node_driver_ready 0" in text
    assert not os.path.exists(os.path.join(vdir, "driver-ready"))


def test_metrics_reset_after_status_file_removed(vdir):
    os.makedirs(vdir)
    with open(os.path.join(vdir, "workload-ready"), "w") as f:
        json.dump({"ok": True, "info": {"matmul_tflops": 99.0,
                                        "efficiency": 0.5}}, f)
    nm = NodeMetrics(vdir, port=0)
    nm.scan_status_files()
    assert nm.workload_tflops.get() == 99.0
    os.unlink(os.path.join(vdir, "workload-ready"))
    nm.scan_status_files()
    assert nm.workload_tflops.get() == 0
    assert nm.workload_efficiency.get() == 0


def test_node_metrics_read_the_ports_workload_status(tmp_path):
    """The gauges take the port's own status file: the workload run on the
    CPU, whose rates carry four significant digits."""
    wl = WorkloadComponent(device="cpu", matmul_dim=256,
                           validations_dir=str(tmp_path))
    info = wl.run()
    nm = NodeMetrics(validations_dir=str(tmp_path))
    nm.scan_status_files()
    assert nm.workload_tflops.get() == info["matmul_tflops"] > 0
    assert nm.workload_hbm_gbps.get() == info["hbm_read_gbps"] > 0
    assert nm.workload_efficiency.get() == 0     # no gate off the card
    rendered = dict(line.split() for line in nm.registry.render()
                    .splitlines() if not line.startswith("#"))
    assert float(rendered["gpu_operator_node_workload_hbm_read_gbps"]) == \
        info["hbm_read_gbps"]
    (tmp_path / "workload-ready").unlink()
    nm.scan_status_files()
    assert "gpu_operator_node_workload_hbm_read_gbps 0" in \
        nm.registry.render()


def test_metric_families_are_the_references_renamed(tmp_path):
    from tpu_operator.validator.metrics import NodeMetrics as RefMetrics

    def families(nm):
        return sorted(line.split()[2] for line in
                      nm.registry.render().splitlines()
                      if line.startswith("# TYPE"))
    ref = [f.replace("tpu_operator_node_", "gpu_operator_node_")
           .replace("libtpu", "driver").replace("runtime_hook",
                                                "container_toolkit")
           .replace("tpu_devices", "gpu_devices")
           for f in families(RefMetrics(str(tmp_path)))]
    assert families(NodeMetrics(str(tmp_path))) == sorted(ref)
