"""The operator's state pipeline (``controllers/{resource_manager,
object_controls,state_manager,sharding}.py`` and ``tpu_operator_torch/
assets/``) against the reference.

Both ``StateManager``s run over the same fake cluster — the reference's with
GKE TPU node labels and a ``TPUClusterPolicy``, the port's with NFD's
``pci-10de.present`` and feature discovery's ``nvidia.com/gpu.product`` and
the same policy through the name map — and every object each leaves in its
cluster must be equal after ``torch_names.port_render``: the default policy,
policies that switch each component off, the multi-node block, a driver
``versionMap`` of two products, PSA, and the transforms' knobs.

Then the scenarios of ``tests/test_controllers.py:62-513`` that need no
``Reconciler`` (the state pipeline drives the transforms directly here; the
reconciler is the next slice's) and ``tests/test_dag_cache.py:73-198``
(the DAG, its linearization, gate order, the DAG walk byte-identical to the
serial walk) on the port.
"""

import json
import os
import re
import threading
import time

import pytest

import tpu_operator.kube as ref_kube
import tpu_operator_torch.kube as port_kube
from tpu_operator.api.v1alpha1 import TPUClusterPolicy
from tpu_operator.controllers import object_controls as ref_oc
from tpu_operator.controllers import state_manager as ref_smod
from tpu_operator_torch.api.v1alpha1 import GPUClusterPolicy, State
from tpu_operator_torch.controllers import resource_manager as port_rm
from tpu_operator_torch.controllers.object_controls import (
    GATE_STATES, HASH_ANNOTATION, STATE_DAEMONSETS, WAIT_GATES, _canonical,
    spec_hash)
from tpu_operator_torch.controllers.state_manager import (
    STATES, ServerInfo, StateManager, build_state_dag, get_runtime,
    is_gpu_node)
from tpu_operator_torch.kube import FakeClient, Obj
from tpu_operator_torch.kube.objects import containers, find_container, get_env
from torch_names import DEAD_ENV, port_render, to_port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(ROOT, "tpu_operator_torch", "assets")
REF_ASSETS = os.path.join(ROOT, "assets")
NS = "gpu-operator"
REF_NS = "tpu-operator"

H100 = "NVIDIA-H100-80GB-HBM3"
A100 = "NVIDIA-A100-SXM4-80GB"
GPU_LABELS = {"feature.node.kubernetes.io/pci-10de.present": "true",
              "nvidia.com/gpu.product": H100}
V5P, V5E = "tpu-v5p-slice", "tpu-v5-lite-podslice"
#: the reference's node facts → the port's (products for accelerator
#: types, in fan-out names lower-cased), run before the name map
NODE_MAP = ((r'-tpu-v5p-slice"', '-nvidia-h100-80gb-hbm3"'),
            (r'-tpu-v5-lite-podslice"', '-nvidia-a100-sxm4-80gb"'),
            (V5P, H100), (V5E, A100), (r'"2x2x1"', '"true"'),
            (r'"2x4"', '"true"'))
REF_NODES = {"n1": {"cloud.google.com/gke-tpu-accelerator": V5P,
                    "cloud.google.com/gke-tpu-topology": "2x2x1"},
             "n2": {"cloud.google.com/gke-tpu-accelerator": V5E,
                    "cloud.google.com/gke-tpu-topology": "2x4"},
             "cpu": {}}
IMAGE_ENVS = ("LIBTPU_INSTALLER_IMAGE", "RUNTIME_HOOK_IMAGE",
              "DRIVER_IMAGE", "CONTAINER_TOOLKIT_IMAGE",
              "DEVICE_PLUGIN_IMAGE", "FEATURE_DISCOVERY_IMAGE",
              "SLICE_MANAGER_IMAGE", "METRICS_AGENT_IMAGE",
              "METRICS_EXPORTER_IMAGE", "VALIDATOR_IMAGE")


@pytest.fixture
def env_images(monkeypatch):
    for env in IMAGE_ENVS:
        monkeypatch.setenv(env, "reg/operand:v1")


def _side(side):
    if side == "r":
        return (ref_kube, TPUClusterPolicy, ref_smod.StateManager,
                ref_oc._canonical, REF_NS, "TPUClusterPolicy")
    return (port_kube, GPUClusterPolicy, StateManager, _canonical, NS,
            "GPUClusterPolicy")


def render(side, spec, nodes=REF_NODES, ns_labels=None, passes=1,
           max_workers=None):
    """Run one side's state pipeline over a fresh fake cluster; returns
    (statuses, {(kind, namespace, name): canonical object}, client)."""
    kube, Policy, SM, canon, ns, kind = _side(side)
    c = kube.FakeClient(auto_ready=True)
    for name, labels in nodes.items():
        c.add_node(name, labels if side == "r"
                   else to_port(labels, NODE_MAP))
    if ns_labels is not None:
        c.create(kube.Obj({"apiVersion": "v1", "kind": "Namespace",
                           "metadata": {"name": ns, "labels": ns_labels}}))
    cr = c.create(kube.Obj({
        "apiVersion": "x/v1alpha1", "kind": kind,
        "metadata": {"name": "p", "creationTimestamp":
                     "2026-01-01T00:00:00Z"},
        "spec": spec if side == "r" else to_port(spec, NODE_MAP)}))
    sm = SM(c, ns, REF_ASSETS if side == "r" else ASSETS)
    for _ in range(passes):
        sm.init(Policy.from_obj(cr.raw), cr)
        statuses = sm.run_all(max_workers=max_workers)
    with c._lock:
        objs = [canon(raw) for raw in c._store.values()]
    return statuses, {(o["kind"], o["metadata"].get("namespace"),
                       o["metadata"]["name"]): o for o in objs}, c


POLICIES = {
    "default": {},
    "multislice": {"multislice": {"enabled": True, "coordinatorPort": 9999}},
    "version-map": {"libtpu": {"versionMap": {V5P: "0.10.1",
                                              V5E: "0.9.9"},
                               "installDir": "/opt/lib",
                               "requiredVersion": "2.9.0"}},
    "psa": {"psa": {"enabled": True, "enforce": "baseline",
                    "version": "v1.29"}},
    "knobs": {"sliceManager": {"configMap": "my", "defaultProfile": "x"},
              "validator": {"fabricMeshPort": 9471, "pluginEnabled": False,
                            "workloadMatmulDim": 2048,
                            "peakTflops": 900.0},
              "metricsExporter": {"port": 9500, "serviceMonitor": {
                  "enabled": True, "interval": "10s"}},
              "metricsAgent": {"port": 9501},
              "featureDiscovery": {"nfdFeatureDir": "/etc/nfd"},
              "healthMonitor": {"hbmSweep": {"enable": True, "sizeMb": 16},
                                "counterThresholds": {"x": 1}},
              "devicePlugin": {"env": [{"name": "EXTRA", "value": "1"}],
                               "resourceName": "example.com/gpu"},
              "daemonsets": {"labels": {"team": "ml"},
                             "priorityClassName": "p"}},
    "host-paths": {"runtimeHook": {
        "cdiSpecDir": "/var/run/cdi",
        "containerdConfig": "/etc/k3s/containerd/config.toml",
        "containerdSocket": "/run/k3s/containerd.sock"},
        "devicePlugin": {"pluginDir": "/var/lib/kubelet/dp"},
        "libtpu": {"installDir": "/opt/lib"}},
    "opt-in": {"nodeStatusExporter": {"enabled": True},
               "relay": {"enabled": True, "router": {"enabled": True},
                         "federation": {"enabled": True}}},
}
for _comp in ("libtpu", "runtimeHook", "validator", "devicePlugin",
              "metricsAgent", "metricsExporter", "featureDiscovery",
              "sliceManager", "healthMonitor"):
    POLICIES[f"{_comp}-off"] = {_comp: {"enabled": False}}


@pytest.mark.parametrize("name", sorted(POLICIES))
def test_rendered_cluster_equals_the_reference(name, env_images):
    """Every object both pipelines leave in the cluster, and every state's
    status, equal after the name map."""
    ns_labels = {} if name == "psa" else None
    r_st, r_objs, _ = render("r", POLICIES[name], ns_labels=ns_labels)
    p_st, p_objs, _ = render("p", POLICIES[name], ns_labels=ns_labels)
    assert p_st == to_port(r_st)
    want = {}
    for obj in r_objs.values():
        o = port_render(obj, NODE_MAP, POLICIES[name])
        want[(o["kind"], o["metadata"].get("namespace"),
              o["metadata"]["name"])] = o
    assert sorted(p_objs) == sorted(want)
    for key in want:
        assert p_objs[key] == want[key], key


def test_dead_env_is_read_by_no_reference_operand():
    """The variables ``port_render`` drops from the reference's render are
    set only by the reference's transforms: no other reference source names
    them, so dropping them changes what no operand sees."""
    sources = []
    for base in ("tpu_operator", "native"):
        for d, _, files in os.walk(os.path.join(ROOT, base)):
            for f in files:
                if f.endswith((".py", ".cc", ".h")) and \
                        f != "object_controls.py":
                    sources.append(open(os.path.join(d, f),
                                        errors="replace").read())
    text = "\n".join(sources)
    for name in DEAD_ENV:
        assert f'"{name}"' not in text, name
    ref_text = open(os.path.join(ROOT, "tpu_operator", "controllers",
                                 "object_controls.py")).read()
    for name in DEAD_ENV:
        assert f'"{name}"' in ref_text, name


def test_second_pass_writes_nothing(env_images):
    """test_controllers.py:186-196 on the pipeline: a converged pass makes
    no create, update, patch or delete (the hash annotation)."""
    _, _, c = render("p", {})
    sm = StateManager(c, NS, ASSETS)
    cr = c.list("GPUClusterPolicy")[0]
    sm.init(GPUClusterPolicy.from_obj(cr.raw), cr)
    sm.run_all()
    c.actions.clear()
    sm.init(GPUClusterPolicy.from_obj(cr.raw), cr)
    sm.run_all()
    assert [a for a in c.actions
            if a[0] in ("create", "update", "patch", "delete")] == []


def test_dag_walk_byte_identical_to_serial_walk(env_images):
    """test_dag_cache.py:171-186: the DAG walk and the serial walk leave
    identical clusters and statuses."""
    serial = render("p", {}, max_workers=1)
    dag = render("p", {})
    assert serial[0] == dag[0]
    assert json.dumps(sorted(serial[1].values(), key=str),
                      sort_keys=True) == \
        json.dumps(sorted(dag[1].values(), key=str), sort_keys=True)


# -- asset pipeline (test_controllers.py:62-85) -----------------------------

def test_assets_decode_for_every_state():
    for name, _, _ in STATES:
        assert port_rm.load_state_assets(os.path.join(ASSETS, name)), name


def test_assets_unknown_dir_raises():
    with pytest.raises(port_rm.AssetError):
        port_rm.load_state_assets(os.path.join(ASSETS, "state-nonexistent"))


def test_default_assets_dir_is_the_packages():
    assert os.path.realpath(port_rm.DEFAULT_ASSETS_DIR) == \
        os.path.realpath(ASSETS)


def test_all_daemonset_states_have_daemonset():
    for name, suffix, _ in STATES:
        if suffix is None:
            continue
        objs = port_rm.load_state_assets(os.path.join(ASSETS, name))
        ds = next(o for o in objs if o.kind == "DaemonSet")
        sel = ds.get("spec", "template", "spec", "nodeSelector")
        assert sel == {f"nvidia.com/gpu.deploy.{suffix}": "true"}, name


def test_assets_are_the_references_renamed():
    """Every asset file of the reference has its port, state for state."""
    renamed = {"state-libtpu": "state-driver",
               "state-runtime-hook": "state-container-toolkit"}
    for d in sorted(os.listdir(REF_ASSETS)):
        ref = sorted(os.listdir(os.path.join(REF_ASSETS, d)))
        port = sorted(os.listdir(os.path.join(ASSETS, renamed.get(d, d))))
        assert [re.sub(r"tpu", "nvidia", f) for f in ref] == port, d


# -- node discovery (test_controllers.py:88-155) ----------------------------

def test_is_gpu_node_detection():
    assert is_gpu_node(Obj({"kind": "Node", "metadata": {
        "labels": {"feature.node.kubernetes.io/pci-10de.present": "true"}}}))
    assert is_gpu_node(Obj({"kind": "Node", "metadata": {
        "labels": {"cloud.google.com/gke-accelerator": "nvidia-h100-80gb"}}}))
    assert is_gpu_node(Obj({"kind": "Node", "metadata": {
        "labels": {"nvidia.com/gpu.present": "true"}}}))
    assert is_gpu_node(Obj({"kind": "Node", "metadata": {},
                            "status": {"capacity": {"nvidia.com/gpu": "8"}}}))
    assert not is_gpu_node(Obj({"kind": "Node", "metadata": {}}))
    # the TPU labels do not make a GPU node
    assert not is_gpu_node(Obj({"kind": "Node", "metadata": {
        "labels": {"cloud.google.com/gke-tpu-accelerator": V5P}}}))
    # explicit opt-out wins
    assert not is_gpu_node(Obj({"kind": "Node", "metadata": {"labels": {
        **GPU_LABELS, "nvidia.com/gpu.present": "false"}}}))


@pytest.mark.parametrize("ver,want", [
    ("containerd://1.7.0", "containerd"), ("docker://24.0.0", "docker"),
    ("cri-o://1.29.1", "crio"), ("", ""), ("weird", "")])
def test_get_runtime(ver, want):
    n = Obj({"kind": "Node", "metadata": {},
             "status": {"nodeInfo": {"containerRuntimeVersion": ver}}})
    assert get_runtime(n) == want == ref_smod.get_runtime(
        ref_kube.Obj(n.raw))


@pytest.fixture
def cluster(env_images):
    c = FakeClient(auto_ready=True)
    c.add_node("gpu-node-1", dict(GPU_LABELS))
    c.add_node("gpu-node-2", dict(GPU_LABELS))
    c.add_node("cpu-node", {})
    return c


def mk_cr(client, spec=None, name="gpu-cluster-policy"):
    return client.create(Obj({
        "apiVersion": "nvidia.com/v1alpha1", "kind": "GPUClusterPolicy",
        "metadata": {"name": name,
                     "creationTimestamp": "2026-01-01T00:00:00Z"},
        "spec": spec or {}}))


def run_pipeline(c, spec=None):
    cr = mk_cr(c, spec)
    sm = StateManager(c, NS, ASSETS)
    sm.init(GPUClusterPolicy.from_obj(cr.raw), cr)
    return sm, sm.run_all()


def test_label_gpu_nodes(cluster):
    sm, _ = run_pipeline(cluster)
    assert sm.gpu_node_count == 2
    n = cluster.get("Node", "gpu-node-1")
    assert n.labels["nvidia.com/gpu.present"] == "true"
    assert n.labels["nvidia.com/gpu.deploy.driver"] == "true"
    assert n.labels["nvidia.com/gpu.deploy.device-plugin"] == "true"
    assert n.labels["nvidia.com/slice.config"] == "full"
    cpu = cluster.get("Node", "cpu-node")
    assert not any(k.startswith("nvidia.com/") for k in cpu.labels)


def test_label_respects_disabled_component_and_operands_off(cluster):
    sm, _ = run_pipeline(cluster, {"sliceManager": {"enabled": False}})
    n = cluster.get("Node", "gpu-node-1")
    assert "nvidia.com/gpu.deploy.slice-manager" not in n.labels
    assert "nvidia.com/slice.config" not in n.labels
    n.labels["nvidia.com/gpu.deploy.operands"] = "false"
    cluster.update(n)
    sm.label_gpu_nodes()
    assert "nvidia.com/gpu.deploy.driver" not in \
        cluster.get("Node", "gpu-node-1").labels


# -- the pipeline end to end (test_controllers.py:160-236) ------------------

def test_pipeline_ready_and_owned(cluster):
    _, statuses = run_pipeline(cluster)
    assert all(st in (State.READY, State.DISABLED)
               for st in statuses.values()), statuses
    assert statuses["state-node-status-exporter"] == State.DISABLED
    assert statuses["state-relay-service"] == State.DISABLED
    for name in ("gpu-driver-installer", "gpu-container-toolkit",
                 "gpu-operator-validator", "gpu-device-plugin",
                 "gpu-metrics-agent", "gpu-metrics-exporter",
                 "gpu-feature-discovery", "gpu-slice-manager",
                 "gpu-health-monitor"):
        ds = cluster.get("DaemonSet", name, NS)
        assert ds.annotations[HASH_ANNOTATION]
        assert ds.metadata["ownerReferences"][0]["kind"] == \
            "GPUClusterPolicy"


def test_pipeline_not_ready_until_rollout(env_images):
    c = FakeClient(auto_ready=False)
    c.add_node("gpu-node-1", dict(GPU_LABELS))
    sm, statuses = run_pipeline(c)
    assert statuses["state-driver"] == State.NOT_READY
    c.mark_daemonsets_ready()
    cr = c.list("GPUClusterPolicy")[0]
    sm.init(GPUClusterPolicy.from_obj(cr.raw), cr)
    assert all(st in (State.READY, State.DISABLED)
               for st in sm.run_all().values())


def test_no_gpu_nodes_no_daemonsets(env_images):
    c = FakeClient(auto_ready=True)
    c.add_node("cpu-node", {})
    sm, _ = run_pipeline(c)
    assert sm.gpu_node_count == 0
    assert c.list("DaemonSet", NS) == []


def test_disabled_component_deletes_operand(cluster):
    run_pipeline(cluster)
    assert cluster.get_or_none("DaemonSet", "gpu-slice-manager", NS)
    cr = cluster.get("GPUClusterPolicy", "gpu-cluster-policy")
    cr.raw["spec"]["sliceManager"] = {"enabled": False}
    cluster.update(cr)
    sm = StateManager(cluster, NS, ASSETS)
    cr = cluster.get("GPUClusterPolicy", "gpu-cluster-policy")
    sm.init(GPUClusterPolicy.from_obj(cr.raw), cr)
    assert sm.run_all()["state-slice-manager"] == State.DISABLED
    assert cluster.get_or_none("DaemonSet", "gpu-slice-manager", NS) is None


# -- transforms (test_controllers.py:239-437) -------------------------------

def pipeline_and_get(cluster, spec, ds_name):
    run_pipeline(cluster, spec)
    return cluster.get("DaemonSet", ds_name, NS)


def test_transform_common_env_tolerations_priority(cluster):
    ds = pipeline_and_get(cluster, {
        "devicePlugin": {"env": [{"name": "EXTRA", "value": "1"}]},
        "daemonsets": {"priorityClassName": "my-prio",
                       "labels": {"team": "ml"}}}, "gpu-device-plugin")
    c = find_container(ds, "gpu-device-plugin")
    assert get_env(c, "EXTRA") == "1"
    assert ds.get("spec", "template", "spec", "priorityClassName") == \
        "my-prio"
    assert ds.labels["team"] == "ml"
    assert {"key": "nvidia.com/gpu", "operator": "Exists",
            "effect": "NoSchedule"} in ds.get("spec", "template", "spec",
                                              "tolerations")


def test_transform_health_monitor_projects_full_hbm_sweep(cluster):
    ds = pipeline_and_get(cluster, {"healthMonitor": {"hbmSweep": {
        "enable": True, "sizeMb": 16, "minGbps": 100}}},
        "gpu-health-monitor")
    c = find_container(ds, "gpu-health-monitor")
    assert json.loads(get_env(c, "HEALTH_HBM_SWEEP_JSON")) == \
        {"enable": True, "sizeMb": 16, "minGbps": 100}
    assert get_env(c, "GPU_HEALTH_FILE") == "/run/nvidia/gpu-health"


def test_remediation_critical_operands_tolerate_quarantine_taint(cluster):
    run_pipeline(cluster)
    for name in ("gpu-operator-validator", "gpu-health-monitor"):
        tols = cluster.get("DaemonSet", name, NS).get(
            "spec", "template", "spec", "tolerations")
        assert {"key": "nvidia.com/unhealthy", "operator": "Exists",
                "effect": "NoSchedule"} in tols, name


def test_transform_device_plugin_resource_name(cluster):
    ds = pipeline_and_get(cluster, {
        "devicePlugin": {"resourceName": "example.com/gpu"}},
        "gpu-device-plugin")
    c = find_container(ds, "gpu-device-plugin")
    assert get_env(c, "GPU_RESOURCE_NAME") == "example.com/gpu"
    assert get_env(c, "SLICE_AWARE") == "true"
    gate = find_container(ds, "validation-gate", init=True)
    assert gate["command"] == ["gpu-validator", "--component", "gate",
                               "--gates", "driver,container-toolkit",
                               "--wait"]


def test_transform_driver_install_dir(cluster):
    """F8: every configurable host directory is mounted at its host path,
    so the installer writes where the host keeps the library, the
    toolkit's CDI spec and drop-in land on the host, and the validator's
    checks read them there."""
    ds = pipeline_and_get(cluster, {
        "driver": {"installDir": "/opt/nvidia",
                   "requiredVersion": "580.159.03"},
        "containerToolkit": {"cdiSpecDir": "/var/run/cdi",
                             "containerdConfig": "/etc/k3s/config.toml"}},
        "gpu-driver-installer")
    c = find_container(ds, "driver-installer")
    mounts = {m["name"]: m["mountPath"] for m in c["volumeMounts"]}
    assert get_env(c, "DRIVER_INSTALL_DIR") == "/opt/nvidia" == \
        mounts["host-install-dir"]
    assert get_env(c, "DRIVER_REQUIRED_VERSION") == "580.159.03"
    vol = next(v for v in ds.get("spec", "template", "spec", "volumes")
               if v["name"] == "host-install-dir")
    assert vol["hostPath"]["path"] == "/opt/nvidia"
    tk = cluster.get("DaemonSet", "gpu-container-toolkit", NS)
    c = find_container(tk, "container-toolkit")
    mounts = {m["name"]: m["mountPath"] for m in c["volumeMounts"]}
    assert get_env(c, "DRIVER_INSTALL_DIR") == "/opt/nvidia"
    assert get_env(c, "CDI_SPEC_DIR") == "/var/run/cdi" == mounts["cdi-dir"]
    assert get_env(c, "CONTAINERD_CONFIG").startswith(
        mounts["containerd-config"] + "/")
    val = cluster.get("DaemonSet", "gpu-operator-validator", NS)
    for name in ("driver-validation", "fabric-validation",
                 "workload-validation"):
        c = find_container(val, name, init=True)
        assert get_env(c, "DRIVER_INSTALL_DIR") == "/opt/nvidia", name
        assert "/opt/nvidia" in [m["mountPath"] for m in c["volumeMounts"]]
    c = find_container(val, "container-toolkit-validation", init=True)
    assert get_env(c, "CDI_SPEC_DIR") == "/var/run/cdi"
    assert "/var/run/cdi" in [m["mountPath"] for m in c["volumeMounts"]]


def test_reference_passes_host_paths_its_containers_mount_elsewhere(
        env_images):
    """F8 on the reference: its installer and toolkit get host paths
    (LIBTPU_INSTALL_DIR, CDI_SPEC_DIR, CONTAINERD_CONFIG) while mounting
    those directories at /host-install-dir, /host-cdi and
    /host-etc/containerd, so what they write lands in their containers'
    own filesystems."""
    _, objs, _ = render("r", {"libtpu": {"installDir": "/opt/libtpu"}},
                        nodes={"n1": REF_NODES["n1"]})
    for ds_name, var in (("tpu-libtpu-installer", "LIBTPU_INSTALL_DIR"),
                         ("tpu-runtime-hook", "CDI_SPEC_DIR"),
                         ("tpu-runtime-hook", "CONTAINERD_CONFIG")):
        ds = objs[("DaemonSet", REF_NS, ds_name)]
        c = ds["spec"]["template"]["spec"]["containers"][0]
        path = next(e["value"] for e in c["env"] if e["name"] == var)
        mounts = [m["mountPath"] for m in c["volumeMounts"]]
        assert not any(path == m or path.startswith(m + "/")
                       for m in mounts), (ds_name, var, path)


def test_transform_container_toolkit_multinode(cluster):
    ds = pipeline_and_get(cluster, {
        "multinode": {"enabled": True, "coordinatorPort": 9999}},
        "gpu-container-toolkit")
    for c in containers(ds) + containers(ds, init=True):
        assert get_env(c, "MULTINODE_ENABLED") == "true"
        assert get_env(c, "MASTER_PORT") == "9999"
        for dead in ("RUNTIME", "CDI_ENABLED", "CONTAINERD_SOCKET"):
            assert get_env(c, dead) is None


def test_transform_validator_workload_shape(cluster):
    ds = pipeline_and_get(cluster, {"validator": {
        "workloadMatmulDim": 2048, "minEfficiency": 0.5}},
        "gpu-operator-validator")
    assert [c["name"] for c in containers(ds, init=True)] == [
        "driver-validation", "container-toolkit-validation",
        "fabric-validation", "workload-validation", "plugin-validation"]
    wl = find_container(ds, "workload-validation", init=True)
    assert wl["command"] == ["gpu-validator", "--component", "workload"]
    assert get_env(wl, "WORKLOAD_MATMUL_DIM") == "2048"
    assert get_env(wl, "MIN_EFFICIENCY") == "0.5"
    assert get_env(wl, "REQUIRE_GPU_PLATFORM") == "true"


def test_transform_validator_fabric(cluster):
    ds = pipeline_and_get(cluster, {"validator": {"fabricMeshPort": 9471}},
                          "gpu-operator-validator")
    assert get_env(find_container(ds, "fabric-validation", init=True),
                   "MESH_PORT") == "9471"
    cluster.delete("GPUClusterPolicy", "gpu-cluster-policy")
    ds = pipeline_and_get(cluster, {"validator": {"fabricEnabled": False}},
                          "gpu-operator-validator")
    assert "fabric-validation" not in [c["name"]
                                       for c in containers(ds, init=True)]


def test_transform_validator_plugin_disabled(cluster):
    ds = pipeline_and_get(cluster, {"validator": {"pluginEnabled": False}},
                          "gpu-operator-validator")
    assert "plugin-validation" not in [c["name"]
                                       for c in containers(ds, init=True)]


def test_transform_metrics_exporter_ports(cluster):
    ds = pipeline_and_get(cluster, {"metricsAgent": {"port": 9501},
                                    "metricsExporter": {"port": 9500}},
                          "gpu-metrics-exporter")
    c = find_container(ds, "gpu-metrics-exporter")
    assert get_env(c, "GPU_METRICS_AGENT_ADDR") == "$(NODE_IP):9501"
    assert c["ports"][0]["containerPort"] == 9500


def test_transform_slice_manager_custom_configmap(cluster):
    ds = pipeline_and_get(cluster, {"sliceManager": {
        "configMap": "my-slices", "defaultProfile": "per-gpu"}},
        "gpu-slice-manager")
    vol = next(v for v in ds.get("spec", "template", "spec", "volumes")
               if v["name"] == "slice-config")
    assert vol["configMap"]["name"] == "my-slices"
    assert cluster.get_or_none("ConfigMap", "default-slice-config",
                               NS) is None
    c = find_container(ds, "gpu-slice-manager")
    assert get_env(c, "DEFAULT_SLICE_PROFILE") == "per-gpu"
    assert get_env(c, "SLICE_CONFIG_FILE") == \
        "/etc/gpu-slice-manager/config.yaml"


def test_servicemonitor_gated_by_spec(cluster):
    run_pipeline(cluster, {"metricsExporter": {"serviceMonitor": {
        "enabled": False}}})
    assert cluster.get_or_none("ServiceMonitor", "gpu-metrics-exporter",
                               NS) is None


def test_spec_hash_stable_and_sensitive():
    o1 = Obj({"kind": "ConfigMap", "metadata": {"name": "x"},
              "data": {"a": "1"}})
    o2 = Obj({"kind": "ConfigMap",
              "metadata": {"name": "x", "resourceVersion": "99", "uid": "u"},
              "data": {"a": "1"}, "status": {"z": 1}})
    assert spec_hash(o1) == spec_hash(o2)
    assert spec_hash(o1) != spec_hash(Obj({
        "kind": "ConfigMap", "metadata": {"name": "x"}, "data": {"a": "2"}}))
    # the hash is the reference's function of the same canonical form
    assert spec_hash(o1) == ref_oc.spec_hash(ref_kube.Obj(o1.raw))


def test_exporter_service_and_monitor_follow_port(cluster):
    run_pipeline(cluster, {"metricsExporter": {
        "port": 9500, "serviceMonitor": {"enabled": True,
                                         "interval": "10s"}}})
    port = cluster.get("Service", "gpu-metrics-exporter", NS).get(
        "spec", "ports")[0]
    assert port["port"] == 9500 and port["targetPort"] == 9500
    sm = cluster.get("ServiceMonitor", "gpu-metrics-exporter", NS)
    assert sm.get("spec", "endpoints")[0]["interval"] == "10s"


def test_exporter_reaches_agent_via_node_ip(cluster):
    ds = pipeline_and_get(cluster, {}, "gpu-metrics-exporter")
    c = find_container(ds, "gpu-metrics-exporter")
    names = [e["name"] for e in c["env"]]
    assert names.index("NODE_IP") < names.index("GPU_METRICS_AGENT_ADDR")
    agent = cluster.get("DaemonSet", "gpu-metrics-agent", NS)
    assert agent.get("spec", "template", "spec", "hostNetwork") is True


# -- PSA and server facts (test_controllers.py:456-513, 516-600) ------------

def _ns(cluster, labels=None):
    cluster.create(Obj({"apiVersion": "v1", "kind": "Namespace",
                        "metadata": {"name": NS, "labels": labels or {}}}))


def test_psa_labels_applied_to_namespace(cluster):
    _ns(cluster)
    run_pipeline(cluster)
    labels = cluster.get("Namespace", NS).labels
    for mode in ("enforce", "audit", "warn"):
        assert labels[f"pod-security.kubernetes.io/{mode}"] == "privileged"
    assert labels["pod-security.kubernetes.io/enforce-version"] == "latest"


def test_psa_disabled_leaves_namespace_alone(cluster):
    _ns(cluster)
    run_pipeline(cluster, {"psa": {"enabled": False}})
    assert "pod-security.kubernetes.io/enforce" not in \
        cluster.get("Namespace", NS).labels


def test_psa_missing_namespace_is_tolerated(cluster):
    _, statuses = run_pipeline(cluster)
    assert statuses["state-driver"] == State.READY


def test_psa_spec_change_propagates_to_operator_owned_labels(cluster):
    _ns(cluster)
    sm, _ = run_pipeline(cluster)
    live = cluster.get("GPUClusterPolicy", "gpu-cluster-policy")
    live.raw["spec"]["psa"] = {"enabled": True, "enforce": "baseline"}
    cluster.update(live)
    live = cluster.get("GPUClusterPolicy", "gpu-cluster-policy")
    sm.init(GPUClusterPolicy.from_obj(live.raw), live)
    labels = cluster.get("Namespace", NS).labels
    assert labels["pod-security.kubernetes.io/enforce"] == "baseline"
    assert labels["pod-security.kubernetes.io/warn"] == "baseline"


def test_psa_does_not_clobber_admin_set_levels(cluster):
    _ns(cluster, {"pod-security.kubernetes.io/enforce": "baseline",
                  "pod-security.kubernetes.io/enforce-version": "v1.27"})
    run_pipeline(cluster)
    labels = cluster.get("Namespace", NS).labels
    assert labels["pod-security.kubernetes.io/enforce"] == "baseline"
    assert labels["pod-security.kubernetes.io/enforce-version"] == "v1.27"
    assert labels["pod-security.kubernetes.io/audit"] == "privileged"


def test_old_server_skips_psa_labels(cluster):
    cluster.version = {"major": "1", "minor": "21", "gitVersion": "v1.21.0"}
    _ns(cluster)
    run_pipeline(cluster)
    assert "pod-security.kubernetes.io/enforce" not in \
        cluster.get("Namespace", NS).labels


def test_server_info_parsing():
    class C:
        def server_version(self):
            return {"major": "1", "minor": "27+",
                    "gitVersion": "v1.27.3-gke.100"}
    info = ServerInfo.detect(C())
    assert (info.major, info.minor, info.flavor) == (1, 27, "gke")
    assert info.at_least(1, 27) and not info.at_least(1, 28)

    class NoServer:
        def server_version(self):
            return None
    info = ServerInfo.detect(NoServer())
    assert not info.known and info.at_least(1, 99)


# -- the per-product driver fan-out -----------------------------------------

def test_driver_fanout_per_product(env_images):
    c = FakeClient(auto_ready=True)
    c.add_node("h100", dict(GPU_LABELS))
    c.add_node("a100", {"feature.node.kubernetes.io/pci-10de.present":
                        "true", "nvidia.com/gpu.product": A100})
    run_pipeline(c, {"driver": {"versionMap": {H100: "580.159.03",
                                               A100: "575.51.03"}}})
    names = sorted(d.name for d in c.list("DaemonSet", NS)
                   if d.name.startswith("gpu-driver-installer"))
    assert names == ["gpu-driver-installer-nvidia-a100-sxm4-80gb",
                     "gpu-driver-installer-nvidia-h100-80gb-hbm3"]
    ds = c.get("DaemonSet", names[1], NS)
    assert ds.get("spec", "template", "spec", "nodeSelector")[
        "nvidia.com/gpu.product"] == H100
    assert get_env(find_container(ds, "driver-installer"),
                   "DRIVER_REQUIRED_VERSION") == "580.159.03"


# -- the DAG (test_dag_cache.py:73-165) -------------------------------------

def test_build_state_dag_matches_wait_gates():
    deps = build_state_dag()
    assert set(deps) == {name for name, _, _ in STATES}
    barrier = "state-operator-validation"
    assert deps["state-driver"] == {"pre-requisites"}
    assert deps["state-container-toolkit"] == {"pre-requisites",
                                               "state-driver"}
    assert deps[barrier] == {"pre-requisites", "state-driver",
                             "state-container-toolkit"}
    assert deps["state-device-plugin"] == {
        "pre-requisites", barrier, "state-driver", "state-container-toolkit"}
    assert deps["state-slice-manager"] == {
        "pre-requisites", barrier, "state-driver", "state-device-plugin"}
    assert deps["state-metrics-agent"] == {"pre-requisites", barrier,
                                           "state-driver"}
    assert deps["state-operator-metrics"] == {"pre-requisites"}
    assert deps["pre-requisites"] == set()
    for name, _, _ in STATES:
        ds = STATE_DAEMONSETS.get(name)
        for gate in WAIT_GATES.get(ds, ()) if ds else ():
            if GATE_STATES[gate] != name:
                assert GATE_STATES[gate] in deps[name], (name, gate)
    # the reference's DAG, through the names
    assert {to_port(k): sorted(to_port(sorted(v)))
            for k, v in ref_smod.build_state_dag().items()} == \
        {k: sorted(v) for k, v in deps.items()}


def test_states_order_is_a_linearization_of_the_dag():
    deps = build_state_dag()
    seen = set()
    for name, _, _ in STATES:
        assert deps[name] <= seen, (name, deps[name] - seen)
        seen.add(name)
    assert [to_port(s) for s in ref_smod.STATES] == \
        [list(s) for s in STATES]


def test_dag_gate_order_never_violated(monkeypatch, env_images):
    spans: dict = {}
    lock = threading.Lock()

    def timed_apply_one(self, name, comp):
        t0 = time.monotonic()
        time.sleep(0.03)
        t1 = time.monotonic()
        with lock:
            spans[name] = (t0, t1)
        return "ready", t1 - t0

    monkeypatch.setattr(StateManager, "_apply_one", timed_apply_one)
    c = FakeClient(auto_ready=True)
    c.add_node("gpu-node-1", dict(GPU_LABELS))
    sm, statuses = run_pipeline(c)
    assert set(spans) == set(statuses) == {name for name, _, _ in STATES}
    deps = build_state_dag()
    for name, (start, _) in spans.items():
        for dep in deps[name]:
            assert spans[dep][1] <= start, (name, dep)
    assert sm.last_concurrency > 1
    assert sm.last_dag_wall_s < len(STATES) * 0.03
